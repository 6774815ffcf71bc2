"""The scheduler's fault-tolerance layer in the port
(``deepspeed_tpu_torch/inference/scheduler.py`` and ``faults.py``) against
the JAX package's on the CPU, fp32, weights from JAX
``init_params(PRNGKey(0))`` through ``params_from_numpy``.

Each scenario runs the same script on a JAX engine and on the port's, and
holds the per-uid terminal states, errors, tokens and counters equal
(after ``tests/test_faults.py``):

- ``FaultInjector``: one seed and one call order fire the same faults;
  ``is_transient`` classifies as JAX's;
- typed submission outcomes, ``RETRY_LATER`` and ``retry_after_ms``;
  cancel from every state, leak-free, and the cancel deferred mid-tick;
- e2e and TTFT deadlines on a fake clock;
- isolation: a fatal injected runner exception fails only its victim (in
  prefill and in decode), transient ones retry invisibly, injected NaN
  logits quarantine the row, transient allocator exhaustion recovers;
- shed mode (queue depth; speculation off while shedding) and the watchdog;
- staged ``apply_knobs`` landing at the tick boundary, ``knobs``,
  ``signals``;
- the megastep's deadline clamp;
- a seeded storm (runner exceptions, NaN logits, allocator exhaustion, slow
  ticks, cancels and sub-ms deadlines) with the same terminal states and
  tokens as JAX's scheduler;
- a kernel or CUDA error inside a tick raises through ``tick()``: never a
  FAILED request, never a retry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import scheduler as JS
from deepspeed_tpu.inference.engine_v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.faults import FaultInjector as JInjector
from deepspeed_tpu.inference.faults import InjectedFault as JInjectedFault
from deepspeed_tpu.inference.faults import is_transient as j_is_transient
from deepspeed_tpu.inference.sampling import SamplingParams as JSampling
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.models.transformer import init_params as j_init
from deepspeed_tpu_torch.inference import scheduler as S
from deepspeed_tpu_torch.inference.engine_v2 import STAT_NAMES, InferenceEngineV2
from deepspeed_tpu_torch.inference.faults import (
    POINTS,
    FaultInjector,
    InjectedFault,
    is_transient,
)
from deepspeed_tpu_torch.inference.sampling import SamplingParams
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.models.transformer import params_from_numpy
from deepspeed_tpu_torch.ops.kernels import KernelError, surfaces
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_preset("tiny", dtype=jnp.float32, max_seq_len=128)
    tcfg = get_preset("tiny", dtype=torch.float32, max_seq_len=128)
    jp = j_init(jax.random.PRNGKey(0), cfg=jcfg, dtype=jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


PKG = {"jax": (JEngine, JSampling, JInjector, JS), "port": (InferenceEngineV2, SamplingParams,
                                                             FaultInjector, S)}


def _engine(tiny, pkg, **kw):
    jcfg, jp, tcfg, tp = tiny
    kw.setdefault("max_seqs", 4)
    kw.setdefault("num_blocks", 64)
    kw.setdefault("block_size", 8)
    kw.setdefault("prefill_buckets", (16, 32, 64))
    kw.setdefault("serve", dict(retry_backoff_ms=0.0))
    if pkg == "jax":
        return JEngine(jp, jcfg, **kw)
    return InferenceEngineV2(tp, tcfg, device="cpu", **kw)


def _both(tiny, script, **kw):
    """``script(eng, Sampling, Injector, sched_module)`` on a JAX engine
    and a port engine built alike; returns (jax result, port result)."""
    out = []
    for pkg in ("jax", "port"):
        Eng, Samp, Inj, mod = PKG[pkg]
        eng = _engine(tiny, pkg, **{k: (v(Inj) if callable(v) else v) for k, v in kw.items()})
        out.append(script(eng, Samp, Inj, mod))
    return out


def _leakfree(eng):
    alloc = eng.mgr.allocator
    alloc.audit()
    assert not eng.mgr.seqs, eng.mgr.seqs
    assert alloc.free_blocks + alloc.cached_blocks == alloc.total_blocks


def _terminal(sched, uids):
    return {u: (sched.requests[u].state, sched.requests[u].error, sched.result(u))
            for u in uids}


def _prompts(seed, n, length=10):
    rng = np.random.default_rng(seed)
    return {u: [int(t) for t in rng.integers(1, 255, length)] for u in range(1, n + 1)}


# ---------------------------------------------------------------------------
# the injector and the classifier
# ---------------------------------------------------------------------------
def _fire_log(Inj, Fault, seed):
    inj = (Inj(seed=seed).arm("runner_exception", p=0.3)
           .arm("runner_exception", uids=[9], after=5, times=2)
           .arm("nan_logits", p=0.5, times=7)
           .arm("alloc_exhaustion", p=0.2, transient=True)
           .arm("slow_tick", p=0.4, delay_s=0.01, times=3)
           .arm("worker_kill", uids=[1], after=4, times=1))
    out = []
    for i in range(60):
        try:
            inj.maybe_raise("runner_exception", uids=(i % 12, 9))
            out.append(0)
        except Fault as e:
            out.append((e.point, e.transient, e.ctx["uids"]))
        out.append(inj.select("nan_logits", [i, i + 1, i + 2]))
        out.append(inj.delay("slow_tick"))
        try:
            inj.maybe_raise("alloc_exhaustion", uids=(i,))
        except Fault as e:
            out.append(("alloc", e.transient))
        try:
            inj.maybe_raise("worker_kill", uids=(i % 3,))
        except Fault:
            out.append("kill")
    return out, inj.log, inj.injected_uids


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_injector_fires_what_jax_fires(seed):
    assert _fire_log(FaultInjector, InjectedFault, seed) == \
        _fire_log(JInjector, JInjectedFault, seed)


def test_injector_units():
    inj = FaultInjector().arm("nan_logits", times=2)
    hit = [inj.select("nan_logits", [1, 2]) for _ in range(4)]
    assert hit[0] == [1, 2] and hit[1] == [] and inj.fired("nan_logits") == 2
    inj = FaultInjector(enabled=False).arm("runner_exception")
    inj.maybe_raise("runner_exception", uids=(1,))
    assert inj.fired() == 0
    with pytest.raises(ValueError):
        FaultInjector().arm("not_a_point")
    with pytest.raises(ValueError):
        FaultInjector().arm("runner_exception", p=1.5)
    assert "conn_drop" in POINTS  # fires in serving/transport.py's ChaosLink


@pytest.mark.parametrize("exc", [
    InjectedFault("runner_exception", transient=True), InjectedFault("runner_exception"),
    RuntimeError("RESOURCE_EXHAUSTED: out of semaphores"),
    RuntimeError("device_put transfer stalled"), RuntimeError("cannot allocate 3 blocks"),
    ValueError("bad prompt"), RuntimeError("UNAVAILABLE: socket closed"),
])
def test_transient_classifier_equals_jax(exc):
    j = JInjectedFault(exc.point, exc.transient) if isinstance(exc, InjectedFault) else exc
    assert is_transient(exc) == j_is_transient(j)


def test_surfaces_marks_kernel_and_cuda_errors():
    assert surfaces(KernelError("CUDA kernel paged_decode failed to launch: cudaError 9"))
    assert surfaces(RuntimeError("CUDA error: an illegal memory access was encountered"))
    assert not surfaces(InjectedFault("runner_exception"))
    assert not surfaces(RuntimeError("UNAVAILABLE: transfer failed"))
    from deepspeed_tpu_torch.ops.kernels import paged_attention as PA

    with pytest.raises(ValueError) as e:  # raised inside a kernel wrapper
        PA.paged_attention_decode(torch.zeros(1, 2, 16, device="meta"), None, None, None,
                                  None)
    assert surfaces(e.value)


# ---------------------------------------------------------------------------
# typed submission outcomes, cancellation
# ---------------------------------------------------------------------------
def _submit_script(eng, Samp, Inj, mod):
    sched = eng.scheduler
    samp = Samp(max_new_tokens=4)
    out = [sched.try_submit(1, [], samp).reason,
           sched.try_submit(1, list(range(200)), samp).reason,
           sched.try_submit(1, list(range(1, 30)), Samp(max_new_tokens=64)).reason]
    r = sched.try_submit(1, list(range(1, 30)), Samp(max_new_tokens=64))
    out.append((r.budget_blocks, r.budget_scope))
    out.append(sched.try_submit(1, [1, 2, 3], samp).reason)
    out.append(sched.try_submit(1, [4, 5], samp).reason)
    out.append(sched.try_submit(2, [4, 5], Samp(temperature=0.7, max_new_tokens=4)).reason)
    with pytest.raises(ValueError):
        sched.submit(1, [4, 5], samp)
    sched._set_shed(True, "test")
    r = sched.try_submit(3, [1, 2], samp)
    out.append((r.reason, r.accepted, r.retry_after_ms))
    with pytest.raises(RuntimeError):
        sched.submit(3, [1, 2], samp)
    sched._set_shed(False, "test")
    out.append(sched.try_submit(3, [1, 2], samp).reason)
    out.append(eng.stats["shed_rejections"])
    out.append(sched.run())
    _leakfree(eng)
    return out


def test_typed_submit_rejections_equal_jax(tiny):
    j, t = _both(tiny, _submit_script, max_seqs=1, num_blocks=4)
    assert t == j
    assert t[:3] == [S.REJECT_EMPTY_PROMPT, S.REJECT_PROMPT_TOO_LONG, S.REJECT_POOL_IMPOSSIBLE]
    assert t[7][0] == S.RETRY_LATER and t[7][2] > 0


def _cancel_script(eng, Samp, Inj, mod):
    sched = eng.scheduler
    samp = Samp(max_new_tokens=12)
    rng = np.random.default_rng(0)
    sched.submit(1, [int(t) for t in rng.integers(1, 255, 6)], samp)
    sched.submit(2, [int(t) for t in rng.integers(1, 255, 40)], samp)  # 3 chunks
    sched.tick()
    seen = [sched.requests[2].state, sched.cancel(2), sched.requests[2].state]
    sched.tick()
    seen.append(sched.requests[1].state)
    sched._preempt(sched.requests[1])
    seen += [sched.requests[1].state, sched.requests[1].preemptions, sched.cancel(1)]
    sched.submit(3, [5, 6, 7], samp)
    seen += [sched.requests[3].state, sched.cancel(3), sched.cancel(3), sched.cancel(99)]
    sched.submit(4, [9, 8, 7], samp)
    sched.tick()
    sched.tick()
    # a cancel landing mid-tick on a running request defers to the next
    # tick boundary (the in-flight dispatch keeps its descriptor)
    sched._in_tick = True
    seen += [sched.requests[4].state, sched.cancel(4), sched.requests[4].state,
             sched.requests[4].cancel_requested]
    sched._in_tick = False
    sched.tick()
    seen += [sched.requests[4].state, eng.stats["cancelled"], sched.idle]
    _leakfree(eng)
    seen.append(sched.pop_result(4))
    return seen


def test_cancel_from_every_state_equals_jax(tiny):
    j, t = _both(tiny, _cancel_script, max_seqs=3, num_blocks=24,
                 enable_prefix_caching=True, prefill_chunk=16)
    assert t == j
    assert t[:3] == ["prefill", True, "cancelled"] and t[3] == t[11] == "decode"
    assert t[12:16] == [True, "decode", True, "cancelled"] and t[16] == 4 and t[17]


# ---------------------------------------------------------------------------
# deadlines on a fake clock
# ---------------------------------------------------------------------------
def _deadline_script(eng, Samp, Inj, mod):
    sched = eng.scheduler
    t = [0.0]
    sched._clock = lambda: t[0]
    samp = Samp(max_new_tokens=6)
    sched.submit(1, [1, 2, 3], samp)
    sched.submit(2, [4, 5, 6], samp, deadline_ms=60_000.0)
    sched.submit(3, [7, 8, 9], samp, deadline_ms=60_000.0, ttft_deadline_ms=2_000.0)
    sched.tick()
    t[0] = 10.0
    sched.tick()
    sched.submit(4, [2, 2, 2], samp, deadline_ms=60_000.0, ttft_deadline_ms=1_000.0)
    t[0] = 20.0
    sched.tick()
    sched.run(wait_for=[2, 3])
    out = _terminal(sched, [1, 2, 3, 4]), eng.stats["timed_out"]
    _leakfree(eng)
    return out


def test_deadlines_equal_jax(tiny):
    j, t = _both(tiny, _deadline_script, serve=dict(deadline_ms=5_000.0, retry_backoff_ms=0.0))
    assert t == j
    states, timed_out = t
    assert states[1][0] == "timed_out" and "e2e deadline" in states[1][1]
    assert states[4][0] == "timed_out" and "ttft deadline" in states[4][1]
    assert len(states[2][2]) == len(states[3][2]) == 6 and timed_out == 2


# ---------------------------------------------------------------------------
# per-request failure isolation
# ---------------------------------------------------------------------------
def _isolation_script(arm, after_prefill=False, **eng_kw):
    def script(eng, Samp, Inj, mod):
        sched = eng.scheduler
        samp = Samp(max_new_tokens=8)
        for u, p in _prompts(3, 3).items():
            sched.submit(u, p, samp)
        if after_prefill:
            sched.tick()
            arm(eng.faults)
        res = sched.run()
        out = (_terminal(sched, [1, 2, 3]), res, {k: eng.stats[k] for k in STAT_NAMES},
               eng.faults.fired(), sched.quarantined)
        _leakfree(eng)
        return out
    return script


@pytest.mark.parametrize("case", ["fatal_prefill", "fatal_decode", "transient", "nan",
                                  "alloc_transient"])
def test_isolation_equals_jax(tiny, case):
    if case == "fatal_prefill":
        j, t = _both(tiny, _isolation_script(None),
                     faults=lambda I: I(seed=0).arm("runner_exception", uids=[2]))
    elif case == "fatal_decode":
        j, t = _both(tiny, _isolation_script(lambda f: f.arm("runner_exception", uids=[2]),
                                             after_prefill=True),
                     faults=lambda I: I(seed=0))
    elif case == "transient":
        j, t = _both(tiny, _isolation_script(None), faults=lambda I: I(seed=0).arm(
            "runner_exception", transient=True, times=3))
    elif case == "nan":
        j, t = _both(tiny, _isolation_script(None),
                     faults=lambda I: I(seed=0).arm("nan_logits", uids=[2], times=1))
    else:
        j, t = _both(tiny, _isolation_script(None), enable_prefix_caching=True,
                     faults=lambda I: I(seed=0).arm("alloc_exhaustion", transient=True,
                                                    times=4))
    assert t == j
    states, res, stats, fired, quarantined = t
    if case in ("fatal_prefill", "fatal_decode", "nan"):
        assert states[2][0] == "failed" and stats["failed"] == 1 and quarantined == [2]
        assert states[1][0] == states[3][0] == "finished"
    else:
        assert stats["failed"] == 0 and stats["retries"] >= (3 if case == "transient" else 0)
        assert fired >= 3


# ---------------------------------------------------------------------------
# degradation: shed mode, the watchdog
# ---------------------------------------------------------------------------
def _shed_script(eng, Samp, Inj, mod):
    sched = eng.scheduler
    samp = Samp(max_new_tokens=6)
    for u, p in _prompts(7, 5, 6).items():
        sched.submit(u, p, samp)
    sched.tick()
    seen = [sched.shedding, sched._speculating]
    rej = sched.try_submit(50, [1, 2, 3], samp)
    seen.append(rej.reason)
    res = sched.run()
    seen += [res, sched.shedding, sched._speculating, eng.stats["shed_transitions"],
             eng.stats["shed_rejections"], sched.try_submit(50, [1, 2, 3], samp).reason]
    sched.run()
    seen.append(sorted({e["name"] for e in eng.telemetry.chrome_trace()["traceEvents"]
                        if e["name"] == "shed_mode"}))
    _leakfree(eng)
    return seen


def test_shed_mode_turns_speculation_off_like_jax(tiny):
    j, t = _both(tiny, _shed_script, max_seqs=2, num_blocks=24, telemetry=True,
                 enable_speculation=True, serve=dict(shed_queue_depth=1, retry_backoff_ms=0.0))
    assert t == j
    assert t[:3] == [True, False, S.RETRY_LATER]
    assert t[4:] == [False, True, 2, 1, S.QUEUED, ["shed_mode"]]


def test_retry_after_hint_grows_with_the_backlog(tiny):
    eng = _engine(tiny, "port", serve=dict(shed_queue_depth=2))
    sched = eng.scheduler
    samp = SamplingParams(temperature=0.0, max_new_tokens=4)
    for uid in range(1, 9):
        sched.try_submit(uid, [7] * 40, samp)
    sched.tick()
    assert sched.shedding
    res = sched.try_submit(99, [7] * 8, samp)
    assert res.reason == S.RETRY_LATER and res.retry_after_ms > 0
    shallow = sched.retry_after_ms()
    extra = list(sched.waiting)
    sched.waiting.extend(extra)
    assert sched.retry_after_ms() > shallow
    for _ in extra:
        sched.waiting.pop()
    eng.close()


def test_watchdog_trips_on_slow_ticks(tiny):
    inj = FaultInjector(seed=0).arm("slow_tick", delay_s=0.05, times=3)
    eng = _engine(tiny, "port", faults=inj, serve=dict(
        watchdog_tick_ms=1.0, watchdog_grace_ticks=2, retry_backoff_ms=0.0))
    sched = eng.scheduler
    sched.submit(1, [1, 2, 3], SamplingParams(max_new_tokens=6))
    res = sched.run()
    assert len(res[1]) == 6
    assert eng.stats["watchdog_trips"] >= 1 and eng.stats["shed_transitions"] >= 1
    _leakfree(eng)


# ---------------------------------------------------------------------------
# live knobs, signals
# ---------------------------------------------------------------------------
def _knobs_script(eng, Samp, Inj, mod):
    sched = eng.scheduler
    samp = Samp(max_new_tokens=5)
    for u, p in _prompts(2, 3, 30).items():
        sched.submit(u, p, samp)
    seen = [sched.knobs()]
    staged = sched.apply_knobs(prefill_chunk=8, kv_watermark=0.25, decode_megastep=3)
    seen += [staged, sched.knobs()["prefill_chunk"]]  # staged, not applied yet
    sched.apply_knobs(shed_queue_depth=9)  # merges
    for bad in (dict(prefill_chunk=0), dict(kv_watermark=1.0), dict(bogus=1),
                dict(spec_max_draft=0)):
        with pytest.raises(ValueError):
            sched.apply_knobs(**bad)
    sched.tick()
    k = sched.knobs()
    seen += [k, sched.knob_epoch, dict(sched.stats)["retunes"]]
    # a batch the engine refuses at apply time is dropped whole and recorded
    sched.apply_knobs(enable_speculation=True)
    sched.tick()
    sig = sched.signals()
    seen += [sched.last_knob_error, dict(sched.stats)["retune_rejects"],
             {k: v for k, v in sig.items() if k != "tick_ms_ema"}]
    seen.append(sched.run())
    _leakfree(eng)
    return seen


def test_apply_knobs_lands_at_the_tick_boundary_like_jax(tiny):
    j, t = _both(tiny, _knobs_script, enable_prefix_caching=True)
    assert t == j
    assert t[2] == 64 and t[3]["prefill_chunk"] == 8 and t[3]["decode_megastep"] == 3
    assert t[3]["shed_queue_depth"] == 9 and t[4] == 1 and t[5] == 1
    assert "enable_speculation" in t[6] and t[7] == 1


# ---------------------------------------------------------------------------
# the megastep's deadline clamp
# ---------------------------------------------------------------------------
def _clamp_script(eng, Samp, Inj, mod):
    sched = eng.scheduler
    t = [0.0]

    def clock():
        t[0] += 0.002  # every read advances 2 ms
        return t[0]

    sched._clock = clock
    samp = Samp(temperature=0.0, max_new_tokens=24)
    for u, p in _prompts(5, 2, 12).items():
        sched.submit(u, p, samp, deadline_ms=40.0)
    plans = []
    while not sched.idle:
        sched.tick()
        plans.append(sched._last_fused)
    out = (plans, _terminal(sched, [1, 2]), {k: eng.stats[k] for k in
                                             ("decode_bursts", "burst_ticks", "timed_out")})
    _leakfree(eng)
    return out


def test_megastep_deadline_clamp_equals_jax(tiny):
    j, t = _both(tiny, _clamp_script, serve=dict(decode_megastep=8, retry_backoff_ms=0.0))
    assert t == j
    plans = t[0]
    # without the deadline the bursts run at the ceiling (8, 8, then the 7
    # tokens left); with it they shrink as the deadline nears (headroom
    # over the per-tick EMA), and the requests time out at a boundary
    assert 1 < plans[1] < 8 and plans[1] > plans[2] > plans[3]
    assert all(s == "timed_out" for s, _, _ in t[1].values())


# ---------------------------------------------------------------------------
# the seeded storm
# ---------------------------------------------------------------------------
def _storm_injector(Inj):
    return (Inj(seed=0)
            .arm("runner_exception", p=0.04, transient=True)
            .arm("runner_exception", uids=[3, 17])
            .arm("nan_logits", uids=[5, 11], times=2)
            .arm("alloc_exhaustion", p=0.04, transient=True, times=10)
            .arm("slow_tick", p=0.05, delay_s=0.001, times=8))


def _storm_script(eng, Samp, Inj, mod):
    n_req, cancels = 20, [7]
    sched = eng.scheduler
    samp = Samp(temperature=0.0, max_new_tokens=8)
    rng = np.random.default_rng(0)
    shared = rng.integers(1, 255, 16).tolist()
    prompts = {u: shared + rng.integers(1, 255, 6).tolist() for u in range(1, n_req + 1)}
    sched.submit(1001, prompts[1], samp, deadline_ms=0.001)
    sched.submit(1002, prompts[2], samp, ttft_deadline_ms=0.001)
    arrivals = np.cumsum(rng.poisson(0.5, n_req))
    submitted, backlog, cancelled = 0, [], set()
    for _ in range(3000):
        while submitted < n_req and arrivals[submitted] <= sched.tick_no:
            uid = submitted + 1
            submitted += 1
            if sched.try_submit(uid, prompts[uid], samp).reason == mod.RETRY_LATER:
                backlog.append(uid)
        if backlog and not sched.shedding:
            if sched.try_submit(backlog[0], prompts[backlog[0]], samp).accepted:
                backlog.pop(0)
        for uid in cancels:
            if uid in sched.requests and uid not in cancelled \
                    and sched.requests[uid].state not in mod.TERMINAL:
                sched.cancel(uid)
                cancelled.add(uid)
        if submitted >= n_req and not backlog and all(
                r.state in mod.TERMINAL for r in sched.requests.values()):
            break
        sched.tick()
    uids = list(prompts) + [1001, 1002]
    out = (_terminal(sched, uids), {k: eng.stats[k] for k in (
        "failed", "nan_failures", "cancelled", "timed_out", "retries", "isolation_probes",
        "shed_transitions")}, eng.faults.log)
    _leakfree(eng)
    return out


def test_storm_equals_jax(tiny):
    j, t = _both(tiny, _storm_script, max_seqs=4, num_blocks=48, enable_prefix_caching=True,
                 enable_speculation=True, faults=_storm_injector,
                 serve=dict(deadline_ms=600_000.0, max_retries=4, retry_backoff_ms=0.0,
                            shed_queue_depth=4))
    assert t[0] == j[0]  # per-uid terminal states, errors and tokens
    assert t[1] == j[1]
    assert t[2] == j[2]  # the same faults fired in the same order
    states = {u: s for u, (s, _, _) in t[0].items()}
    assert all(states[u] == "failed" for u in (3, 17, 5, 11))
    assert states[7] == "cancelled" and states[1001] == states[1002] == "timed_out"
    assert all(states[u] == "finished" for u in range(1, 21) if u not in (3, 17, 5, 11, 7))
    assert t[1]["retries"] > 0


# ---------------------------------------------------------------------------
# kernel and CUDA errors surface
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("where,err", [
    ("decode", KernelError("CUDA kernel paged_decode failed to launch: cudaError 700")),
    ("prefill", KernelError("CUDA kernel flash_fwd failed to launch: cudaError 9")),
    ("decode", RuntimeError("CUDA error: an illegal memory access was encountered")),
    ("decode", RuntimeError("CUDA error: unavailable transfer (transient-looking)")),
])
def test_kernel_errors_raise_through_tick(tiny, monkeypatch, where, err):
    """A kernel or CUDA fault inside a tick propagates out of ``tick()``
    untouched: no retry (even when its text looks transient), no isolation
    probe, no FAILED request."""
    from deepspeed_tpu_torch.ops.kernels import flash_attention as FA
    from deepspeed_tpu_torch.ops.kernels import paged_attention as PA

    eng = _engine(tiny, "port", serve=dict(max_retries=3, retry_backoff_ms=0.0))
    sched = eng.scheduler
    samp = SamplingParams(temperature=0.0, max_new_tokens=6)
    for u, p in _prompts(1, 3).items():
        sched.submit(u, p, samp)
    if where == "decode":
        sched.tick()  # prefill fault-free

    def boom(*a, **k):
        raise err

    monkeypatch.setattr(PA if where == "decode" else FA,
                        "paged_attention_decode_plain" if where == "decode"
                        else "dot_product_attention", boom)
    with pytest.raises(type(err), match=str(err)[:20]):
        sched.tick()
    assert eng.stats["failed"] == eng.stats["retries"] == eng.stats["isolation_probes"] == 0
    assert all(r.state in (S.PREFILL, S.DECODE, S.WAITING) for r in sched.requests.values())
    assert not sched.quarantined
    monkeypatch.undo()
    eng.close()
