"""The port's online controller (``deepspeed_tpu_torch/autotuning/
controller.py``) against the JAX package's, on the CPU.

- ``AdaptationConfig`` / ``AutotuneConfig``: defaults and every check's text
  equal JAX's; ``serve.adaptation`` and the ``autotune`` section parse;
- the decision log: the same synthetic signal sequence (a stub scheduler's
  signals, the same histogram samples and counter increments into each
  package's telemetry) on a fake clock gives JAX's decisions, signal
  snapshots included — no wall clock anywhere (JAX's own wall-clock
  rollback test is unsteady);
- a rebuild is proposed through ``roofline_rebuild_scorer`` and never
  executed; ``take_rebuild_proposal`` pops once;
- on a tiny port engine: ``attach_controller`` reads ``serve.adaptation``,
  the megastep climbs when decode-bound, an injected bad retune rolls back
  and restores its knob, greedy tokens are unchanged; the epoch thread
  starts and stops idempotently;
- ``apply_knobs`` over the socket transport: staged at the next tick,
  typed refusals, ``RemoteWorker.apply_knobs`` raising ``ValueError``.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from deepspeed_tpu.autotuning import roofline as jroof
from deepspeed_tpu.autotuning.controller import OnlineController as JController
from deepspeed_tpu.autotuning.controller import roofline_rebuild_scorer as j_scorer
from deepspeed_tpu.config.config import AdaptationConfig as JAdaptationConfig
from deepspeed_tpu.config.config import AutotuneConfig as JAutotuneConfig
from deepspeed_tpu.config.config import ConfigError as JConfigError
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.telemetry import Telemetry as JTelemetry
from deepspeed_tpu_torch.autotuning import roofline
from deepspeed_tpu_torch.autotuning.controller import (OnlineController, attach_controller,
                                                       roofline_rebuild_scorer)
from deepspeed_tpu_torch.config.config import (AdaptationConfig, AutotuneConfig, ConfigError,
                                               RouterConfig, ServeConfig, parse_config)
from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.sampling import SamplingParams
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.models.transformer import init_params
from deepspeed_tpu_torch.serving.remote import RemoteWorker
from deepspeed_tpu_torch.serving.transport import HeartbeatMonitor, RpcClient, WorkerServer, dial
from deepspeed_tpu_torch.telemetry import Telemetry
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

H100 = dict(compute_flops=251.4e12, hbm_gbps=2850.0, ici_gbps=450.0, hbm_bytes=80e9,
            host_tick_s=15.2e-3, ici_hop_s=0.0)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(epoch_s=0.0), dict(min_window=0), dict(guard_epochs=0), dict(cooldown_epochs=0),
    dict(max_decode_megastep=0), dict(max_spec_draft=0), dict(regress_tolerance=0.9),
    dict(rebuild_hysteresis=0.5), dict(ttft_slo_ms=0.0), dict(tbt_slo_ms=-1.0),
])
def test_adaptation_config_checks_say_what_jax_says(kw):
    with pytest.raises(JConfigError) as jerr:
        JAdaptationConfig(**kw)
    with pytest.raises(ConfigError) as terr:
        AdaptationConfig(**kw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("kw", [
    dict(mode="inference"), dict(metric="cost"), dict(max_trials=0), dict(top_k=0),
    dict(eta=1), dict(rungs=[]), dict(rungs=[0.5, 0.25, 1.0]), dict(rungs=[0.25, 0.5]),
    dict(rungs=[0.0, 1.0]),
])
def test_autotune_config_checks_say_what_jax_says(kw):
    with pytest.raises(JConfigError) as jerr:
        JAutotuneConfig(**kw)
    with pytest.raises(ConfigError) as terr:
        AutotuneConfig(**kw)
    assert str(terr.value) == str(jerr.value)


def test_config_defaults_and_sections_equal_jax():
    for T, J in ((AdaptationConfig, JAdaptationConfig), (AutotuneConfig, JAutotuneConfig)):
        assert dataclasses.asdict(T()) == dataclasses.asdict(J())
    s = ServeConfig(adaptation={"enabled": True, "epoch_s": 0.05})
    assert isinstance(s.adaptation, AdaptationConfig) and s.adaptation.epoch_s == 0.05
    cfg = parse_config({"serve": {"adaptation": {"enabled": True, "min_window": 2}},
                        "autotune": {"enabled": True, "mode": "training", "rungs": [0.5, 1.0]}})
    assert cfg.serve.adaptation.min_window == 2 and cfg.autotune.rungs == [0.5, 1.0]
    with pytest.raises(ConfigError, match="unknown config key 'epochs'"):
        parse_config({"serve": {"adaptation": {"epochs": 1}}})


# ---------------------------------------------------------------------------
# the decision log on synthetic signals
# ---------------------------------------------------------------------------
class _StubSched:
    """A scheduler's controller surface over scripted signals: knobs apply
    at once, with the live tier's validation."""

    def __init__(self, knobs):
        self._knobs = dict(knobs)
        self.sig = {}
        self.applied = []

    def signals(self):
        return dict(self.sig, knob_epoch=len(self.applied))

    def knobs(self):
        return dict(self._knobs, knob_epoch=len(self.applied))

    def apply_knobs(self, **kw):
        for k, v in kw.items():
            if k in ("decode_megastep", "prefill_chunk", "spec_max_draft") and int(v) < 1:
                raise ValueError(f"{k} must be >= 1, got {v}")
            if k == "kv_watermark" and not 0.0 <= float(v) < 1.0:
                raise ValueError(f"kv_watermark must be in [0, 1), got {v}")
        self._knobs.update(kw)
        self.applied.append(dict(kw))
        return dict(kw)


KNOBS0 = dict(prefill_chunk=32, kv_watermark=0.0625, enable_speculation=True, spec_max_draft=4,
              decode_megastep=1, shed_queue_depth=4, watchdog_tick_ms=None,
              watchdog_grace_ticks=3, deadline_ms=None, ttft_deadline_ms=None)


def _script(n=64, seed=0):
    """Per epoch: (signals, ttft samples, tbt samples, counter increments)
    through regimes that fire every rule: low / high speculative acceptance,
    a decode-bound stretch, a prefill backlog, preemption churn, an idle
    pool with a queue, shedding without deadline misses, a regression."""
    rng = np.random.default_rng(seed)
    out = []
    for e in range(n):
        regime = e // 8
        sig = dict(tick_no=10 * e, preemptions=0, queue_depth=0, running=3, shedding=False,
                   headroom_fraction=0.4, prompt_tokens_total=100 * e,
                   cached_prompt_tokens=40 * e)
        inc = dict(decode_emitted=int(rng.integers(20, 40)))
        ttft = rng.uniform(20, 40, 3).tolist()
        tbt = rng.uniform(5, 9, 6).tolist()
        if regime == 0:  # speculation accepting badly
            inc.update(spec_drafted=40, spec_accepted=int(rng.integers(2, 6)), spec_emitted=10)
        elif regime == 1:  # then very well
            inc.update(spec_drafted=40, spec_accepted=int(rng.integers(37, 40)), spec_emitted=50)
        elif regime == 3:  # a prefill backlog
            sig.update(queue_depth=int(rng.integers(6, 9)), running=2)
        elif regime == 4:  # preemption churn
            sig.update(preemptions=e, queue_depth=1)
        elif regime == 5:  # an idle pool with a waiting queue
            sig.update(queue_depth=2, headroom_fraction=0.8)
        elif regime == 6:  # shedding, no deadline misses
            sig.update(shedding=True, queue_depth=1)
            inc.update(shed_rejections=3)
        elif regime == 7:  # a throughput collapse: guards roll back
            inc.update(decode_emitted=1)
            tbt = rng.uniform(40, 80, 6).tolist()
        out.append((sig, ttft, tbt, inc))
    return out


def _run(pkg, script, config, scorer=None, inject_at=None):
    Tel, Ctl = (Telemetry, OnlineController) if pkg == "port" else (JTelemetry, JController)
    tel = Tel(True)
    hists = tel.request_hists("serve")
    counters = tel.counters("serve", ("decode_emitted", "burst_emitted", "spec_emitted",
                                      "spec_drafted", "spec_accepted", "timed_out",
                                      "shed_rejections"))
    sched = _StubSched(KNOBS0)
    now = [0.0]
    ctl = Ctl(sched, config=config, telemetry=tel, serve_ns="serve", prefill_budget=128,
              clock=lambda: now[0], rebuild_scorer=scorer)
    proposals = []
    for e, (sig, ttft, tbt, inc) in enumerate(script):
        now[0] = 0.25 * (e + 1)
        sched.sig = sig
        for v in ttft:
            hists["ttft"].observe(v)
        for v in tbt:
            hists["tbt"].observe(v)
        for k, n in inc.items():
            counters[k].inc(n)
        if inject_at == e:
            ctl.inject_retune(_metric="tbt_ms_p90", _better="lower", prefill_chunk=8)
        ctl.step_epoch()
        prop = ctl.take_rebuild_proposal()
        if prop is not None:
            proposals.append(prop)
    return ctl.decisions, sched.applied, proposals


@pytest.mark.parametrize("seed", [0, 1])
def test_decision_log_equals_jax_on_a_fake_clock(seed):
    script = _script(seed=seed)
    kw = dict(enabled=True, epoch_s=0.25, min_window=2, guard_epochs=1, cooldown_epochs=1,
              regress_tolerance=1.1, max_decode_megastep=8, allow_rebuild=False)
    got = _run("port", script, AdaptationConfig(**kw), inject_at=20)
    want = _run("jax", script, JAdaptationConfig(**kw), inject_at=20)
    assert got[0] == want[0] and got[1] == want[1]
    actions = {d["action"] for d in got[0]}
    outcomes = {d["outcome"] for d in got[0]}
    assert {"spec_draft_down", "injected", "rollback"} <= actions, actions
    assert {"applied", "kept", "rolled_back"} <= outcomes, outcomes
    assert all("signals" in d and d["signals"]["knob_epoch"] is not None for d in got[0])


def test_rebuild_is_proposed_never_executed():
    """The roofline scorer finds a cheaper rebuild-tier candidate; the
    controller PARKS it (``take_rebuild_proposal``), never applies it —
    the same proposals as JAX's under the same constants."""
    script = [(dict(tick_no=e, preemptions=0, queue_depth=0, running=0, shedding=False,
                    headroom_fraction=0.5), [], [], {}) for e in range(6)]
    base = {"max_seqs": 4, "num_blocks": 64, "block_size": 8, "enable_prefix_caching": True}
    current = {"tp": 1, "serve_replicas": 1, "quant": None}
    kw = dict(enabled=True, min_window=1, guard_epochs=1, cooldown_epochs=1,
              rebuild_hysteresis=1.01)
    got = _run("port", script, AdaptationConfig(**kw), scorer=roofline_rebuild_scorer(
        get_preset("tiny"), base, current, 1, consts=roofline.RooflineConstants(**H100)))
    want = _run("jax", script, JAdaptationConfig(**kw), scorer=j_scorer(
        j_preset("tiny"), base, current, 1, consts=jroof.RooflineConstants(**H100)))
    assert got == want
    decisions, applied, proposals = got
    assert [d["action"] for d in decisions] == ["propose_rebuild"] * len(proposals)
    assert proposals and proposals[0]["predicted_ratio"] >= 1.01
    assert proposals[0]["candidate"]["quant"] in ("int8", "fp8", "fp6")
    assert applied == []  # nothing was applied: a rebuild is the owner's


# ---------------------------------------------------------------------------
# on a tiny port engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny():
    cfg = get_preset("tiny", max_seq_len=128, dtype=torch.float32)
    return cfg, init_params(cfg, seed=0, device="cpu")


def _engine(tiny, **kw):
    cfg, params = tiny
    kw.setdefault("max_seqs", 4)
    kw.setdefault("num_blocks", 64)
    kw.setdefault("block_size", 8)
    kw.setdefault("prefill_buckets", (16, 32, 64))
    kw.setdefault("prefill_budget", 64)
    kw.setdefault("prefill_chunk", 32)
    kw.setdefault("enable_prefix_caching", True)
    return InferenceEngineV2(params, cfg, device="cpu", telemetry=True, **kw)


def _drain(sched, prompts, samp, ctl=None, uid0=0):
    for u, p in prompts.items():
        assert sched.try_submit(uid0 + u, p, samp).accepted
    while not sched.idle:
        sched.tick()
        if ctl is not None:
            ctl.step_epoch()
    return {u: sched.pop_result(uid0 + u) for u in prompts}


def test_controller_on_a_live_engine_climbs_rolls_back_and_keeps_tokens(tiny):
    cfg, _ = tiny
    rng = np.random.default_rng(0)
    prompts = {u: rng.integers(1, cfg.vocab_size, 12).tolist() for u in range(1, 4)}
    samp = SamplingParams(temperature=0.0, max_new_tokens=24)
    static = _engine(tiny)
    want = _drain(static.scheduler, prompts, samp)
    assert static.close()["blocks_in_use"] == 0
    eng = _engine(tiny, serve=ServeConfig(adaptation=dict(
        enabled=True, min_window=1, guard_epochs=1, cooldown_epochs=1, allow_rebuild=False)))
    now = [0.0]

    def clock():
        now[0] += 0.25
        return now[0]

    ctl = attach_controller(eng, clock=clock)
    assert ctl.cfg is eng.serve.adaptation and ctl.cfg.enabled
    sched = eng.scheduler
    assert _drain(sched, prompts, samp, ctl) == want  # knobs are schedule-only
    ups = [d for d in ctl.decisions if d["action"] == "megastep_up" and d["outcome"] == "applied"]
    assert ups and sched.knobs()["decode_megastep"] > 1
    # an injected bad retune (the chunk crushed to one block), guarded on
    # TTFT p90 with a regression the window sees, rolls back
    ctl._guard, ctl._cooldown = None, 0
    ctl.inject_retune(_metric="ttft_ms_p90", _better="lower", prefill_chunk=8)
    chunk0 = sched.knobs()["prefill_chunk"]
    ctl.step_epoch()  # applies the injected retune (baseline: the window's p90)
    sched.tick()  # lands it at a boundary
    assert sched.knobs()["prefill_chunk"] == 8
    hist = eng.telemetry.request_hists(eng._ns)["ttft"]
    for _ in range(8):
        hist.observe(1e6)  # the regression, as the guard's window reads it
    ctl.step_epoch()
    sched.tick()
    rb = [d for d in ctl.decisions if d["action"] == "rollback"]
    assert rb and rb[-1]["knobs"] == {"prefill_chunk": chunk0}
    assert sched.knobs()["prefill_chunk"] == chunk0
    assert eng.close()["blocks_in_use"] == 0


def test_controller_thread_start_stop_idempotent(tiny):
    eng = _engine(tiny)
    ctl = attach_controller(eng, AdaptationConfig(enabled=True, epoch_s=0.005))
    ctl.start()
    t = ctl._thread
    ctl.start()
    assert ctl._thread is t
    deadline = time.time() + 5.0
    while ctl.epoch == 0 and time.time() < deadline:
        time.sleep(0.005)
    assert ctl.epoch > 0
    ctl.stop()
    assert ctl._thread is None
    ctl.stop()
    assert ctl.last_error is None
    eng.close()


def test_apply_knobs_over_socket_transport(tiny):
    eng = _engine(tiny)
    srv = WorkerServer(eng, identity={"worker": 0})
    srv.bind()
    t = threading.Thread(target=srv.serve_socket, daemon=True)
    t.start()
    try:
        c = RpcClient(lambda: dial("127.0.0.1", srv.port, "rpc"))
        reply, _ = c.call({"op": "apply_knobs", "knobs": {"decode_megastep": 4}})
        assert reply["ok"] and reply["staged"] == {"decode_megastep": 4}
        assert reply["knobs"]["decode_megastep"] == 1  # staged: lands at the next tick
        c.call({"op": "tick"})
        reply, _ = c.call({"op": "apply_knobs", "knobs": {}})
        assert reply["ok"] and reply["knobs"]["decode_megastep"] == 4
        reply, _ = c.call({"op": "apply_knobs", "knobs": {"decode_megastep": 0}})
        assert not reply["ok"] and reply["error"]["kind"] == "internal"
        assert "decode_megastep" in reply["error"]["detail"]
        c.close()
        mon = HeartbeatMonitor(interval_ms=50.0, lease_ms=1000.0)
        w = RemoteWorker(0, "127.0.0.1", srv.port, mon, config=RouterConfig(n_workers=1))
        with pytest.raises(ValueError, match="refused"):
            w.apply_knobs({"kv_watermark": 2.0})
        assert w.apply_knobs({"kv_watermark": 0.25}) == {"kv_watermark": 0.25}
        assert w.close()["blocks_in_use"] == 0
    finally:
        srv.shutdown()
        t.join(timeout=5.0)
