"""The port's telemetry (``deepspeed_tpu_torch/telemetry``) against the JAX
package's on the same inputs, on the CPU.

- ``Histogram``: the same numpy samples give equal percentiles, window
  quantiles and ``state_dict`` in the exact regime and past
  ``exact_quantiles`` (bucketed), and merges equal JAX's;
- ``MetricsRegistry``: ``claim_prefix`` / ``claim_prefixes`` /
  ``release_prefix`` give the same namespace sequences, ``export_state``
  and ``snapshot`` are equal, and so are ``percentile_summary``,
  ``window_percentile_summary`` and ``format_percentile_table``;
- ``RateView`` on a fake clock;
- traces: a scripted span and request sequence on a fake clock gives the
  same Chrome trace (names, pids, tids, order, timestamps, args), deferred
  spans included (a CPU object is ready at once);
- the serving engine: one greedy scheduler workload with telemetry on
  records the same span names and counts, the same histogram counts and the
  same namespaces as the JAX engine, and tokens equal to telemetry off;
- the training engine honours the ``telemetry`` section (``train_batch``
  spans, ``train/step_ms``);
- the ``jax_profiler`` knob opens a labelled profiler range.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.config.config import TelemetryConfig as JTelemetryConfig
from deepspeed_tpu.inference.engine_v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.sampling import SamplingParams as JSampling
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.models.transformer import init_params as j_init
from deepspeed_tpu import telemetry as JT
from deepspeed_tpu_torch import telemetry as TT
from deepspeed_tpu_torch.config.config import ConfigError, TelemetryConfig, parse_config
from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.sampling import SamplingParams
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.models.transformer import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

ENGINE_KW = dict(max_seqs=4, num_blocks=64, block_size=8, prefill_buckets=(16, 32, 64),
                 enable_prefix_caching=True, prefill_chunk=16)


def _samples(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.lognormal(1.0, 1.5, n) * rng.choice([1e-3, 1.0, 1e3], n)).tolist()


# ---------------------------------------------------------------------------
# histograms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,exact_limit", [(1, 4096), (37, 4096), (500, 4096), (500, 64),
                                           (3000, 100), (64, 64), (65, 64)])
def test_histogram_quantiles_equal_jax(n, exact_limit):
    xs = _samples(n, n)
    j = JT.Histogram("x", exact_limit=exact_limit, window_limit=50)
    t = TT.Histogram("x", exact_limit=exact_limit, window_limit=50)
    for v in xs:
        j.observe(v)
        t.observe(v)
    assert t.exact == j.exact == (n <= exact_limit)
    qs = (0, 1, 25, 50, 90, 99, 99.9, 100)
    assert t.quantiles(qs) == j.quantiles(qs)
    assert t.window_quantiles(qs) == j.window_quantiles(qs)
    assert (t.count, t.sum, t.mean, t.min, t.max) == (j.count, j.sum, j.mean, j.min, j.max)
    assert t.state_dict() == j.state_dict()
    # the round trip through the mergeable state keeps every number
    back = TT.Histogram.from_state(t.state_dict())
    assert back.quantiles(qs) == JT.Histogram.from_state(j.state_dict()).quantiles(qs)


@pytest.mark.parametrize("sizes", [(10, 20), (3000, 10), (40, 40, 40)])
def test_histogram_merge_equals_jax(sizes):
    def build(mod):
        hs = []
        for i, n in enumerate(sizes):
            h = mod.Histogram("x", exact_limit=100)
            for v in _samples(n, 100 + i):
                h.observe(v)
            hs.append(h)
        m = hs[0]
        for h in hs[1:]:
            m.merge(h)
        return m

    j, t = build(JT), build(TT)
    assert t.state_dict() == j.state_dict()
    assert t.quantiles((50, 90, 99)) == j.quantiles((50, 90, 99))


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
def _script_registry(mod, clock):
    reg = mod.MetricsRegistry(enabled=True, exact_limit=8)
    names = [reg.claim_prefix("serve"), reg.claim_prefix("serve"),
             *reg.claim_prefixes(("serve", "sched", "comm")), reg.claim_prefix("router")]
    reg.release_prefix("serve2")
    names += [reg.claim_prefix("serve"), *reg.claim_prefixes(("serve", "sched"))]
    for i, name in enumerate(("serve/a", "serve/b", "serve3/a", "sched/x", "router/r")):
        reg.counter(name).inc(i + 1)
    reg.gauge("serve/g").set(0.25)
    reg.gauge("serve3/g").set(-2.0)
    for name, seed, n in (("serve/ttft_ms", 1, 5), ("serve/tbt_ms", 2, 30),
                          ("serve3/ttft_ms", 3, 3), ("sched/h", 4, 0)):
        h = reg.histogram(name)
        for v in _samples(n, seed):
            h.observe(v)
    rate = mod.RateView(reg.counter("serve/a"), window=3)
    rates = []
    for step in range(6):
        reg.counter("serve/a").inc(step * step)
        if step == 4:
            reg.counter("serve/a").set(1)  # a reset restarts the window
        rates.append(rate.sample(clock(step)))
    return reg, names, rates


def test_registry_namespaces_states_and_rates_equal_jax():
    clock = lambda step: 10.0 + 0.5 * step  # noqa: E731
    jreg, jnames, jrates = _script_registry(JT, clock)
    treg, tnames, trates = _script_registry(TT, clock)
    assert tnames == jnames
    assert trates == jrates
    assert treg.export_state() == jreg.export_state()
    for pre in (("serve",), ("serve3", "sched"), ("router",), ()):
        assert treg.export_state(pre) == jreg.export_state(pre)
    assert treg.snapshot(7) == jreg.snapshot(7)
    names = ["serve/ttft_ms", "serve/tbt_ms", "serve3/ttft_ms", "sched/h", "missing"]
    for fn in ("percentile_summary", "window_percentile_summary"):
        t = getattr(TT, fn)(treg, names)
        assert t == getattr(JT, fn)(jreg, names)
        assert TT.format_percentile_table(t, "t") == JT.format_percentile_table(t, "t")
    assert TT.format_percentile_table({}) == JT.format_percentile_table({})
    # releasing drops the namespace's metrics, as in JAX
    for reg in (treg, jreg):
        reg.release_prefix("serve3")
    assert treg.export_state() == jreg.export_state()


def test_disabled_registry_keeps_counters_only():
    for mod in (TT, JT):
        reg = mod.MetricsRegistry(enabled=False)
        reg.counter("c").inc(3)
        reg.histogram("h").observe(1.0)
        reg.gauge("g").set(2.0)
        assert reg.snapshot() == []
        assert reg.export_state() == {"counters": {"c": 3}, "gauges": {}, "histograms": {}}


# ---------------------------------------------------------------------------
# spans, request traces and the Chrome trace
# ---------------------------------------------------------------------------
class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.00125
        return self.t


def _script_trace(mod, ready):
    tel = mod.Telemetry(True, clock=_Clock(), exact_quantiles=16)
    ns2 = tel.claim_prefixes(("serve", "sched"))[0]
    ns2 = tel.claim_prefixes(("serve", "sched"))[0]  # serve2
    rec = tel.recorder
    h = tel.registry.histogram("serve/decode_tick_ms")
    sp = rec.start("prefill_pack", track="serve", tokens=48, ctx=False)
    sp.dispatched()
    sp.end(sync_obj=ready)  # deferred: settled by the next host-complete span
    sp = rec.start("decode_tick", track="serve", hist=h, batch=2)
    sp.dispatched()
    sp.end()
    rec.start("prefill_pack", track=ns2, tokens=16).end(sync_obj=ready)
    rec.start("route", track="router", uid=7, replays=0).end(accepted=True, worker=1)
    for uid, ns, n_tok, outcome in ((1, "serve", 3, "finished"), (2, ns2, 1, "timed_out"),
                                    (3, "serve", 0, "cancelled")):
        tr = tel.request_trace(uid, ns=ns)
        tr.submitted(prompt_tokens=10 + uid)
        tr.admitted()
        t0 = tel.clock()
        tr.prefill_chunk(t0, tel.clock(), 8)
        if n_tok:
            tr.tokens(1)
        if n_tok > 1:
            tr.preempted()
            tr.admitted()
            tr.tokens(n_tok - 1)
        tr.add_spec(4, 3)
        tr.finished(outcome=outcome)
    trace = tel.chrome_trace()
    drained = tel.drain_chrome_events()
    return tel, trace, drained


def test_chrome_trace_equals_jax_on_a_fake_clock():
    jtel, jtrace, jdrained = _script_trace(JT, jnp.zeros(3))
    ttel, ttrace, tdrained = _script_trace(TT, torch.zeros(3))
    assert ttrace == jtrace
    assert tdrained == jdrained
    names = [e["name"] for e in ttrace["traceEvents"]]
    assert "prefill_pack window (1 dispatches)" in names  # a settled deferred span
    assert {"timed_out", "cancelled", "first_token", "preempted"} <= set(names)
    assert {e["pid"] for e in ttrace["traceEvents"]} == {0, 1, 3}
    # the request histograms of both namespaces
    for ns in ("serve", "serve2"):
        for k, h in ttel.request_hists(ns).items():
            assert h.state_dict() == jtel.request_hists(ns)[k].state_dict(), (ns, k)
    assert [t.summary() for t in ttel.finished_traces] == \
        [t.summary() for t in jtel.finished_traces]


def test_deferred_span_waits_on_its_event():
    """A deferred span's sync object is waited on at flush (a CUDA event
    in the engines); it is settled with a device window and its histogram
    observation."""
    calls = []

    class Event:
        def synchronize(self):
            calls.append(1)

    tel = TT.Telemetry(True, clock=_Clock())
    h = tel.registry.histogram("x")
    sp = tel.recorder.start("prefill_pack", track="serve", hist=h)
    sp.end(sync_obj=Event())
    assert sp.device_ms is None and h.count == 0
    tel.flush()
    assert calls == [1] and sp.device_ms > 0 and h.count == 1

    class Broken:
        def synchronize(self):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

    tel.recorder.start("prefill_pack", track="serve").end(sync_obj=Broken())
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tel.flush()  # a device error is never swallowed


def test_disabled_telemetry_is_inert():
    tel = TT.Telemetry(None)
    assert tel.recorder.start("x") is TT.NULL_SPAN
    assert tel.request_trace(1) is TT.NULL_REQUEST_TRACE
    assert tel.chrome_trace()["traceEvents"] == []
    assert TT.Telemetry.ensure(tel) is tel


def test_step_annotation_opens_a_profiler_range():
    tel = TT.Telemetry(TelemetryConfig(enabled=True, jax_profiler=True))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tel.step_annotation("decode_tick", 3):
            torch.ones(4).sum()
    assert any(e.key == "decode_tick#step_num=3" for e in prof.key_averages())
    with TT.Telemetry(True).step_annotation("decode_tick", 1):  # knob off: a no-op
        pass


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(exact_quantiles=-1), dict(max_spans=0)])
def test_telemetry_config_checks_say_what_jax_says(kw):
    with pytest.raises(Exception) as jerr:
        JTelemetryConfig(**kw)
    with pytest.raises(ConfigError) as terr:
        TelemetryConfig(**kw)
    assert str(terr.value) == str(jerr.value)


def test_parse_config_accepts_telemetry():
    raw = {"telemetry": {"enabled": True, "jsonl_path": "x.jsonl", "exact_quantiles": 9}}
    t = parse_config(raw).telemetry
    j = JTelemetryConfig(**raw["telemetry"])
    assert t == TelemetryConfig(**raw["telemetry"])
    assert {f: getattr(t, f) for f in t.__dataclass_fields__} == \
        {f: getattr(j, f) for f in j.__dataclass_fields__}


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny():
    jcfg = j_preset("tiny", dtype=jnp.float32, max_seq_len=128)
    tcfg = get_preset("tiny", dtype=torch.float32, max_seq_len=128)
    jp = j_init(jax.random.PRNGKey(0), cfg=jcfg, dtype=jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _serve(eng, samp):
    rng = np.random.default_rng(0)
    shared = rng.integers(1, 250, 20).tolist()
    sched = eng.scheduler
    for u in range(1, 7):
        sched.submit(u, shared + rng.integers(1, 250, 4 + u).tolist(), samp)
    out = sched.run()
    return {u: out[u] for u in sorted(out)}


def _span_counts(tel):
    counts = {}
    for e in tel.chrome_trace()["traceEvents"]:
        if e.get("ph") == "X" and e["pid"] == 0:
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    return counts


def test_engine_telemetry_equals_jax_engine(tiny):
    jcfg, jp, tcfg, tp = tiny
    jeng = JEngine(jp, jcfg, telemetry=True, **ENGINE_KW)
    teng = InferenceEngineV2(tp, tcfg, device="cpu", telemetry=True, **ENGINE_KW)
    want = _serve(jeng, JSampling(temperature=0.0, max_new_tokens=6))
    got = _serve(teng, SamplingParams(temperature=0.0, max_new_tokens=6))
    assert got == want
    assert teng._ns == jeng._ns == "serve"
    jtel, ttel = jeng.telemetry, teng.telemetry
    assert _span_counts(ttel) == _span_counts(jtel)
    for k in ("prefill_pack_ms", "decode_tick_ms"):
        assert teng._h[k].count == jeng._h[k].count > 0
    for k, h in ttel.request_hists("serve").items():
        assert h.count == jtel.request_hists("serve")[k].count, k
    assert ttel.request_hists("serve")["ttft"].count == 6
    # telemetry changes no token
    off = InferenceEngineV2(tp, tcfg, device="cpu", **ENGINE_KW)
    assert _serve(off, SamplingParams(temperature=0.0, max_new_tokens=6)) == got
    for eng in (jeng, teng, off):
        assert eng.close()["blocks_in_use"] == 0
    # close released the namespaces: a new engine on the shared Telemetry
    # gets serve again
    again = InferenceEngineV2(tp, tcfg, device="cpu", telemetry=ttel, **ENGINE_KW)
    assert again._ns == "serve"
    second = InferenceEngineV2(tp, tcfg, device="cpu", telemetry=ttel, **ENGINE_KW)
    assert (second._ns, second._sched_ns, second._comm_ns) == ("serve2", "sched2", "comm2")
    assert second.stats is not again.stats and dict(second.stats) == dict(again.stats)
    again.close()
    second.close()


def test_engine_stats_view_keeps_its_names(tiny):
    from deepspeed_tpu_torch.inference.engine_v2 import STAT_NAMES

    _, _, tcfg, tp = tiny
    eng = InferenceEngineV2(tp, tcfg, device="cpu", **ENGINE_KW)
    assert list(eng.stats) == list(STAT_NAMES)
    eng.stats["decode_ticks"] += 2  # writes set the counter, as a dict would
    assert eng.stats["decode_ticks"] == 2
    assert eng.telemetry.registry.counter("serve/decode_ticks").value == 2
    eng.close()


def test_training_engine_records_train_batch_spans():
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.transformer import CausalLM

    cfg = get_preset("tiny", dtype=torch.float32, max_seq_len=32)
    engine, *_ = initialize(model=CausalLM(cfg), device="cpu", config={
        "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
        "bf16": {"enabled": False}, "steps_per_print": 2,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
        "telemetry": {"enabled": True}})
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 2, 33))
    for _ in range(3):
        engine.train_batch({"input_ids": ids})
    assert engine._h_step.count == 2  # the steps_per_print flush settled two
    assert math.isfinite(engine.get_last_loss())
    assert engine._h_step.count == 3
    events = engine.telemetry.chrome_trace()["traceEvents"]
    assert sum(e["name"] == "train_batch" for e in events) == 3
    off, *_ = initialize(model=CausalLM(cfg), device="cpu", config={
        "train_micro_batch_size_per_gpu": 2, "bf16": {"enabled": False}})
    assert not off.telemetry.enabled and off.telemetry.chrome_trace()["traceEvents"] == []
