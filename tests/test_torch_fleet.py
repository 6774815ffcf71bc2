"""The port's fleet observability plane (``deepspeed_tpu_torch/telemetry/
fleet.py``) against the JAX package's, on the CPU.

- ``FleetRegistry``: the same per-worker snapshots (real registry exports,
  with namespaces ``serve`` / ``serve2``) give equal labeled views, counter
  rollups, merged histograms and summaries, ``fraction_above``, event caps
  and merge conflicts;
- ``SloMonitor``: availability, burn rates and reports equal JAX's on a
  fake clock, counter resets included;
- ``FleetCollector``: pull folds, failures, offsets, the thread's start and
  stop;
- ``fleet_chrome_trace``: equal stitched traces (pid blocks, clock-offset
  shift) from the same inputs;
- the router seam: a telemetry-on router with an attached collector over
  3 workers (1 prefill): merged ``ttft_ms`` / ``e2e_ms`` p50 / p90 / p99
  equal the pooled samples, the stitched trace holds the migrated uid's
  ``route`` and ``handoff`` spans and at least 2 request pids, SLO
  availability 1.0, ``signals()`` carries JAX's keys and numbers, and a
  telemetry-off twin gives equal tokens and router stats.
"""
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu import telemetry as JT
from deepspeed_tpu.inference.sampling import SamplingParams as JSampling
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.models.transformer import init_params as j_init
from deepspeed_tpu.serving import build_router as j_build_router
from deepspeed_tpu_torch import telemetry as TT
from deepspeed_tpu_torch.inference.sampling import SamplingParams
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.models.transformer import params_from_numpy
from deepspeed_tpu_torch.serving import build_router
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)


class _Counter:
    def __init__(self, v=0):
        self.value = v

    def inc(self, n=1):
        self.value += n


def _payload(mod, ns="serve", finished=0, ttft=(), events=(), ts=None, exact_limit=4096,
             growth=2.0 ** 0.25, seed=0):
    """A worker snapshot as a real registry exports it."""
    reg = mod.MetricsRegistry(enabled=True, exact_limit=exact_limit)
    reg.counter(f"{ns}/finished").inc(finished)
    reg.counter(f"sched{ns[5:]}/admissions").inc(finished + 1)
    reg.gauge(f"{ns}/queue_depth").set(2.0)
    h = reg.histogram(f"{ns}/ttft_ms", growth=growth)
    for v in ttft:
        h.observe(float(v))
    e2e = reg.histogram(f"{ns}/e2e_ms")
    for v in np.random.default_rng(seed).lognormal(3.0, 1.0, len(ttft)):
        e2e.observe(float(v))
    return {"metrics": reg.export_state(), "ts": ts, "events": list(events)}


def _fleet_views(mod, max_events=65536):
    fleet = mod.FleetRegistry(max_events_per_worker=max_events)
    ev = [{"name": f"e{i}", "ph": "X", "pid": i % 2, "tid": 1, "ts": float(i), "dur": 1.0}
          for i in range(5)]
    fleet.ingest("worker0", _payload(mod, finished=3, ttft=[10, 20, 5.5], events=ev[:2]))
    fleet.ingest("worker1", _payload(mod, ns="serve2", finished=4, ttft=range(1, 40),
                                     events=ev[2:], seed=1))
    fleet.ingest("worker2", _payload(mod, ns="serve3", finished=1, ttft=[8.0], growth=1.5))
    fleet.ingest("worker0", _payload(mod, finished=5, ttft=[10, 20, 5.5, 90], seed=2))
    fleet.note_failure("worker3")
    fleet.note_offset("worker1", (1e-3, 1e-4))
    return {
        "views": fleet.labeled_views(), "rollup": fleet.counter_rollup(),
        "states": fleet.histogram_states("ttft_ms"),
        "merged": fleet.merged_histogram("ttft_ms").state_dict(),
        "summary": fleet.merged_summary(), "absent": fleet.merged_histogram("nope"),
        "above": [fleet.fraction_above("ttft_ms", x) for x in (0.0, 9.0, 25.0, 1e9)],
        "conflicts": fleet.merge_conflicts, "workers": fleet.workers(),
        "events": fleet.events(), "dropped": fleet.events_dropped,
        "snapshot": {w: {k: v for k, v in s.items() if k != "last_pull"}
                     for w, s in fleet.snapshot().items()},
    }


@pytest.mark.parametrize("max_events", [65536, 3])
def test_fleet_registry_equals_jax(max_events):
    t, j = _fleet_views(TT, max_events), _fleet_views(JT, max_events)
    assert t == j
    assert t["rollup"]["finished"] == 10.0 and t["conflicts"] >= 1


def _slo_run(mod, objective, fast, slow, steps, **kw):
    c = {"finished": _Counter(), "failed": _Counter(), "timed_out": _Counter()}
    slo = mod.SloMonitor(c, objective=objective, fast_window_s=fast, slow_window_s=slow, **kw)
    fleet = mod.FleetRegistry()
    fleet.ingest("a", _payload(mod, ttft=[10.0, 20.0, 200.0, 400.0]))
    out = [slo.availability(), slo.error_budget]
    for now, good, bad, late, reset in steps:
        c["finished"].inc(good)
        c["failed"].inc(bad)
        c["timed_out"].inc(late)
        if reset:
            c["finished"].value = 1
        slo.sample(now)
        out.append(slo.report(now, fleet=fleet))
        out.append([slo.burn_rate(now, w) for w in (1.0, fast, slow, 1e6)])
    return out


@pytest.mark.parametrize("objective,fast,slow,kw", [
    (0.9, 10.0, 100.0, {}), (0.999, 5.0, 60.0, dict(ttft_deadline_ms=100.0)),
    (0.5, 1.0, 1.0, dict(deadline_ms=30.0, ttft_deadline_ms=15.0)),
])
def test_slo_monitor_equals_jax_on_a_fake_clock(objective, fast, slow, kw):
    steps = [(0.0, 0, 0, 0, False), (10.0, 9, 1, 0, False), (20.0, 10, 0, 0, False),
             (25.0, 3, 2, 1, False), (31.0, 0, 0, 0, True), (90.0, 50, 1, 0, False)]
    assert _slo_run(TT, objective, fast, slow, steps, **kw) == \
        _slo_run(JT, objective, fast, slow, steps, **kw)
    with pytest.raises(ValueError):
        TT.SloMonitor({"finished": _Counter(), "failed": _Counter(),
                       "timed_out": _Counter()}, objective=1.0)


class _FakeWorker:
    def __init__(self, payload):
        self.payload = payload
        self.pulls = 0

    def export_metrics(self, spans=False):
        self.pulls += 1
        return self.payload


def test_collector_pulls_failures_offsets_and_thread():
    fleet = TT.FleetRegistry()
    good, dead = _FakeWorker(_payload(TT, finished=2, ttft=[5.0])), _FakeWorker(None)
    t = [0.0]
    c = {"finished": _Counter(), "failed": _Counter(), "timed_out": _Counter()}
    slo = TT.SloMonitor(c, objective=0.9)
    coll = TT.FleetCollector(fleet, lambda: [("w0", good), ("w1", dead)], interval_s=0.01,
                             offsets_fn=lambda n: (1.5, 0.1) if n == "w0" else None,
                             slo=slo, clock=lambda: t[0])
    assert coll.pull_once() == 1
    snap = fleet.snapshot()
    assert snap["w0"]["pulls"] == 1 and snap["w1"]["failures"] == 1
    assert fleet.offset("w0") == (1.5, 0.1)
    t[0] = 5.0
    coll.pull_once()
    assert slo._ring[-1][0] == 5.0
    # the paced thread, then a final synchronous pull at stop
    coll = TT.FleetCollector(TT.FleetRegistry(), lambda: [("w0", good)], interval_s=0.005)
    coll.start()
    assert coll.start() is coll
    wait = threading.Event()
    for _ in range(200):
        if good.pulls >= 5:
            break
        wait.wait(0.01)
    before = good.pulls
    coll.stop(final_pull=True)
    assert good.pulls >= before + 1 and before >= 5
    after = good.pulls
    wait.wait(0.03)
    assert good.pulls == after
    coll.stop()


def _stitched(mod):
    fleet = mod.FleetRegistry()
    ev = {"name": "tick", "ph": "X", "pid": 0, "tid": 1, "ts": 1000.0, "dur": 5.0}
    req = {"name": "queued", "ph": "X", "pid": 1, "tid": 7, "ts": 2000.0, "dur": 5.0}
    fleet.ingest("w0", _payload(mod, events=[ev, req, dict(ev, ts=1000.0)]))
    fleet.ingest("w1", _payload(mod, ns="serve2", events=[dict(ev, ts=3000.0)]))
    fleet.note_offset("w1", (1e-3, 1e-4))
    t = [50.0]

    def clock():
        t[0] += 0.001
        return t[0]

    tel = mod.Telemetry(True, clock=clock)
    tel.recorder.start("route", track="router", uid=7).end(accepted=True)
    tel.recorder.start("handoff", track="router", uid=7).end(outcome="migrated")
    return mod.fleet_chrome_trace(fleet, telemetry=tel)


def test_fleet_chrome_trace_equals_jax():
    t, j = _stitched(TT), _stitched(JT)
    assert t == j
    xs = [e for e in t["traceEvents"] if e["ph"] == "X"]
    assert {e["pid"] for e in xs if e["name"] == "tick"} == {100, 200}
    assert next(e for e in xs if e["pid"] == 200)["ts"] == pytest.approx(2000.0)


# ---------------------------------------------------------------------------
# the router seam
# ---------------------------------------------------------------------------
SEC = dict(max_seqs=4, num_blocks=96, block_size=8, prefill_buckets=[16, 32, 64, 128],
           max_seq_len=256, enable_prefix_caching=True)
ROUTER = dict(n_workers=3, prefill_workers=1, disagg_threshold=32,
              metrics_pull_interval_ms=25.0)


@pytest.fixture(scope="module")
def fleet_runs():
    jcfg = j_preset("tiny", max_seq_len=256, dtype=jnp.float32)
    tcfg = get_preset("tiny", max_seq_len=256, dtype=torch.float32)
    jp = j_init(jax.random.PRNGKey(0), cfg=jcfg, dtype=jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    rng = np.random.default_rng(0)
    sys_prompt = rng.integers(1, tcfg.vocab_size, 16).tolist()
    prompts = {u: (sys_prompt if u % 2 else rng.integers(1, tcfg.vocab_size, 16).tolist())
               + rng.integers(1, tcfg.vocab_size, 8).tolist() for u in range(1, 7)}
    long_prompt = rng.integers(1, tcfg.vocab_size, 48).tolist()
    runs = {}
    for key, mod, build, params, cfg, Samp, tel in (
            ("jax", JT, j_build_router, jp, jcfg, JSampling, True),
            ("port", TT, build_router, tp, tcfg, SamplingParams, True),
            ("port_off", TT, build_router, tp, tcfg, SamplingParams, False)):
        kw = {} if key == "jax" else dict(device="cpu")
        telemetry = mod.Telemetry(True) if tel else None
        router = build(params, cfg, SEC, router=ROUTER if tel else dict(
            ROUTER, metrics_pull_interval_ms=None), telemetry=telemetry, **kw)
        collector = mod.attach_fleet_collector(router, start=False) if tel else None
        samp = Samp(temperature=0.0, max_new_tokens=8)
        for u, p in prompts.items():
            assert router.try_submit(u, p, samp).accepted
        router.submit(9001, long_prompt, samp)
        if collector:
            collector.pull_once()
        out = router.run()
        if collector:
            collector.pull_once()
        run = dict(out=out, stats=dict(router.stats), router=router, collector=collector,
                   telemetry=telemetry, mod=mod)
        if collector:
            run["signals"] = router.signals()
            run["trace"] = mod.fleet_chrome_trace(collector.fleet, telemetry=telemetry)
        run["audits"] = router.close()
        runs[key] = run
    return runs


def test_routed_fleet_merges_equal_pooled_samples(fleet_runs):
    run = fleet_runs["port"]
    fleet = run["collector"].fleet
    assert fleet.workers() == ["worker0", "worker1", "worker2"]
    for metric in ("ttft_ms", "e2e_ms"):
        pooled = sorted(v for st in fleet.histogram_states(metric) for v in st["samples"] or [])
        merged = fleet.merged_histogram(metric)
        # 6 prompts, the long one on the prefill worker, and its adopted
        # copy's own first token on the decode worker (as in JAX)
        assert merged.exact and merged.count == len(pooled) == 8
        for q in (50, 90, 99):
            rank = min(len(pooled), max(1, math.ceil(q / 100 * len(pooled))))
            assert merged.percentile(q) == pooled[rank - 1]
    assert all(a["blocks_in_use"] == 0 for a in run["audits"])


def test_routed_fleet_trace_and_slo(fleet_runs):
    run = fleet_runs["port"]
    assert run["stats"]["handoffs"] == 1
    xs = [e for e in run["trace"]["traceEvents"] if e.get("ph") == "X"]
    mig = [e for e in xs if e["pid"] == 0 and e.get("args", {}).get("uid") == 9001]
    assert {"route", "handoff"} <= {e["name"] for e in mig}
    assert len({e["pid"] for e in xs if e["pid"] % 2 == 1}) >= 2
    sig = run["signals"]
    assert sig["slo"]["availability"] == 1.0 and sig["fleet_counters"]
    for k, v in sig["fleet_counters"].items():
        assert v == fleet_runs["jax"]["signals"]["fleet_counters"][k], k


def test_routed_fleet_equals_jax_and_the_telemetry_off_twin(fleet_runs):
    port, jax_run, off = fleet_runs["port"], fleet_runs["jax"], fleet_runs["port_off"]
    assert port["out"] == jax_run["out"] == off["out"]
    assert port["stats"] == jax_run["stats"] == off["stats"]
    sig, jsig = port["signals"], jax_run["signals"]
    assert sorted(sig) == sorted(jsig)
    for k in ("tick_no", "workers_alive", "backlog", "inflight", "queue_depth",
              "shed_pressure", "shedding", "counters"):
        assert sig[k] == jsig[k], k
    assert {k: v for k, v in sig["slo"].items() if "burn" not in k} == \
        {k: v for k, v in jsig["slo"].items() if "burn" not in k}
    for metric in ("ttft_ms", "e2e_ms"):
        assert port["collector"].fleet.merged_histogram(metric).count == \
            jax_run["collector"].fleet.merged_histogram(metric).count


def test_router_close_stops_collector():
    tcfg = get_preset("tiny", max_seq_len=64, dtype=torch.float32)
    from deepspeed_tpu_torch.models.transformer import init_params

    params = init_params(tcfg, seed=1, device="cpu")
    r = build_router(params, tcfg, dict(max_seqs=2, num_blocks=16, block_size=8,
                                        prefill_buckets=[16], max_seq_len=64),
                     router=dict(n_workers=2), device="cpu")
    coll = TT.attach_fleet_collector(r, interval_s=0.005, start=True)
    audits = r.close()
    assert all(a["blocks_in_use"] == 0 for a in audits)
    assert coll._thread is None and r._fleet_collector is None
    w = r.pool.workers[0]
    assert w.export_metrics() is None  # a dead (closed) worker's facade
