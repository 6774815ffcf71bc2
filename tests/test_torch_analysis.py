"""The port's static analysis (``deepspeed_tpu_torch/analysis``) against the
JAX package's, on the CPU.

- the same planted sources through JAX's and the port's
  ``lint_race_source`` give equal violation lists (every rule);
- ``explore`` over planted lost-update and deadlock scenarios gives the
  same report and traces for the same seeds in both packages;
- the torch re-scope: the host-sync rule catches each torch sync in a hot
  path (and the blocking-under-lock rule under a lock), the global-state
  rule a new ``global``, the raw-``torch.distributed`` rule a collective
  outside ``comm/``; a tick-path module importing the controller or the
  fleet plane is caught;
- the port's repo-wide lints are clean, every exemption is explicit, and a
  stale exemption fails (JAX ``tests/test_racelint.py:428-439``);
- the scenario bank passes on the port's scheduler, router, pool,
  heartbeat monitor, controller and telemetry.
"""
import re
import threading

import pytest

from deepspeed_tpu.analysis import racelint as jrace
from deepspeed_tpu.analysis import schedviz as jsched

from deepspeed_tpu_torch.analysis import astlint, racelint, schedviz

PLANTED = {
    "unguarded": """
import threading

class Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0
        self.items = []

    def inc(self):
        with self._lock:
            self.n += 1
            self.items.append(self.n)

    def _bump_locked(self):
        self.n += 1

    def reset(self):
        self.n = 0
        self.items.clear()
""",
    "lock_order": """
import threading

class Pair:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def _take_b(self):
        with self._b:
            pass

    def one(self):
        with self._a:
            self._take_b()

    def two(self):
        with self._b:
            with self._a:
                pass

    def again(self):
        with self._a:
            with self._a:
                pass
""",
    "blocking": """
import threading
import time

class S:
    def __init__(self):
        self._lock = threading.RLock()

    def slow(self):
        with self._lock:
            time.sleep(0.5)

    def sync(self, x):
        with self._lock:
            return x.block_until_ready(), x.item()

    def log(self, line):
        with self._lock:
            with open("/tmp/x", "a") as fh:
                fh.write(line)
""",
    "cross_thread": """
import threading

class Watchdog:
    def __init__(self, engine):
        self.engine = engine
        self._t = threading.Thread(target=self._watch, daemon=True)

    def _watch(self):
        self._probe()

    def _probe(self):
        self.engine.tick()
        self.step()
""",
    "clean": """
import threading

class Fine:
    def __init__(self):
        self._lock = threading.Lock()
        self.q = []

    def put(self, x):
        with self._lock:
            self.q.append(x)
""",
}


@pytest.mark.parametrize("name", sorted(PLANTED))
def test_planted_sources_lint_as_jax(name):
    """Equal (rule, path, line, key) lists; the texts differ only where the
    port names its own engine state."""
    got = [(v.rule, v.path, v.line, v.key)
           for v in racelint.lint_race_source(PLANTED[name], "x.py")]
    want = [(v.rule, v.path, v.line, v.key)
            for v in jrace.lint_race_source(PLANTED[name], "x.py")]
    assert got == want
    assert bool(got) == (name != "clean")


def test_a_blocking_call_assigned_under_a_lock_is_seen():
    """The port visits an assignment's value itself; JAX's pass visits only
    its children and misses ``v = x.item()`` under a lock."""
    src = """
import threading

class S:
    def __init__(self):
        self._lock = threading.Lock()

    def read(self, x):
        with self._lock:
            v = x.item()
        return v
"""
    assert [v.key for v in racelint.lint_race_source(src, "x.py")] == ["S.read:.item()"]
    assert jrace.lint_race_source(src, "x.py") == []


def test_race_rules_know_torch_syncs_and_the_port_engine():
    src = """
import threading
import torch

class S:
    def __init__(self, engine):
        self._lock = threading.Lock()
        self.engine = engine
        self._t = threading.Thread(target=self._run)

    def fetch(self, x, ev):
        with self._lock:
            a = x.tolist()
            b = x.cpu().numpy()
            torch.cuda.synchronize()
            ev.synchronize()
        return a, b

    def _run(self):
        self.engine.graphs[0].replay()
        self.engine._decode_burst([], None, 4)
"""
    vs = racelint.lint_race_source(src, "y.py")
    blocking = {v.key.split(":")[-1] for v in vs if v.rule == "blocking-under-lock"}
    assert blocking == {".tolist()", ".cpu()", ".numpy()", ".synchronize()"}
    markers = {v.key.split(":")[-1] for v in vs if v.rule == "cross-thread-engine"}
    assert {"engine", "graphs", "replay()", "_decode_burst()"} <= markers


def _lost_update(mod):
    def scenario(seed):
        sched = mod.Schedule(seed, max_preemptions=8, preempt_p=1.0)
        box = {"n": 0}

        def bump():
            for _ in range(3):
                v = box["n"]
                mod.checkpoint()
                box["n"] = v + 1

        with sched.instrument():
            sched.spawn(bump, name="a")
            sched.spawn(bump, name="b")
            sched.run()
        assert box["n"] == 6, f"lost update: {box['n']} != 6 (seed={seed})"
        return sched.trace

    return scenario


def _deadlock(mod):
    def scenario(seed):
        sched = mod.Schedule(seed, max_preemptions=8, preempt_p=1.0)
        with sched.instrument():
            a = threading.Lock()  # cooperative inside the instrumented scope
            b = threading.Lock()

            def forward():
                with a:
                    mod.checkpoint()
                    with b:
                        pass

            def backward():
                with b:
                    mod.checkpoint()
                    with a:
                        pass

            sched.spawn(forward, name="fwd")
            sched.spawn(backward, name="bwd")
            sched.run()
        return sched.trace

    return scenario


@pytest.mark.parametrize("make", [_lost_update, _deadlock], ids=["lost_update", "deadlock"])
def test_explore_matches_jax_seed_for_seed(make):
    def report(mod):  # the lock objects' addresses differ between runs
        rep = mod.explore(make(mod), seeds=range(16))
        rep["failures"] = {k: re.sub(r"0x[0-9a-f]+", "0x", v)
                           for k, v in rep["failures"].items()}
        return rep

    got, want = report(schedviz), report(jsched)
    assert got["failures"] == want["failures"] and got["schedules"] == 16
    assert got["failures"] and len(got["failures"]) < 16  # it explores
    assert any(("lost update" in m) or ("held by" in m) for m in got["failures"].values())
    ok = next(s for s in range(16) if str(s) not in got["failures"])
    assert make(schedviz)(ok) == make(jsched)(ok)  # the same schedule trace


def test_host_sync_rule_catches_each_torch_sync():
    src = """
import torch

def _decode_tick(self, seqs, sampling):
    a = logits.item()
    b = logits.tolist()
    c = logits.cpu()
    d = logits.numpy()
    torch.cuda.synchronize()
    self.event.synchronize()
    e = float(self.x[0])
    return a, b, c, d, e

def helper(x):
    return x.item()
"""
    vs = astlint.lint_source(src, "inference/engine_v2.py")
    assert [v.rule for v in vs] == ["host-sync"] * 7
    assert all("_decode_tick" in v.message or "float(" in v.message for v in vs)
    # the designed fetch of a burst is allowed, nothing else is
    burst = """
def _decode_burst(self, st, n):
    burst = st.buf[:n + 1].cpu().numpy()
    return burst.item()
"""
    vs = astlint.lint_source(burst, "inference/engine_v2.py")
    assert [v.message.split()[0] for v in vs] == [".item()"]
    allowed = "def _decode_tick(self):\n    return x.item()  # lint: allow(host-sync)\n"
    assert astlint.lint_source(allowed, "inference/engine_v2.py") == []


def test_global_and_dist_and_import_rules_catch_planted_cases():
    src = """
import torch.distributed as dist
from torch.distributed import all_reduce
_STATE = 0

def flip():
    global _STATE
    _STATE = 1

def reduce(x):
    dist.all_reduce(x)
    torch.distributed.broadcast(x, 0)
    return dist.get_rank()
"""
    rules = [v.rule for v in astlint.lint_source(src, "runtime/engine.py")]
    assert sorted(rules) == ["global-state"] + ["raw-dist-collective"] * 3
    assert [v.rule for v in astlint.lint_source(src, "comm/qcomm.py")] == ["global-state"]
    faults_src = "def scope(i):\n    global _GLOBAL\n    _GLOBAL = i\n"
    assert astlint.lint_source(faults_src, "inference/faults.py") == []
    hot = ("from ..autotuning.controller import OnlineController\n"
           "from ..telemetry import FleetCollector\n")
    assert sorted(v.rule for v in astlint.lint_source(hot, "inference/scheduler.py")) == [
        "controller-import", "fleet-import"]
    assert astlint.lint_source(hot, "serving/__init__.py") == []  # not a tick path


def test_repo_lints_are_clean_with_explicit_exemptions():
    """The repo-wide gates: no violation; the exemptions are the listed
    ones (the burst's fetch, the handoff's copy, faults' ``_GLOBAL``), each
    still live, and the race baseline empty and not stale."""
    vs = astlint.lint_package()
    assert vs == [], "\n".join(map(str, vs))
    assert astlint.stale_exemptions() == []
    assert set(astlint.HOST_SYNC_ALLOWED) == {
        ("inference/engine_v2.py", "_decode_burst"), ("inference/engine_v2.py",
                                                      "extract_kv_blocks")}
    assert astlint.GLOBAL_BASELINE == {("inference/faults.py", "_GLOBAL")}
    rvs = racelint.unbaselined(racelint.lint_race_package())
    assert rvs == [], "\n".join(map(str, rvs))
    assert racelint.RACE_BASELINE == set() and racelint.stale_race_baseline() == []
    scoped = racelint._scoped_files(racelint.PKG_ROOT, racelint.RACE_SCOPE)
    assert "runtime/prefetch.py" in scoped and "autotuning/controller.py" in scoped
    assert len(scoped) == 16


def test_stale_exemptions_are_reported(monkeypatch):
    monkeypatch.setitem(astlint.HOST_SYNC_ALLOWED, ("inference/engine_v2.py", "step"),
                        {"item"})
    monkeypatch.setattr(astlint, "GLOBAL_BASELINE",
                        astlint.GLOBAL_BASELINE | {("runtime/engine.py", "_GONE")})
    monkeypatch.setitem(astlint.HOT_PATHS, "serving/router.py",
                        astlint.HOT_PATHS["serving/router.py"] | {"_no_such_function"})
    assert astlint.stale_exemptions() == [
        "HOST_SYNC_ALLOWED inference/engine_v2.py:step .item()",
        "GLOBAL_BASELINE runtime/engine.py:_GONE",
        "HOT_PATHS serving/router.py:_no_such_function"]
    key = ("unguarded-state", "x.py", "Counter.n:reset")
    monkeypatch.setattr(racelint, "RACE_BASELINE", {key})
    live = racelint.lint_race_source(PLANTED["unguarded"], "x.py")
    assert key not in {v.baseline_key for v in racelint.unbaselined(live)}
    assert racelint.stale_race_baseline(violations=[]) == [key]


@pytest.mark.parametrize("scenario", schedviz.SCENARIOS, ids=lambda s: s.__name__)
def test_scenario_bank_passes_on_the_port(scenario):
    report = schedviz.explore(scenario, seeds=range(8))
    assert report["passed"], report["failures"]
