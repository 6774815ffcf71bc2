"""Fleet observability plane: N workers as ONE system — a copy of
``deepspeed_tpu/telemetry/fleet.py`` (pure Python, same names).  The
collector pulls in-process workers through ``serving.pool.Worker.
export_metrics`` and subprocess workers through ``serving.remote.
RemoteWorker.export_metrics``, over each worker's dedicated metrics
channel, with the heartbeat monitor's ``clock_offset`` stitching a child's
spans onto the router's timeline.  It reads host state only: it never
touches a device tensor or synchronizes a stream.

Three pieces, layered strictly ABOVE the serving data plane (nothing on a
tick path imports this module; the router holds the collector by duck
type):

* :class:`FleetRegistry` — the router-side fold of per-worker
  ``export_metrics()`` snapshots.  Counters/gauges keep their latest
  cumulative value per worker (snapshots replace — the wire payload is a
  running total, not a delta); histogram STATES are merged on demand via
  :meth:`Histogram.merge`, so fleet quantiles are computed over the pooled
  distribution (exact while every shard is exact and the pooled samples
  fit the cap; within the documented ``sqrt(growth)`` bucket bound after
  degradation — merging adds no error of its own).  Per-worker labeled
  views re-key a worker's ``serve*/ttft_ms`` as ``fleet/worker3/ttft_ms``;
  rollups sum counters across workers under the same stripped key.
  Worker span-event batches (the ``spans=True`` pull) accumulate here for
  :func:`fleet_chrome_trace`.

* :class:`SloMonitor` — availability and multi-window burn rates over the
  router's terminal counters.  Availability is
  ``finished / (finished + failed + timed_out)``; a burn rate is the
  windowed error fraction divided by the error budget
  ``1 - objective`` (burn 1.0 = exactly spending the budget; the classic
  fast/slow pair catches a cliff and a smoulder respectively).  Deadline
  SLIs (fraction of fleet TTFT/e2e above the configured deadline) come
  from the merged histograms when a :class:`FleetRegistry` is supplied.

* :class:`FleetCollector` — the pull loop.  One daemon thread paces on a
  condition variable and calls each worker's ``export_metrics()`` facade
  with NO lock held (remote pulls are socket I/O on the dedicated metrics
  channel; a dead or partitioned worker degrades to ``None`` and is simply
  skipped — death discovery belongs to the heartbeat lease, not the
  collector).  Results fold into the registry under ITS lock only.

:func:`fleet_chrome_trace` stitches the router's own telemetry (pid block
0) and every worker's drained span/request events (one pid block per
worker, clock-offset shifted onto the router's ``perf_counter`` timeline)
into one Perfetto/chrome-trace file.
"""
from __future__ import annotations

import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .registry import Histogram
from .tracing import _strictly_order

__all__ = [
    "FleetRegistry", "SloMonitor", "FleetCollector",
    "attach_fleet_collector", "fleet_chrome_trace",
]

# a worker's engine claims "serve"/"serve2"/... (with paired "sched"/
# "comm" namespaces) on ITS private registry; fleet views normalize the
# per-process numbering so worker 3's serve/ttft_ms and worker 4's
# serve2/ttft_ms land under ONE fleet key (ttft_ms), and sched2/finished
# rolls up with sched/finished.  The serve family strips entirely (its
# metrics ARE the request-facing fleet surface); sched/comm keep their
# family prefix so e.g. sched/finished never collides with a serve key.
_SERVE_NS = re.compile(r"^serve\d*/")
_AUX_NS = re.compile(r"^(sched|comm)\d+/")


def _strip_ns(name: str) -> str:
    name = _SERVE_NS.sub("", name, count=1)
    return _AUX_NS.sub(r"\1/", name, count=1)


class FleetRegistry:
    """Router-side fold of per-worker metric snapshots (see module doc).

    Thread contract: every method is safe from any thread (one internal
    lock guards the tables); nothing here does I/O or takes another
    object's lock, so it can never participate in a lock cycle with the
    collector or the router."""

    def __init__(self, max_events_per_worker: int = 65536):
        self._lock = threading.Lock()
        # worker -> {"metrics": export_state payload, "ts": worker clock,
        #            "offset": (offset_s, err_s) | None, "pulls": int,
        #            "failures": int, "events": [chrome events ...]}
        self._workers: Dict[str, Dict[str, Any]] = {}
        self._max_events = int(max_events_per_worker)
        self.merge_conflicts = 0  # mismatched-geometry hists skipped
        self.events_dropped = 0

    def _slot_locked(self, worker: str) -> Dict[str, Any]:
        slot = self._workers.get(worker)
        if slot is None:
            slot = self._workers[worker] = {
                "metrics": {"counters": {}, "gauges": {}, "histograms": {}},
                "ts": None, "offset": None, "pulls": 0, "failures": 0,
                "events": [],
            }
        return slot

    def ingest(self, worker: str, payload: Dict[str, Any],
               offset: Optional[Tuple[float, float]] = None) -> None:
        """Fold one ``export_metrics()`` payload.  Metrics REPLACE the
        worker's previous snapshot (cumulative totals); span events APPEND
        (each pull drains only what is new on the worker side)."""
        metrics = payload.get("metrics") or {}
        events = payload.get("events") or []
        with self._lock:
            slot = self._slot_locked(worker)
            slot["metrics"] = metrics
            slot["ts"] = payload.get("ts")
            slot["pulls"] += 1
            if offset is not None:
                slot["offset"] = offset
            if events:
                room = self._max_events - len(slot["events"])
                if len(events) > room:
                    self.events_dropped += len(events) - max(room, 0)
                    events = events[:max(room, 0)]
                slot["events"].extend(events)

    def note_failure(self, worker: str) -> None:
        with self._lock:
            self._slot_locked(worker)["failures"] += 1

    def note_offset(self, worker: str, offset: Tuple[float, float]) -> None:
        with self._lock:
            self._slot_locked(worker)["offset"] = offset

    # -- views --------------------------------------------------------------
    def workers(self) -> List[str]:
        with self._lock:
            return sorted(self._workers)

    def offset(self, worker: str) -> Optional[Tuple[float, float]]:
        with self._lock:
            slot = self._workers.get(worker)
            return slot["offset"] if slot else None

    def labeled_views(self) -> Dict[str, float]:
        """Flat ``fleet/<worker>/<metric>`` view over every worker's
        counters and gauges (engine namespaces stripped — worker 3's
        ``serve/ttft_ms`` histograms surface via :meth:`merged_summary`,
        not here)."""
        out: Dict[str, float] = {}
        with self._lock:
            items = [(w, dict(s["metrics"].get("counters") or {}),
                      dict(s["metrics"].get("gauges") or {}))
                     for w, s in sorted(self._workers.items())]
        for worker, counters, gauges in items:
            for table in (counters, gauges):
                for name, v in table.items():
                    out[f"fleet/{worker}/{_strip_ns(name)}"] = v
        return out

    def counter_rollup(self) -> Dict[str, float]:
        """Fleet totals: counter values summed across workers under the
        stripped metric key (``finished``, ``tokens_out``, ...)."""
        out: Dict[str, float] = {}
        with self._lock:
            tables = [dict(s["metrics"].get("counters") or {})
                      for s in self._workers.values()]
        for table in tables:
            for name, v in table.items():
                key = _strip_ns(name)
                out[key] = out.get(key, 0.0) + v
        return out

    def histogram_states(self, metric: str) -> List[Dict[str, Any]]:
        """Every worker's state for one stripped histogram key (a worker
        contributes each of its namespaces' matching histograms)."""
        out: List[Dict[str, Any]] = []
        with self._lock:
            tables = [dict(s["metrics"].get("histograms") or {})
                      for s in self._workers.values()]
        for table in tables:
            for name, state in table.items():
                if _strip_ns(name) == metric:
                    out.append(state)
        return out

    def merged_histogram(self, metric: str) -> Optional[Histogram]:
        """The fleet-true distribution for one metric: every worker's
        histogram state folded into one :class:`Histogram` via
        :meth:`Histogram.merge` (the documented bound applies — exact
        while exact, ``sqrt(growth)`` after degradation).  A shard whose
        bucket geometry mismatches the first is SKIPPED and counted in
        ``merge_conflicts`` rather than poisoning the rollup.  None when
        no worker has the metric."""
        states = self.histogram_states(metric)
        if not states:
            return None
        merged = Histogram.from_state(states[0])
        merged.name = f"fleet/{metric}"
        for state in states[1:]:
            try:
                merged.merge(state)
            except ValueError:
                with self._lock:
                    self.merge_conflicts += 1
        return merged

    def merged_summary(
        self,
        metrics: Sequence[str] = ("ttft_ms", "tbt_ms", "queue_wait_ms",
                                  "e2e_ms"),
        qs: Sequence[float] = (50, 90, 99),
    ) -> Dict[str, Dict[str, float]]:
        """``percentile_summary``-shaped table over the MERGED fleet
        histograms (feed to ``format_percentile_table``)."""
        out: Dict[str, Dict[str, float]] = {}
        for metric in metrics:
            h = self.merged_histogram(metric)
            if h is None or h.count == 0:
                continue
            row = {"count": float(h.count), "mean": h.mean}
            row.update(h.quantiles(qs))
            out[metric] = row
        return out

    def fraction_above(self, metric: str, threshold: float
                       ) -> Optional[float]:
        """Fraction of the merged distribution above ``threshold`` — the
        deadline-SLI primitive.  Exact while the merged histogram is
        exact; otherwise each bucket counts as above/below by its
        geometric midpoint (error confined to the one straddling bucket).
        None when no observations exist."""
        h = self.merged_histogram(metric)
        if h is None or h.count == 0:
            return None
        if h._samples is not None:
            above = sum(1 for v in h._samples if v > threshold)
            return above / len(h._samples) if h._samples else None
        above = 0
        for i, c in enumerate(h._counts):
            if not c:
                continue
            mid = h._lo if i == 0 else (h._edge(i - 1) * h._edge(i)) ** 0.5
            if mid > threshold:
                above += c
        return above / h.count

    def snapshot(self) -> Dict[str, Any]:
        """Per-worker pull health for ``Router.signals()``: pulls,
        failures, last worker-clock ts, clock offset estimate."""
        with self._lock:
            return {
                w: {"pulls": s["pulls"], "failures": s["failures"],
                    "ts": s["ts"], "offset": s["offset"],
                    "events": len(s["events"])}
                for w, s in sorted(self._workers.items())
            }

    def events(self) -> Dict[str, List[Dict[str, Any]]]:
        """Copy of each worker's accumulated span events (worker-local
        pids/timestamps — :func:`fleet_chrome_trace` does the remap)."""
        with self._lock:
            return {w: list(s["events"])
                    for w, s in sorted(self._workers.items())}


class SloMonitor:
    """Availability + multi-window burn rates over terminal counters.

    ``counters`` maps the three terminal outcomes to live ``Counter``
    objects (the router's own ``finished``/``failed``/``timed_out``).
    :meth:`sample` appends one ``(now, good, bad)`` observation — the
    collector calls it once per pull; a fake clock drives it in tests.
    Burn rate over a window = (bad / total within the window) divided by
    the error budget ``1 - objective``; 0.0 while the window saw no
    terminals (no traffic burns no budget)."""

    def __init__(self, counters: Dict[str, Any], objective: float = 0.999,
                 fast_window_s: float = 5.0, slow_window_s: float = 60.0,
                 deadline_ms: Optional[float] = None,
                 ttft_deadline_ms: Optional[float] = None):
        if not 0.0 < objective < 1.0:
            raise ValueError(f"slo objective must be in (0, 1), got {objective}")
        self._good = counters["finished"]
        self._bad = (counters["failed"], counters["timed_out"])
        self.objective = float(objective)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.deadline_ms = deadline_ms
        self.ttft_deadline_ms = ttft_deadline_ms
        self._lock = threading.Lock()
        self._ring: List[Tuple[float, float, float]] = []
        self._ring_cap = 4096

    @property
    def error_budget(self) -> float:
        return 1.0 - self.objective

    def _totals(self) -> Tuple[float, float]:
        good = self._good.value
        bad = sum(c.value for c in self._bad)
        return float(good), float(bad)

    def sample(self, now: float) -> None:
        good, bad = self._totals()
        with self._lock:
            if self._ring and (good < self._ring[-1][1]
                               or bad < self._ring[-1][2]):
                self._ring.clear()  # counter reset (router rebuild)
            self._ring.append((float(now), good, bad))
            if len(self._ring) > self._ring_cap:
                del self._ring[: len(self._ring) - self._ring_cap]

    def availability(self) -> float:
        """Lifetime availability; 1.0 before any terminal outcome."""
        good, bad = self._totals()
        total = good + bad
        return good / total if total else 1.0

    def _window_error_fraction(self, now: float, window: float) -> float:
        with self._lock:
            if len(self._ring) < 2:
                return 0.0
            cutoff = now - window
            # base = the LATEST sample at or before the cutoff (a sample
            # exactly on the boundary opens the window), falling back to
            # the oldest sample when the ring doesn't reach back that far
            base = self._ring[0]
            for s in self._ring:
                if s[0] > cutoff:
                    break
                base = s
            head = self._ring[-1]
        d_good = head[1] - base[1]
        d_bad = head[2] - base[2]
        total = d_good + d_bad
        return d_bad / total if total > 0 else 0.0

    def burn_rate(self, now: float, window: float) -> float:
        return self._window_error_fraction(now, window) / self.error_budget

    def report(self, now: float, fleet: Optional[FleetRegistry] = None
               ) -> Dict[str, Any]:
        """One signals-ready dict: availability, budget, the fast/slow
        burn pair, and (given a fleet registry + configured deadlines) the
        fleet-true fraction of requests blowing each deadline."""
        good, bad = self._totals()
        out: Dict[str, Any] = {
            "availability": self.availability(),
            "objective": self.objective,
            "error_budget": self.error_budget,
            "finished": good,
            "errors": bad,
            "fast_burn_rate": self.burn_rate(now, self.fast_window_s),
            "slow_burn_rate": self.burn_rate(now, self.slow_window_s),
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
        }
        if fleet is not None:
            if self.ttft_deadline_ms is not None:
                out["ttft_deadline_viol_frac"] = fleet.fraction_above(
                    "ttft_ms", self.ttft_deadline_ms)
            if self.deadline_ms is not None:
                out["e2e_deadline_viol_frac"] = fleet.fraction_above(
                    "e2e_ms", self.deadline_ms)
        return out


class FleetCollector:
    """The pull loop: one daemon thread, paced on a condition variable.

    ``workers_fn`` returns the CURRENT ``(name, worker)`` pairs each
    round (workers die and the list shrinks; the collector never caches
    it).  Each worker's ``export_metrics(spans=...)`` runs with NO lock
    held — remote pulls are socket I/O on the dedicated metrics channel
    and a failed pull degrades to ``None`` (counted, skipped).
    ``offsets_fn(name)`` supplies the latest heartbeat clock-offset
    estimate for remote workers (None for in-process pools — one clock).

    Lock discipline: the condition's lock guards ONLY
    start/stop state and the pacing wait; pulls and registry folds happen
    outside it, and the registry/SLO objects take only their own internal
    locks — no cycle is constructible."""

    def __init__(self, fleet: FleetRegistry,
                 workers_fn: Callable[[], Sequence[Tuple[str, Any]]],
                 interval_s: float = 0.5, spans: bool = True,
                 offsets_fn: Optional[Callable[[str], Optional[Tuple[float, float]]]] = None,
                 slo: Optional[SloMonitor] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.fleet = fleet
        self.slo = slo
        self._workers_fn = workers_fn
        self._offsets_fn = offsets_fn
        self._interval = max(float(interval_s), 1e-3)
        self._spans = bool(spans)
        self._clock = clock
        self._cond = threading.Condition(threading.Lock())
        self._stop = False
        self._thread: Optional[threading.Thread] = None

    def pull_once(self) -> int:
        """One synchronous pull pass over every current worker (the loop
        body; also the test/bench seam).  Returns how many workers
        answered."""
        ok = 0
        for name, w in list(self._workers_fn()):
            payload = w.export_metrics(spans=self._spans)
            if payload is None:
                self.fleet.note_failure(name)
                continue
            offset = self._offsets_fn(name) if self._offsets_fn else None
            self.fleet.ingest(name, payload, offset=offset)
            ok += 1
        if self.slo is not None:
            self.slo.sample(self._clock())
        return ok

    def _run(self) -> None:
        while True:
            with self._cond:
                if self._stop:
                    return
            self.pull_once()
            with self._cond:
                if self._stop:
                    return
                self._cond.wait(self._interval)

    def start(self) -> "FleetCollector":
        with self._cond:
            if self._thread is not None:
                return self
            self._stop = False
            self._thread = threading.Thread(
                target=self._run, name="dstpu-fleet-collector", daemon=True)
            t = self._thread
        t.start()
        return self

    def stop(self, final_pull: bool = True) -> None:
        """Stop the loop (idempotent).  ``final_pull`` takes one last
        synchronous pass after the thread exits so the registry holds the
        workers' terminal counts/spans."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        if final_pull:
            self.pull_once()


def attach_fleet_collector(router, interval_s: Optional[float] = None,
                           spans: Optional[bool] = None,
                           objective: Optional[float] = None,
                           deadline_ms: Optional[float] = None,
                           ttft_deadline_ms: Optional[float] = None,
                           start: bool = True) -> FleetCollector:
    """Wire the fleet plane onto a live ``serving.Router`` (the same
    attach-style seam: the router never
    imports this module; the launcher/bench attaches, and
    ``Router.signals()``/``Router.close()`` consume the attached objects
    by duck type).

    Knob defaults come from the router's ``RouterConfig``
    (``metrics_pull_interval_ms``/``pull_spans``/``slo_objective``/
    ``slo_fast_window_s``/``slo_slow_window_s``); explicit arguments
    override.  ``deadline_ms``/``ttft_deadline_ms`` come from the serve
    tier's ``ServeConfig`` — pass them through for deadline SLIs.
    Remote pools contribute heartbeat clock offsets automatically."""
    cfg = router.config
    if interval_s is None:
        pull_ms = getattr(cfg, "metrics_pull_interval_ms", None)
        interval_s = (pull_ms / 1e3) if pull_ms else 0.5
    if spans is None:
        spans = bool(getattr(cfg, "pull_spans", True))
    fleet = FleetRegistry()
    slo = SloMonitor(
        {k: router._c[k] for k in ("finished", "failed", "timed_out")},
        objective=(objective if objective is not None
                   else getattr(cfg, "slo_objective", 0.999)),
        fast_window_s=getattr(cfg, "slo_fast_window_s", 5.0),
        slow_window_s=getattr(cfg, "slo_slow_window_s", 60.0),
        deadline_ms=deadline_ms, ttft_deadline_ms=ttft_deadline_ms,
    )
    pool = router.pool

    def workers_fn() -> List[Tuple[str, Any]]:
        return [(f"worker{w.index}", w) for w in pool.alive]

    def offsets_fn(name: str) -> Optional[Tuple[float, float]]:
        for w in pool.alive:
            if f"worker{w.index}" == name:
                monitor = getattr(w, "monitor", None)
                if monitor is not None:
                    return monitor.clock_offset(w.index)
                return None
        return None

    collector = FleetCollector(
        fleet, workers_fn, interval_s=interval_s, spans=spans,
        offsets_fn=offsets_fn, slo=slo, clock=router.telemetry.clock)
    router.attach_fleet(collector)
    if start:
        collector.start()
    return collector


def fleet_chrome_trace(fleet: FleetRegistry, telemetry=None,
                       path: Optional[str] = None,
                       pid_stride: int = 100) -> Dict[str, Any]:
    """Stitch one chrome-trace/Perfetto file from the fleet.

    Pid layout: the router process keeps its local layout at block 0
    (spans pid 0, request namespaces pids 1/3/5...); worker ``i`` (sorted
    by name) owns block ``pid_stride * (i + 1)`` and every event it
    shipped is remapped ``pid -> block + pid`` — so N workers' identical
    local layouts can never alias (collision-free as long as one process
    claims fewer than ``pid_stride`` request namespaces).  Worker
    timestamps are shifted by the latest heartbeat clock-offset estimate
    (``router_time ~= worker_ts - offset``, error bounded by RTT/2 of the
    minimum-RTT ping), putting a request's router-side queueing, prefill
    chunks, KV-handoff migration and decode emits on ONE timeline.
    In-process pools share the router's telemetry object — their spans
    are already in block 0 and no shift applies (one process, one clock).
    """
    events: List[Dict[str, Any]] = []
    if telemetry is not None:
        events.extend(telemetry.chrome_trace()["traceEvents"])
        events.append({"name": "process_name", "ph": "M", "pid": 0,
                       "tid": 0, "args": {"name": "router"}})
        events.append({"name": "process_name", "ph": "M", "pid": 1,
                       "tid": 0, "args": {"name": "router:requests"}})
    meta: Dict[str, Any] = {"workers": {}}
    per_worker = fleet.events()
    for i, worker in enumerate(sorted(per_worker)):
        base = pid_stride * (i + 1)
        off = fleet.offset(worker)
        shift_us = (off[0] * 1e6) if off else 0.0
        named: set = set()
        for e in per_worker[worker]:
            e2 = dict(e)
            local_pid = int(e2.get("pid", 0))
            e2["pid"] = base + local_pid
            if "ts" in e2:
                e2["ts"] = e2["ts"] - shift_us
            if local_pid not in named:
                named.add(local_pid)
                label = worker if local_pid == 0 \
                    else f"{worker}:requests+{local_pid}"
                events.append({"name": "process_name", "ph": "M",
                               "pid": base + local_pid, "tid": 0,
                               "args": {"name": label}})
            events.append(e2)
        meta["workers"][worker] = {
            "pid_base": base,
            "events": len(per_worker[worker]),
            "clock_offset_s": off[0] if off else None,
            "clock_offset_err_s": off[1] if off else None,
        }
    out = {
        "traceEvents": _strictly_order(events),
        "displayTimeUnit": "ms",
        "metadata": meta,
    }
    if path is not None:
        import json

        with open(path, "w") as fh:
            json.dump(out, fh)
    return out
