"""Metrics registry: thread-safe counters / gauges / histograms — a copy
of ``deepspeed_tpu/telemetry/registry.py`` (pure Python, same names), so
the port's histograms, snapshots and namespaces equal the JAX package's on
the same inputs.

The aggregate half of the unified telemetry layer (tracing.py is the
timeline half).  Reference analogues: ``deepspeed/monitor`` consumes
``(label, value, step)`` events and ``deepspeed/utils/timer.py`` keeps
named aggregates; this registry is the single process-wide home for both
shapes, feeding

- the serving/training hot paths (engine_v2 / ServeScheduler ``stats``
  dicts are :class:`StatsView` read-throughs over registry counters),
- the monitor fan-out (``snapshot()`` flattens every metric to the
  ``(label, value, step)`` triples ``MonitorMaster.write_events`` takes),
- a JSONL structured-event sink for per-request records and ad-hoc events.

Design constraints, in order:

1. **Counters are always live.**  The engines' ``stats`` compat views are
   part of their correctness surface (tests and bench diff them), so a
   counter counts whether telemetry is enabled or not — its cost is one
   lock acquire + integer add.  The *observability* machinery (histograms,
   gauges, snapshot export, the JSONL sink, span/trace recording) is what
   the disabled path turns into shared no-op singletons.
2. **Histograms are fixed log-spaced buckets + exact small-count
   quantiles.**  Latency distributions span decades (µs dispatch to
   seconds of queueing); log buckets bound relative quantile error at
   ``sqrt(growth)`` regardless of scale.  Until ``exact_limit``
   observations, raw samples are retained and quantiles are exact
   (nearest-rank) — a serve run of a few thousand requests reports exact
   p99s, while an unbounded production stream degrades gracefully to the
   bucket estimate instead of growing host memory.
3. **Thread safety** is per-metric locking: the serving loop, the prefetch
   worker, and checkpoint threads all observe concurrently.  The registry
   lock additionally owns the NAMESPACE MAP (``claim_prefix`` /
   ``release_prefix``): claim, release, and the metric-table drop that
   rides a release are one atomic step under ONE lock, so a concurrent
   claimant can never re-register fresh metrics into a half-released
   namespace and have them swept by the in-flight drop.  The JSONL sink
   holds a DEDICATED lock: file I/O never stalls ``counter()``/
   ``snapshot()`` behind disk writes.
"""
from __future__ import annotations

import json
import math
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, MutableMapping, Optional, Sequence, Tuple

Event = Tuple[str, float, int]


class Counter:
    """Thread-safe integer counter (float increments are accepted)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    add = inc

    def set(self, v) -> None:
        """Direct write — exists for the ``StatsView`` compat path, where
        legacy ``stats[k] = v`` assignments must keep working."""
        with self._lock:
            self._value = v

    @property
    def value(self):
        return self._value

    def __repr__(self) -> str:
        return f"Counter({self.name}={self._value})"


class Gauge:
    """Last-write-wins scalar (queue depths, pool occupancy)."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def __repr__(self) -> str:
        return f"Gauge({self.name}={self._value})"


class Histogram:
    """Log-spaced-bucket histogram with exact quantiles for small counts.

    Buckets cover ``(lo * growth**(i-1), lo * growth**i]``; bucket 0 is the
    underflow bin (values <= ``lo``, including 0 — accept-rate style [0, 1]
    metrics stay exact while raw samples are retained) and the last bucket
    is the overflow bin.  Quantiles are nearest-rank over raw samples up to
    ``exact_limit`` observations; past that the raw list is dropped and
    quantiles interpolate the geometric midpoint of the covering bucket,
    clamped to the observed [min, max].

    Alongside the lifetime-cumulative store, a bounded ring of the most
    recent ``window_limit`` samples backs the ``window_*`` views — the
    drift-detection surface the online autotuning controller samples each
    epoch (a lifetime p90 over an hour of traffic cannot see a
    five-minute-old phase shift) and the steady-state percentile tables
    the bench reports.  The ring is always exact (nearest-rank over the
    retained samples) and survives the ``exact_limit`` degradation of the
    cumulative store.
    """

    __slots__ = ("name", "_lock", "_lo", "_log_lo", "_log_g", "_growth",
                 "_counts", "_samples", "_sorted", "count", "sum",
                 "_min", "_max", "exact_limit", "_window")

    def __init__(self, name: str, lo: float = 1e-3, hi: float = 1e7,
                 growth: float = 2.0 ** 0.25, exact_limit: int = 4096,
                 window_limit: int = 512):
        if not (lo > 0 and hi > lo and growth > 1):
            raise ValueError(f"bad histogram bounds lo={lo} hi={hi} growth={growth}")
        self.name = name
        self._lock = threading.Lock()
        self._lo = lo
        self._growth = growth
        self._log_lo = math.log(lo)
        self._log_g = math.log(growth)
        n_buckets = int(math.ceil((math.log(hi) - self._log_lo) / self._log_g)) + 2
        self._counts = [0] * n_buckets
        self._samples: Optional[List[float]] = []
        self._sorted: Optional[List[float]] = None
        self.count = 0
        self.sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self.exact_limit = exact_limit
        self._window: "deque[float]" = deque(maxlen=max(2, int(window_limit)))

    def _bucket_of(self, v: float) -> int:
        if v <= self._lo:
            return 0
        idx = 1 + int((math.log(v) - self._log_lo) / self._log_g)
        return min(idx, len(self._counts) - 1)

    def _edge(self, i: int) -> float:
        return self._lo * self._growth ** i

    def observe(self, v) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            self._counts[self._bucket_of(v)] += 1
            self._window.append(v)
            if self._samples is not None:
                self._samples.append(v)
                self._sorted = None
                if len(self._samples) > self.exact_limit:
                    self._samples = None  # degrade to the bucket estimate

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    @property
    def min(self) -> float:
        return self._min if self.count else 0.0

    @property
    def max(self) -> float:
        return self._max if self.count else 0.0

    @property
    def exact(self) -> bool:
        """True while quantiles are computed from retained raw samples."""
        return self._samples is not None

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile, ``q`` in [0, 100]."""
        with self._lock:
            if self.count == 0:
                return 0.0
            rank = min(self.count, max(1, math.ceil(q / 100.0 * self.count)))
            if self._samples is not None:
                if self._sorted is None:
                    self._sorted = sorted(self._samples)
                return self._sorted[rank - 1]
            cum = 0
            for i, c in enumerate(self._counts):
                cum += c
                if cum >= rank:
                    if i == 0:
                        est = self._lo
                    else:
                        est = math.sqrt(self._edge(i - 1) * self._edge(i))
                    return min(max(est, self._min), self._max)
            return self._max  # unreachable; defensive

    def quantiles(self, qs: Sequence[float] = (50, 90, 99)) -> Dict[str, float]:
        return {f"p{int(q) if float(q).is_integer() else q}": self.percentile(q)
                for q in qs}

    # -- windowed views (ring of recent samples; drift detection) ----------
    @property
    def window_count(self) -> int:
        return len(self._window)

    def window_percentile(self, q: float) -> float:
        """Nearest-rank percentile over ONLY the most recent
        ``window_limit`` samples — always exact; 0.0 on an empty ring."""
        with self._lock:
            n = len(self._window)
            if n == 0:
                return 0.0
            rank = min(n, max(1, math.ceil(q / 100.0 * n)))
            return sorted(self._window)[rank - 1]

    def window_quantiles(self, qs: Sequence[float] = (50, 90, 99),
                         ) -> Dict[str, float]:
        with self._lock:
            ordered = sorted(self._window)
        n = len(ordered)
        out: Dict[str, float] = {}
        for q in qs:
            key = f"p{int(q) if float(q).is_integer() else q}"
            if n == 0:
                out[key] = 0.0
            else:
                out[key] = ordered[min(n, max(1, math.ceil(q / 100.0 * n))) - 1]
        return out

    def window_mean(self) -> float:
        with self._lock:
            return (sum(self._window) / len(self._window)
                    if self._window else 0.0)

    def reset(self) -> None:
        """Drop every observation (bench: discard the warmup/compile window
        so percentiles describe only the measured run)."""
        with self._lock:
            self._counts = [0] * len(self._counts)
            self._samples = []
            self._sorted = None
            self.count = 0
            self.sum = 0.0
            self._min = math.inf
            self._max = -math.inf
            self._window.clear()

    # -- mergeable state (the fleet-observability wire format) --------------
    def state_dict(self) -> Dict[str, Any]:
        """Serializable snapshot of the FULL histogram state — bucket
        geometry, bucket counts, the raw-sample list while still exact
        (None once degraded), and the recent-sample window.  JSON-safe
        (no infinities: min/max are None on an empty histogram); the
        payload the ``metrics_pull`` wire op ships and
        :meth:`merge` / :meth:`from_state` consume."""
        with self._lock:
            return {
                "name": self.name,
                "lo": self._lo,
                "growth": self._growth,
                "counts": list(self._counts),
                "samples": (None if self._samples is None
                            else list(self._samples)),
                "count": self.count,
                "sum": self.sum,
                "min": None if self.count == 0 else self._min,
                "max": None if self.count == 0 else self._max,
                "exact_limit": self.exact_limit,
                "window": list(self._window),
                "window_limit": self._window.maxlen,
            }

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "Histogram":
        """Rebuild a histogram from :meth:`state_dict` output (the
        collector side of the pull).  Bucket geometry is restored exactly
        from the state — never re-derived from ``hi`` — so a
        round-tripped histogram merges cleanly with its source."""
        h = cls(str(state.get("name", "restored")),
                lo=float(state["lo"]), growth=float(state["growth"]),
                exact_limit=int(state.get("exact_limit", 4096)),
                window_limit=int(state.get("window_limit") or 512))
        with h._lock:
            h._counts = [int(c) for c in state["counts"]]
            samples = state.get("samples")
            h._samples = None if samples is None \
                else [float(v) for v in samples]
            h._sorted = None
            h.count = int(state["count"])
            h.sum = float(state["sum"])
            h._min = math.inf if state.get("min") is None \
                else float(state["min"])
            h._max = -math.inf if state.get("max") is None \
                else float(state["max"])
            h._window.extend(float(v) for v in state.get("window") or ())
        return h

    def merge(self, other) -> "Histogram":
        """Fold another histogram (or a :meth:`state_dict` payload) into
        this one, in place.  The fleet rollup primitive.

        Quantile error bound: while BOTH sides are exact and the combined
        sample count fits ``exact_limit``, the merged histogram keeps the
        pooled raw samples, and quantiles stay exact (identical to
        observing every sample on one histogram).  Past that the merge
        degrades to bucket counts — bucket-wise addition over an identical
        geometry gives exactly the bucket counts the pooled sample stream
        would have produced, and the geometric-midpoint estimate over a
        log-``growth`` bucket is within ``sqrt(growth)`` relative error of
        any sample inside it.  Merging therefore degrades NO WORSE than
        the single-histogram bound: relative quantile error <=
        ``sqrt(growth)`` (the bucket bound), plus nearest-rank's half-sample
        rank slack — merging adds no error of its own.  The min/max clamp
        stays exact (min/max combine losslessly).

        Requires identical bucket geometry ``(lo, growth, n_buckets)`` —
        merging mismatched bases would smear counts across bucket edges
        unboundedly, so it raises ``ValueError`` instead.  The recent-
        sample window is a best-effort union bounded by the ring size
        (windowed views are per-process drift signals, not a merge
        surface).  Commutative and associative in distribution: bucket
        counts, count/sum/min/max, and exactness are order-independent.
        Returns ``self``.
        """
        state = other.state_dict() if isinstance(other, Histogram) else other
        with self._lock:
            if (abs(float(state["lo"]) - self._lo) > 1e-12 * self._lo
                    or abs(float(state["growth"]) - self._growth) > 1e-12
                    or len(state["counts"]) != len(self._counts)):
                raise ValueError(
                    f"histogram merge requires identical bucket geometry: "
                    f"{self.name} has (lo={self._lo}, growth={self._growth}, "
                    f"buckets={len(self._counts)}), other has "
                    f"(lo={state['lo']}, growth={state['growth']}, "
                    f"buckets={len(state['counts'])})")
            o_count = int(state["count"])
            if o_count == 0:
                return self
            for i, c in enumerate(state["counts"]):
                self._counts[i] += int(c)
            self.count += o_count
            self.sum += float(state["sum"])
            if state.get("min") is not None:
                self._min = min(self._min, float(state["min"]))
            if state.get("max") is not None:
                self._max = max(self._max, float(state["max"]))
            o_samples = state.get("samples")
            if (self._samples is not None and o_samples is not None
                    and len(self._samples) + len(o_samples)
                    <= self.exact_limit):
                self._samples.extend(float(v) for v in o_samples)
                self._sorted = None
            else:
                self._samples = None  # either side degraded, or over cap
                self._sorted = None
            self._window.extend(float(v) for v in state.get("window") or ())
        return self

    def __repr__(self) -> str:
        return (f"Histogram({self.name}: n={self.count} mean={self.mean:.4g} "
                f"p50={self.percentile(50):.4g})")


class _NullCounter:
    __slots__ = ()
    name = "null"
    value = 0

    def inc(self, n: int = 1) -> None:
        pass

    add = inc

    def set(self, v) -> None:
        pass


class _NullGauge:
    __slots__ = ()
    name = "null"
    value = 0.0

    def set(self, v) -> None:
        pass


class _NullHistogram:
    __slots__ = ()
    name = "null"
    count = 0
    sum = 0.0
    mean = 0.0
    min = 0.0
    max = 0.0
    exact = True
    window_count = 0

    def observe(self, v) -> None:
        pass

    def percentile(self, q: float) -> float:
        return 0.0

    def quantiles(self, qs: Sequence[float] = (50, 90, 99)) -> Dict[str, float]:
        return {f"p{int(q) if float(q).is_integer() else q}": 0.0 for q in qs}

    def window_percentile(self, q: float) -> float:
        return 0.0

    def window_quantiles(self, qs: Sequence[float] = (50, 90, 99)) -> Dict[str, float]:
        return {f"p{int(q) if float(q).is_integer() else q}": 0.0 for q in qs}

    def window_mean(self) -> float:
        return 0.0

    def reset(self) -> None:
        pass


NULL_COUNTER = _NullCounter()
NULL_GAUGE = _NullGauge()
NULL_HISTOGRAM = _NullHistogram()


class RateView:
    """Windowed rate over a cumulative counter: a ring of recent
    ``(time, value)`` samples turns a lifetime total into the signal drift
    detection actually needs — the recent first derivative.  ``sample(now)``
    appends one observation and returns the rate (units/second) across the
    ring's span; the first sample returns 0.0 (no span yet).  Counter
    resets (value going backwards, e.g. an engine rebuild re-registering
    fresh counters) restart the ring instead of reporting a negative rate.

    Works over anything with a numeric ``.value`` (Counter, Gauge, or a
    null singleton — the disabled path stays a cheap no-op that always
    reads 0.0).
    """

    __slots__ = ("source", "_lock", "_ring")

    def __init__(self, source, window: int = 8):
        self.source = source
        self._lock = threading.Lock()
        self._ring: "deque[Tuple[float, float]]" = deque(
            maxlen=max(2, int(window)))

    def sample(self, now: float) -> float:
        v = float(self.source.value)
        with self._lock:
            if self._ring and v < self._ring[-1][1]:
                self._ring.clear()  # counter reset: restart the window
            self._ring.append((float(now), v))
            t0, v0 = self._ring[0]
            t1, v1 = self._ring[-1]
        dt = t1 - t0
        return (v1 - v0) / dt if dt > 0 else 0.0

    def delta(self) -> float:
        """Value change across the current ring (no new sample taken)."""
        with self._lock:
            if len(self._ring) < 2:
                return 0.0
            return self._ring[-1][1] - self._ring[0][1]

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()


class MetricsRegistry:
    """Named metrics + structured-event sink.

    ``enabled=False`` is the near-zero-cost path: ``gauge()``/``histogram()``
    hand back shared no-op singletons, ``snapshot()`` is empty and
    ``event()`` returns immediately.  ``counter()`` always returns a live
    counter — see the module docstring for why.
    """

    def __init__(self, enabled: bool = True, jsonl_path: Optional[str] = None,
                 exact_limit: int = 4096, time_fn=time.time):
        self.enabled = bool(enabled)
        self.jsonl_path = jsonl_path if self.enabled else None
        self.exact_limit = exact_limit
        self._time = time_fn
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        # claimed metric namespaces ("serve", "serve2", ...) — owned by
        # self._lock so claim/release/drop are one atomic step
        self._prefixes: set = set()
        # the JSONL sink serializes on its own lock: metric reads/writes
        # must never wait on disk
        self._sink_lock = threading.Lock()
        self._jsonl = None

    # -- metric handles -----------------------------------------------------
    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str):
        if not self.enabled:
            return NULL_GAUGE
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str, **kw):
        if not self.enabled:
            return NULL_HISTOGRAM
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                kw.setdefault("exact_limit", self.exact_limit)
                h = self._histograms[name] = Histogram(name, **kw)
            return h

    def get(self, name: str):
        """Existing metric by name (any kind), or None."""
        with self._lock:
            return (self._counters.get(name) or self._gauges.get(name)
                    or self._histograms.get(name))

    # -- export -------------------------------------------------------------
    def snapshot(self, step: int = 0) -> List[Event]:
        """Flatten every metric to ``(label, value, step)`` events — the
        exact shape ``MonitorMaster.write_events`` consumes.  Histograms
        export count/mean/p50/p90/p99 sub-labels.  Empty when disabled."""
        if not self.enabled:
            return []
        with self._lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            hists = list(self._histograms.items())
        events: List[Event] = []
        for name, c in sorted(counters):
            events.append((name, float(c.value), step))
        for name, g in sorted(gauges):
            events.append((name, g.value, step))
        for name, h in sorted(hists):
            if h.count == 0:
                continue
            events.append((f"{name}/count", float(h.count), step))
            events.append((f"{name}/mean", h.mean, step))
            for q in (50, 90, 99):
                events.append((f"{name}/p{q}", h.percentile(q), step))
        return events

    def export_state(self, prefixes: Optional[Sequence[str]] = None
                     ) -> Dict[str, Any]:
        """Serializable MERGEABLE snapshot of the registry: counter values,
        gauge values, and full histogram states (:meth:`Histogram.state_dict`
        — bucket counts + raw samples while exact), optionally filtered to
        metrics under ``prefixes`` (each matching ``p`` or ``p/...``).
        This is the ``metrics_pull`` wire payload; unlike :meth:`snapshot`
        (pre-computed quantile sub-labels, lossy), the receiving side can
        MERGE these across workers and still compute fleet-true quantiles.
        Counters export even when disabled (they always count); gauges and
        histograms only exist when enabled.  The per-metric locks make each
        metric's state internally consistent; the registry lock makes the
        table listing atomic — a pull racing live observes sees a torn
        *set* of fresh values, never a torn metric."""
        with self._lock:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            hists = list(self._histograms.items())
        if prefixes is not None:
            pats = tuple(prefixes)

            def _keep(name: str) -> bool:
                return any(name == p or name.startswith(p + "/")
                           for p in pats)

            counters = [(n, c) for n, c in counters if _keep(n)]
            gauges = [(n, g) for n, g in gauges if _keep(n)]
            hists = [(n, h) for n, h in hists if _keep(n)]
        return {
            "counters": {n: c.value for n, c in sorted(counters)},
            "gauges": {n: g.value for n, g in sorted(gauges)},
            "histograms": {n: h.state_dict() for n, h in sorted(hists)},
        }

    # -- namespaces ---------------------------------------------------------
    def _claim_locked(self, prefixes: Sequence[str]) -> List[str]:
        """Smallest shared suffix at which EVERY prefix in the group is
        free (caller holds the lock): bare names first, then ``2``, ``3``,
        ... — the suffix is shared so paired namespaces (an engine's
        ``serve``/``sched``/``comm``) can never interleave into a
        mismatched pairing under concurrent construction."""
        i = 1
        while True:
            suffix = "" if i == 1 else str(i)
            cand = [p + suffix for p in prefixes]
            if all(c not in self._prefixes for c in cand):
                self._prefixes.update(cand)
                return cand
            i += 1

    def claim_prefix(self, prefix: str) -> str:
        """Unique metric namespace for one owner (``serve`` -> ``serve``,
        then ``serve2``, ``serve3``, ...).  Atomic under the registry
        lock."""
        with self._lock:
            return self._claim_locked((prefix,))[0]

    def claim_prefixes(self, prefixes: Sequence[str]) -> List[str]:
        """Claim a GROUP of namespaces atomically with one shared suffix
        (``("serve", "sched")`` -> ``["serve2", "sched2"]``): an engine's
        paired namespaces stay paired no matter how many engines are being
        constructed concurrently on the shared instance."""
        with self._lock:
            return self._claim_locked(prefixes)

    def release_prefix(self, prefix: str, drop_metrics: bool = True) -> int:
        """Return a claimed namespace and (by default) drop its metrics —
        ONE atomic step under the registry lock, so a concurrent claimant
        reclaiming the name cannot register fresh metrics into the window
        between the release and the sweep (they would be swept with the
        dead engine's).  Returns how many metrics were dropped."""
        with self._lock:
            self._prefixes.discard(prefix)
            return self._drop_prefix_locked(prefix + "/") if drop_metrics \
                else 0

    def _drop_prefix_locked(self, prefix: str) -> int:
        n = 0
        for table in (self._counters, self._gauges, self._histograms):
            stale = [k for k in table if k.startswith(prefix)]
            n += len(stale)
            for k in stale:
                del table[k]
        return n

    def drop_prefix(self, prefix: str) -> int:
        """Delete every metric whose name starts with ``prefix`` (e.g.
        ``"serve/"``).  The namespace-release half of engine teardown: a
        later engine reclaiming the namespace re-registers FRESH metrics
        instead of inheriting a dead engine's counts into its stats view.
        Returns how many metrics were dropped."""
        with self._lock:
            return self._drop_prefix_locked(prefix)

    def reset_histograms(self) -> None:
        """Drop every histogram's observations (counters/gauges keep their
        values — they are baselined by differencing, not by windowing)."""
        with self._lock:
            hists = list(self._histograms.values())
        for h in hists:
            h.reset()

    def event(self, name: str, **fields) -> None:
        """Append one structured event to the JSONL sink (no-op when
        disabled or no ``jsonl_path`` was configured)."""
        if not self.enabled or self.jsonl_path is None:
            return
        rec = {"ts": self._time(), "event": name}
        rec.update(fields)
        line = json.dumps(rec, default=str)
        # the sink lock guards ONLY the file handle: lines from concurrent
        # threads must not interleave mid-record, and that serialization
        # necessarily spans the write — hence the documented allows.  The
        # metrics lock is never held here, so counter/snapshot traffic
        # proceeds while a record is on its way to disk.
        with self._sink_lock:
            if self._jsonl is None:
                self._jsonl = open(self.jsonl_path, "a", buffering=1)  # lint: allow(blocking-under-lock)
            self._jsonl.write(line + "\n")  # lint: allow(blocking-under-lock)

    def close(self) -> None:
        # detach under the sink lock, close OUTSIDE it: a slow fsync must
        # not stall a concurrent event() (which will simply reopen-append)
        with self._sink_lock:
            fh, self._jsonl = self._jsonl, None
        if fh is not None:
            fh.close()


class StatsView(MutableMapping):
    """Dict-shaped read-through view over ``{key: Counter}``.

    The engines' legacy ``stats`` dicts become this view after the counter
    migration: reads return the live counter values, writes set them
    (supporting external ``stats[k] += n`` compat), iteration preserves the
    registration order so ``dict(stats)`` looks exactly like the old dict.
    """

    __slots__ = ("_c",)

    def __init__(self, counters: Dict[str, Counter]):
        self._c = counters

    def __getitem__(self, key: str):
        return self._c[key].value

    def __setitem__(self, key: str, value) -> None:
        self._c[key].set(value)

    def __delitem__(self, key: str) -> None:
        raise TypeError("stats keys are fixed; counters cannot be deleted")

    def __iter__(self) -> Iterator[str]:
        return iter(self._c)

    def __len__(self) -> int:
        return len(self._c)

    def __repr__(self) -> str:
        return repr(dict(self))


def percentile_summary(
    registry: MetricsRegistry,
    names: Sequence[str],
    qs: Sequence[float] = (50, 90, 99),
) -> Dict[str, Dict[str, float]]:
    """{short_label: {count, mean, p50, ...}} for the histograms in
    ``names`` that exist and have observations (absent/empty ones are
    skipped, so a speculation-off run simply has no accept-rate row)."""
    out: Dict[str, Dict[str, float]] = {}
    for name in names:
        h = registry.get(name)
        if h is None or not isinstance(h, Histogram) or h.count == 0:
            continue
        row = {"count": float(h.count), "mean": h.mean}
        row.update(h.quantiles(qs))
        out[name.rsplit("/", 1)[-1]] = row
    return out


def window_percentile_summary(
    registry: MetricsRegistry,
    names: Sequence[str],
    qs: Sequence[float] = (50, 90, 99),
) -> Dict[str, Dict[str, float]]:
    """``percentile_summary`` over the WINDOWED views: quantiles of only
    each histogram's recent-sample ring (steady-state tables, controller
    epoch snapshots).  Absent/empty-window histograms are skipped."""
    out: Dict[str, Dict[str, float]] = {}
    for name in names:
        h = registry.get(name)
        if h is None or not isinstance(h, Histogram) or h.window_count == 0:
            continue
        row = {"count": float(h.window_count), "mean": h.window_mean()}
        row.update(h.window_quantiles(qs))
        out[name.rsplit("/", 1)[-1]] = row
    return out


def format_percentile_table(
    summary: Dict[str, Dict[str, float]], title: str = "latency percentiles"
) -> str:
    """Fixed-width text table of a ``percentile_summary`` result."""
    if not summary:
        return f"{title}: (no observations)"
    qcols = [k for k in next(iter(summary.values())) if k.startswith("p")]
    cols = ["count", "mean"] + qcols
    width = max(len(k) for k in summary) + 2
    lines = [title, "  " + "metric".ljust(width) + "".join(c.rjust(10) for c in cols)]
    for label, row in summary.items():
        cells = "".join(f"{row[c]:10.2f}" for c in cols)
        lines.append("  " + label.ljust(width) + cells)
    return "\n".join(lines)
