"""Tick spans + per-request traces + Chrome trace-event export — the port
of ``deepspeed_tpu/telemetry/tracing.py``, with the same names and trace
layout.

The timeline half of the unified telemetry layer (registry.py holds the
aggregates).  Three pieces:

- :class:`TraceRecorder` — named spans around engine dispatches
  (``decode_tick``, ``spec_tick``, ``prefill_pack``, ``decode_burst``,
  ``train_batch``).  A span that ends with a host-side result fetch records
  an exact duration.  A span whose dispatch the host does not wait for
  ends with ``sync_obj=`` instead: on CUDA a ``torch.cuda.Event`` recorded
  on the dispatch's stream.  The dispatch wall time is recorded NOW, the
  device reading is deferred to ``flush()`` — which waits on each event
  once per window, spreads the window's device time across its spans and
  emits one aggregated ``<track>-device`` event per flush.  A CUDA error
  surfacing in that wait raises: it is never swallowed.  An object
  without ``synchronize()`` (a CPU tensor) is ready at once.
- :class:`RequestTrace` — the host-side lifecycle of one serve request:
  submit -> admit (queue wait) -> prefill chunks -> token emissions ->
  preemptions -> finish.  TTFT / per-token TBT / queue wait / accept rate
  derive from it into the registry histograms at the moment each becomes
  known.
- Chrome trace-event export (``chrome_trace``): spans and request traces
  flatten to ``ph:"X"`` complete events (µs timestamps, one tid per
  track / per request uid), loadable in Perfetto (https://ui.perfetto.dev)
  or chrome://tracing.  Events are strictly ordered per track.

:class:`Telemetry` is the facade the engines hold: registry + recorder +
request-trace bookkeeping + the optional step annotation (the config key
keeps JAX's name, ``jax_profiler``: here it opens a
``torch.profiler.record_function`` range, and an NVTX range on CUDA, under
JAX's step label), with every path collapsing to shared no-op singletons
when disabled.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .registry import MetricsRegistry, StatsView  # noqa: F401 (re-export)


class Span:
    """One recorded dispatch.  ``t_end`` is set by a host-synced ``end()``;
    deferred spans carry ``sync_obj`` until the recorder's ``flush()``
    resolves them (``t_ready`` + ``device_ms``)."""

    __slots__ = ("name", "track", "t0", "t_dispatch", "t_end", "t_ready",
                 "device_ms", "args", "_sync", "_hist", "_rec")

    def __init__(self, rec: "TraceRecorder", name: str, track: str,
                 hist, args: Dict[str, Any]):
        self._rec = rec
        self.name = name
        self.track = track
        self._hist = hist
        self.args = args
        self.t0 = rec._clock()
        self.t_dispatch: Optional[float] = None
        self.t_end: Optional[float] = None
        self.t_ready: Optional[float] = None
        self.device_ms: Optional[float] = None
        self._sync = None

    def dispatched(self) -> None:
        """Mark the async dispatch call as returned (host work continues —
        e.g. a result fetch — before ``end()``)."""
        if self.t_dispatch is None:
            self.t_dispatch = self._rec._clock()

    def end(self, sync_obj=None, **args) -> "Span":
        """Close the span.  With ``sync_obj`` the host read is DEFERRED:
        only the dispatch time is taken now; ``flush()`` blocks on the
        object later.  Without it the span is host-complete and its
        duration (and ``hist`` observation) is exact."""
        now = self._rec._clock()
        if args:
            self.args.update(args)
        if sync_obj is not None:
            if self.t_dispatch is None:
                self.t_dispatch = now
            self._sync = sync_obj
        else:
            if self.t_dispatch is None:
                self.t_dispatch = now
            self.t_end = now
            if self._hist is not None:
                self._hist.observe((self.t_end - self.t0) * 1e3)
        self._rec._append(self, pending=sync_obj is not None)
        return self

    @property
    def duration_ms(self) -> Optional[float]:
        if self.t_end is not None:
            return (self.t_end - self.t0) * 1e3
        if self.t_dispatch is not None:
            return (self.t_dispatch - self.t0) * 1e3
        return None


class _NullSpan:
    __slots__ = ()

    def dispatched(self) -> None:
        pass

    def end(self, sync_obj=None, **args) -> "_NullSpan":
        return self

    duration_ms = None


NULL_SPAN = _NullSpan()


def device_ready(ready):
    """The ``sync_obj`` of a deferred span over work that produced
    ``ready``: a ``torch.cuda.Event`` recorded now on the current stream
    when ``ready`` is a CUDA tensor, else ``ready`` itself (ready at once)."""
    import torch

    if not (isinstance(ready, torch.Tensor) and ready.is_cuda):
        return ready
    ev = torch.cuda.Event()
    ev.record()
    return ev


class TraceRecorder:
    """Bounded span store + deferred device-reading resolver."""

    def __init__(self, enabled: bool = True, max_spans: int = 65536,
                 clock=time.perf_counter):
        self.enabled = bool(enabled)
        self._clock = clock
        self._lock = threading.Lock()
        self._spans: "deque[Span]" = deque(maxlen=max_spans)
        self._pending: List[Span] = []
        # synthetic per-flush device-window events for the chrome export
        self._device_windows: "deque[Dict[str, Any]]" = deque(maxlen=4096)
        self._last_ready: Dict[str, float] = {}
        self.dropped = 0
        # incremental-export watermarks (the fleet metrics_pull drains span
        # events in batches without disturbing the full chrome export) plus
        # a PERSISTENT track->tid map so tids stay stable across batches
        self._appended_total = 0
        self._drained_spans = 0
        self._windows_total = 0
        self._drained_windows = 0
        self._drain_tids: Dict[str, int] = {}

    def start(self, name: str, track: str = "default", hist=None, **args):
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, track, hist, args)

    def _append(self, span: Span, pending: bool) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1  # no silent cap: surfaced in chrome args
            self._spans.append(span)
            self._appended_total += 1
            if pending:
                self._pending.append(span)
                return
            # A host-complete end on this track bounds every deferred span
            # dispatched before it: the device stream is serialized, so the
            # fetch that just returned implies those dispatches finished.
            # Resolve them NOW with a tick-tight window ending at the
            # bounding span's START — its own [t0, t_end] is already
            # attributed to its own histogram, and waiting for the
            # end-of-run flush would smear the whole run across them.
            if self._pending and span.t_end is not None:
                same = [sp for sp in self._pending if sp.track == span.track]
                if same:
                    self._pending = [sp for sp in self._pending
                                     if sp.track != span.track]
                    self._resolve_locked(same, span.t0)

    def __len__(self) -> int:
        return len(self._spans)

    def flush(self) -> None:
        """Resolve every deferred device reading still pending: wait once
        on each sync object (dispatch order), then spread the window's
        device time evenly across its spans — the per-span figure is a
        window average, same contract as the engine's async
        ``ThroughputTimer`` window.  Spans a later host-complete span
        already bounded (see ``_append``) are resolved there and never
        reach this path."""
        with self._lock:
            pending, self._pending = self._pending, []
        if not pending:
            return
        for sp in pending:
            # a CUDA event (the engines' deferred dispatches); a CPU
            # object is ready at once.  A device error raises here.
            wait = getattr(sp._sync, "synchronize", None)
            if wait is not None:
                wait()
        now = self._clock()
        with self._lock:
            self._resolve_locked(pending, now)

    def _resolve_locked(self, pending: List[Span], now: float) -> None:
        """Settle deferred spans (caller holds the lock): window time since
        the track's last resolution spreads evenly across its spans, one
        synthetic ``<track>-device`` window event per track."""
        by_track: Dict[str, List[Span]] = {}
        for sp in pending:
            by_track.setdefault(sp.track, []).append(sp)
        for track, group in by_track.items():
            start = max(group[0].t0, self._last_ready.get(track, group[0].t0))
            total_ms = max(now - start, 0.0) * 1e3
            per_ms = total_ms / len(group)
            for sp in group:
                sp.t_ready = now
                sp.device_ms = per_ms
                sp._sync = None
                if sp._hist is not None:
                    sp._hist.observe(per_ms)
            self._last_ready[track] = now
            self._windows_total += 1
            self._device_windows.append({
                "name": f"{group[0].name} window ({len(group)} dispatches)",
                "track": f"{track}-device",
                "t0": start,
                "dur": total_ms / 1e3,
                "args": {"dispatches": len(group),
                         "per_dispatch_ms": round(per_ms, 3)},
            })

    @staticmethod
    def _span_event(s: Span, pid: int, tid: int) -> Dict[str, Any]:
        dur = s.duration_ms
        args = dict(s.args)
        if s.t_dispatch is not None:
            args["dispatch_ms"] = round((s.t_dispatch - s.t0) * 1e3, 3)
        if s.device_ms is not None:
            args["device_window_avg_ms"] = round(s.device_ms, 3)
        return {
            "name": s.name, "ph": "X", "pid": pid, "tid": tid,
            "ts": s.t0 * 1e6, "dur": (dur or 0.0) * 1e3, "args": args,
        }

    def chrome_events(self, pid: int = 0) -> List[Dict[str, Any]]:
        with self._lock:
            spans = list(self._spans)
            windows = list(self._device_windows)
        tracks = sorted({s.track for s in spans} | {w["track"] for w in windows})
        tid_of = {t: i + 1 for i, t in enumerate(tracks)}
        events: List[Dict[str, Any]] = []
        for t, tid in tid_of.items():
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": t}})
        for s in spans:
            events.append(self._span_event(s, pid, tid_of[s.track]))
        for w in windows:
            events.append({
                "name": w["name"], "ph": "X", "pid": pid,
                "tid": tid_of[w["track"]], "ts": w["t0"] * 1e6,
                "dur": w["dur"] * 1e6, "args": w["args"],
            })
        return events

    def drain_chrome_events(self, pid: int = 0) -> List[Dict[str, Any]]:
        """Span/window events appended since the LAST drain — the
        incremental batch a fleet ``metrics_pull`` returns.  Non-
        destructive (the full :meth:`chrome_events` export is unchanged);
        watermarks track how many events each consumer has seen, and the
        track->tid map is persistent so tids stay stable across batches.
        A still-deferred span exports its dispatch-side wall duration (the
        device window resolves later as its own additive event).  No
        device sync and no I/O happen here — pure state under the lock."""
        with self._lock:
            new_spans = self._appended_total - self._drained_spans
            spans = list(self._spans)[-new_spans:] if new_spans else []
            self._drained_spans = self._appended_total
            new_w = self._windows_total - self._drained_windows
            windows = list(self._device_windows)[-new_w:] if new_w else []
            self._drained_windows = self._windows_total
            events: List[Dict[str, Any]] = []
            for t in {s.track for s in spans} | {w["track"] for w in windows}:
                if t not in self._drain_tids:
                    self._drain_tids[t] = len(self._drain_tids) + 1
                    events.append({"name": "thread_name", "ph": "M",
                                   "pid": pid, "tid": self._drain_tids[t],
                                   "args": {"name": t}})
            for s in spans:
                events.append(self._span_event(s, pid, self._drain_tids[s.track]))
            for w in windows:
                events.append({
                    "name": w["name"], "ph": "X", "pid": pid,
                    "tid": self._drain_tids[w["track"]], "ts": w["t0"] * 1e6,
                    "dur": w["dur"] * 1e6, "args": w["args"],
                })
        return events


class RequestTrace:
    """Lifecycle record of one serve request (host wall clock).

    Methods are called by the ``ServeScheduler`` at the matching lifecycle
    points; each derived quantity is observed into the owning
    :class:`Telemetry`'s histograms the moment it becomes known."""

    __slots__ = ("uid", "_tel", "_h", "prompt_tokens", "submit_ts",
                 "admit_ts", "first_token_ts", "last_emit_ts", "finish_ts",
                 "readmits", "preemptions", "tokens_emitted", "drafted",
                 "accepted", "chunks", "emissions", "preempt_ts", "outcome",
                 "ns")

    def __init__(self, tel: "Telemetry", uid: int, prompt_tokens: int = 0,
                 hists: Optional[Dict[str, Any]] = None, ns: str = "serve"):
        self._tel = tel
        self._h = hists if hists is not None else tel.request_hists("serve")
        self.ns = ns
        self.uid = uid
        self.prompt_tokens = prompt_tokens
        self.submit_ts: Optional[float] = None
        self.admit_ts: Optional[float] = None
        self.first_token_ts: Optional[float] = None
        self.last_emit_ts: Optional[float] = None
        self.finish_ts: Optional[float] = None
        self.readmits = 0
        self.preemptions = 0
        self.tokens_emitted = 0
        self.drafted = 0
        self.accepted = 0
        self.chunks: List[Tuple[float, float, int]] = []
        self.emissions: List[Tuple[float, int]] = []
        self.preempt_ts: List[float] = []
        self.outcome: str = "finished"  # terminal state label (typed)

    # -- lifecycle ----------------------------------------------------------
    def submitted(self, prompt_tokens: Optional[int] = None) -> None:
        if prompt_tokens is not None:
            self.prompt_tokens = prompt_tokens
        self.submit_ts = self._tel.clock()

    def admitted(self) -> None:
        now = self._tel.clock()
        if self.admit_ts is None:
            self.admit_ts = now
            if self.submit_ts is not None:
                self._h["queue_wait"].observe((now - self.submit_ts) * 1e3)
        else:
            self.readmits += 1

    def prefill_chunk(self, t0: float, t1: float, n_tokens: int) -> None:
        self.chunks.append((t0, t1, n_tokens))

    def tokens(self, n: int) -> None:
        """``n`` tokens emitted for this request in one tick."""
        if n <= 0:
            return
        now = self._tel.clock()
        self.tokens_emitted += n
        self.emissions.append((now, n))
        if self.first_token_ts is None:
            self.first_token_ts = now
            if self.submit_ts is not None:
                self._h["ttft"].observe((now - self.submit_ts) * 1e3)
        else:
            # a spec tick emits several tokens at one instant: the tick gap
            # amortizes across them (per-token time between tokens)
            gap_ms = (now - self.last_emit_ts) / n * 1e3
            for _ in range(n):
                self._h["tbt"].observe(gap_ms)
        self.last_emit_ts = now

    def preempted(self) -> None:
        self.preemptions += 1
        self.preempt_ts.append(self._tel.clock())

    def add_spec(self, drafted: int, accepted: int) -> None:
        """Fold a sequence incarnation's draft/accept totals in — called
        just before the descriptor is released (finish AND preemption),
        since preemption-by-recompute starts the next incarnation at 0."""
        self.drafted += drafted
        self.accepted += accepted

    def finished(self, outcome: str = "finished") -> None:
        """Terminal transition.  ``outcome`` is the typed terminal state
        (``finished`` / ``failed`` / ``timed_out`` / ``cancelled``) — it
        rides the summary event and shows as a marker on the request's
        Chrome-trace track, so deadline/cancel storms are visible per uid."""
        self.outcome = outcome
        self.finish_ts = self._tel.clock()
        self._tel._finish_request(self)

    # -- derived ------------------------------------------------------------
    @property
    def ttft_ms(self) -> Optional[float]:
        if self.first_token_ts is None or self.submit_ts is None:
            return None
        return (self.first_token_ts - self.submit_ts) * 1e3

    @property
    def queue_wait_ms(self) -> Optional[float]:
        if self.admit_ts is None or self.submit_ts is None:
            return None
        return (self.admit_ts - self.submit_ts) * 1e3

    @property
    def e2e_ms(self) -> Optional[float]:
        if self.finish_ts is None or self.submit_ts is None:
            return None
        return (self.finish_ts - self.submit_ts) * 1e3

    @property
    def tbt_gaps_ms(self) -> List[float]:
        """Per-token inter-emission gaps (tick gap / tokens in the tick)."""
        out: List[float] = []
        for i in range(1, len(self.emissions)):
            t_prev = self.emissions[i - 1][0]
            t, n = self.emissions[i]
            out.extend([(t - t_prev) / n * 1e3] * n)
        return out

    @property
    def accept_rate(self) -> Optional[float]:
        if self.drafted == 0:
            return None
        return self.accepted / self.drafted

    def summary(self) -> Dict[str, Any]:
        return {
            "uid": self.uid,
            "outcome": self.outcome,
            "prompt_tokens": self.prompt_tokens,
            "tokens_emitted": self.tokens_emitted,
            "queue_wait_ms": self.queue_wait_ms,
            "ttft_ms": self.ttft_ms,
            "e2e_ms": self.e2e_ms,
            "preemptions": self.preemptions,
            "readmits": self.readmits,
            "prefill_chunks": len(self.chunks),
            "drafted": self.drafted,
            "accepted": self.accepted,
            "accept_rate": self.accept_rate,
        }

    def chrome_events(self, pid: int = 1) -> List[Dict[str, Any]]:
        tid = self.uid
        evs: List[Dict[str, Any]] = [{
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": f"request {self.uid}"},
        }]
        if self.submit_ts is not None and self.admit_ts is not None:
            evs.append({"name": "queued", "ph": "X", "pid": pid, "tid": tid,
                        "ts": self.submit_ts * 1e6,
                        "dur": (self.admit_ts - self.submit_ts) * 1e6,
                        "args": {"prompt_tokens": self.prompt_tokens}})
        for t0, t1, n in self.chunks:
            evs.append({"name": "prefill_chunk", "ph": "X", "pid": pid,
                        "tid": tid, "ts": t0 * 1e6, "dur": (t1 - t0) * 1e6,
                        "args": {"tokens": n}})
        for i, (t, n) in enumerate(self.emissions):
            evs.append({"name": "first_token" if i == 0 else "emit",
                        "ph": "X", "pid": pid, "tid": tid, "ts": t * 1e6,
                        "dur": 0.0, "args": {"tokens": n}})
        for t in self.preempt_ts:
            evs.append({"name": "preempted", "ph": "X", "pid": pid,
                        "tid": tid, "ts": t * 1e6, "dur": 0.0, "args": {}})
        if self.finish_ts is not None and self.outcome != "finished":
            # non-FINISHED terminals (failed/timed_out/cancelled) get an
            # explicit marker so chaos runs read directly off the timeline
            evs.append({"name": self.outcome, "ph": "X", "pid": pid,
                        "tid": tid, "ts": self.finish_ts * 1e6, "dur": 0.0,
                        "args": {}})
        return evs


class _NullRequestTrace:
    __slots__ = ()
    uid = -1
    outcome = "finished"
    prompt_tokens = 0
    tokens_emitted = 0
    preemptions = 0
    readmits = 0
    drafted = 0
    accepted = 0
    ttft_ms = None
    queue_wait_ms = None
    e2e_ms = None
    accept_rate = None

    def submitted(self, prompt_tokens=None) -> None:
        pass

    def admitted(self) -> None:
        pass

    def prefill_chunk(self, t0, t1, n_tokens) -> None:
        pass

    def tokens(self, n) -> None:
        pass

    def preempted(self) -> None:
        pass

    def add_spec(self, drafted, accepted) -> None:
        pass

    def finished(self, outcome="finished") -> None:
        pass

    def summary(self) -> Dict[str, Any]:
        return {}


NULL_REQUEST_TRACE = _NullRequestTrace()


def _strictly_order(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Sort per (pid, tid) by ts and nudge exact µs ties forward by 1 µs —
    Perfetto tolerates ties, but a strictly ordered stream makes the
    per-track timeline unambiguous (and testable)."""
    by_track: Dict[Tuple[int, int], List[Dict[str, Any]]] = {}
    meta: List[Dict[str, Any]] = []
    for ev in events:
        if ev.get("ph") == "M":
            meta.append(ev)
            continue
        by_track.setdefault((ev["pid"], ev["tid"]), []).append(ev)
    out = list(meta)
    for track_events in by_track.values():
        track_events.sort(key=lambda e: e["ts"])
        last = -float("inf")
        for ev in track_events:
            ts = float(ev["ts"])
            if ts <= last:
                ts = last + 1.0
            ev["ts"] = ts
            last = ts
        out.extend(track_events)
    return out


class Telemetry:
    """Facade the engines hold: registry + recorder + request traces.

    Accepts a ``TelemetryConfig`` (duck-typed — anything with the knob
    attributes), a bool, another ``Telemetry`` (shared), or None
    (disabled).  Disabled still hands out live counters (the ``stats``
    contract) but every other surface is a shared no-op.
    """

    def __init__(self, config=None, *, enabled: Optional[bool] = None,
                 jsonl_path: Optional[str] = None,
                 chrome_trace_path: Optional[str] = None,
                 jax_profiler: Optional[bool] = None,
                 max_spans: Optional[int] = None,
                 exact_quantiles: Optional[int] = None,
                 clock=time.perf_counter):
        def knob(kw, attr, default):
            if kw is not None:
                return kw
            return getattr(config, attr, default) if config is not None else default

        if isinstance(config, bool):
            enabled = config if enabled is None else enabled
            config = None
        self.enabled = bool(knob(enabled, "enabled", False))
        self.jsonl_path = knob(jsonl_path, "jsonl_path", None)
        self.chrome_trace_path = knob(chrome_trace_path, "chrome_trace_path", None)
        self.jax_profiler = bool(knob(jax_profiler, "jax_profiler", False))
        self.clock = clock
        self.registry = MetricsRegistry(
            enabled=self.enabled, jsonl_path=self.jsonl_path,
            exact_limit=knob(exact_quantiles, "exact_quantiles", 4096),
        )
        self.recorder = TraceRecorder(
            enabled=self.enabled, max_spans=knob(max_spans, "max_spans", 65536),
            clock=clock,
        )
        self._traces: "deque[RequestTrace]" = deque(maxlen=4096)
        self.traces_dropped = 0
        self._lock = threading.Lock()
        self._req_hists: Dict[str, Dict[str, Any]] = {}
        # fleet-pull watermark over finished traces (incremental drain),
        # plus a persistent ns->pid map so drained batches keep stable pids
        self._traces_total = 0
        self._traces_drained = 0
        self._drain_req_pids: Dict[str, int] = {"serve": 1}
        self._exit_registered = False
        # serve-request histograms (no-op singletons when disabled); the
        # default "serve" group is also exposed as h_* attributes — a second
        # engine sharing this instance gets its own group via request_hists
        hs = self.request_hists("serve")
        self.h_ttft = hs["ttft"]
        self.h_tbt = hs["tbt"]
        self.h_queue_wait = hs["queue_wait"]
        self.h_e2e = hs["e2e"]
        self.h_accept = hs["accept"]

    @classmethod
    def ensure(cls, obj) -> "Telemetry":
        """Normalize a constructor argument into a ``Telemetry``: pass an
        instance through (shared), build from a config/bool, None ->
        disabled."""
        if isinstance(obj, cls):
            return obj
        return cls(obj)

    # -- counters / stats views --------------------------------------------
    def counters(self, prefix: str, keys: Sequence[str]):
        return {k: self.registry.counter(f"{prefix}/{k}") for k in keys}

    def claim_prefix(self, prefix: str) -> str:
        """Unique metric namespace for one owner.  A ``Telemetry`` instance
        is shared between an engine and its scheduler by design; if a
        SECOND engine is constructed on the same instance, its counters
        must not alias the first's (``stats`` would read merged totals) —
        the second claimant gets ``serve2/``, the third ``serve3/``, ...
        The map itself lives in the registry under the ONE registry lock
        (claim, release, and the metric drop riding a release are atomic
        against each other)."""
        return self.registry.claim_prefix(prefix)

    def claim_prefixes(self, prefixes: Sequence[str]) -> List[str]:
        """Claim a namespace GROUP atomically with one shared suffix —
        an engine's paired ``serve``/``sched``/``comm`` namespaces stay
        paired (``serve2`` with ``sched2``) even when several engines are
        constructed concurrently on a shared instance."""
        return self.registry.claim_prefixes(prefixes)

    def release_prefix(self, prefix: str, drop_metrics: bool = True) -> None:
        """Return a claimed namespace (engine teardown): the next claimant
        gets ``prefix`` back instead of ``prefix2``, ``prefix3``, ... —
        back-to-back autotuner trial engines sharing one ``Telemetry``
        would otherwise grow an unbounded namespace tail.  With
        ``drop_metrics`` the namespace's registry metrics are deleted too,
        so reclaimed names start from zero rather than inheriting a dead
        engine's counts — atomically with the release, so a concurrent
        claimant's fresh metrics can never be swept by this drop."""
        with self._lock:
            self._req_hists.pop(prefix, None)
        self.registry.release_prefix(prefix, drop_metrics=drop_metrics)

    # -- request traces -----------------------------------------------------
    def request_hists(self, ns: str) -> Dict[str, Any]:
        """The request-latency histogram group for one engine namespace
        (``serve``, ``serve2``, ...) — keeps a shared instance's engines
        from merging their TTFT/TBT distributions.  Memoized: the group is
        immutable per namespace and ``request_trace`` asks for it on every
        submission."""
        with self._lock:
            group = self._req_hists.get(ns)
            if group is not None:
                return group
        reg = self.registry
        group = {
            "ttft": reg.histogram(f"{ns}/ttft_ms"),
            "tbt": reg.histogram(f"{ns}/tbt_ms"),
            "queue_wait": reg.histogram(f"{ns}/queue_wait_ms"),
            "e2e": reg.histogram(f"{ns}/e2e_ms"),
            "accept": reg.histogram(f"{ns}/request_accept_rate"),
        }
        with self._lock:
            return self._req_hists.setdefault(ns, group)

    def request_trace(self, uid: int, prompt_tokens: int = 0,
                      ns: str = "serve"):
        if not self.enabled:
            return NULL_REQUEST_TRACE
        return RequestTrace(self, uid, prompt_tokens,
                            hists=self.request_hists(ns), ns=ns)

    def _finish_request(self, trace: RequestTrace) -> None:
        if trace.e2e_ms is not None:
            trace._h["e2e"].observe(trace.e2e_ms)
        if trace.accept_rate is not None:
            trace._h["accept"].observe(trace.accept_rate)
        with self._lock:
            if len(self._traces) == self._traces.maxlen:
                self.traces_dropped += 1
            self._traces.append(trace)
            self._traces_total += 1
        self.registry.event("request_finished", **trace.summary())

    @property
    def finished_traces(self) -> List[RequestTrace]:
        with self._lock:
            return list(self._traces)

    # -- profiler hook ------------------------------------------------------
    def step_annotation(self, name: str, step: int):
        """A labelled profiler range when the ``jax_profiler`` knob is on:
        ``torch.profiler.record_function`` (visible in a live
        ``torch.profiler`` capture) plus an NVTX range when CUDA is up,
        labelled ``name`` with ``step_num=step`` as JAX's
        ``StepTraceAnnotation`` labels its step; nullcontext otherwise."""
        if not (self.enabled and self.jax_profiler):
            return contextlib.nullcontext()
        import torch

        label = f"{name}#step_num={step}"
        stack = contextlib.ExitStack()
        stack.enter_context(torch.profiler.record_function(label))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(label))
        return stack

    # -- export -------------------------------------------------------------
    def flush(self) -> None:
        self.recorder.flush()

    def reset_window(self) -> None:
        """Start a fresh measurement window: settle pending spans, then drop
        every histogram observation (bench: called after warmup so the
        percentile tables exclude compile time).  Counters keep counting —
        callers baseline those by differencing."""
        self.flush()
        self.registry.reset_histograms()

    def register_exit_close(self) -> None:
        """Arrange ``close()`` at interpreter exit (idempotent per
        instance).  The train engine closes through its own atexit drain;
        serve-only processes call this so a configured
        ``chrome_trace_path``/``jsonl_path`` is actually written.  The hook
        holds only a weakref: a process that recycles engines must not
        accumulate one fully-populated span/trace store per engine — an
        instance GC'd before exit simply has nothing left to write."""
        with self._lock:
            if self._exit_registered:
                return
            self._exit_registered = True
        import atexit
        import weakref

        ref = weakref.ref(self)

        def _close_if_alive(ref=ref):
            tel = ref()
            if tel is not None:
                tel.close()

        atexit.register(_close_if_alive)

    @staticmethod
    def _request_pids(namespaces) -> Dict[str, int]:
        """Per-namespace request pid blocks: the default ``serve``
        namespace keeps pid 1 (single-process export is byte-compatible
        with the pre-fleet layout: spans pid 0, requests pid 1), every
        OTHER claimed namespace gets its own odd pid (3, 5, ...) in sorted
        order — so merging two engines' (or two workers') traces never
        aliases their request tracks onto one pid."""
        rest = sorted(ns for ns in set(namespaces) if ns != "serve")
        pids = {"serve": 1}
        for i, ns in enumerate(rest):
            pids[ns] = 3 + 2 * i
        return pids

    def chrome_trace(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Chrome trace-event JSON of everything recorded so far: engine
        spans (pid 0, one tid per track) + request lifecycles (one pid per
        engine namespace — ``serve`` keeps pid 1, ``serve2``/... get their
        own odd pids; tid = uid).  Writes ``path`` when given; always
        returns the dict."""
        self.flush()
        events = self.recorder.chrome_events(pid=0)
        with self._lock:
            traces = list(self._traces)
        pid_of = self._request_pids(tr.ns for tr in traces)
        named = set()
        for tr in traces:
            pid = pid_of[tr.ns]
            if pid != 1 and pid not in named:
                named.add(pid)
                events.append({"name": "process_name", "ph": "M", "pid": pid,
                               "tid": 0, "args": {"name": f"requests:{tr.ns}"}})
            events.extend(tr.chrome_events(pid=pid))
        events = _strictly_order(events)
        out = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": {
                "spans_dropped": self.recorder.dropped,
                "traces_dropped": self.traces_dropped,
            },
        }
        if path is not None:
            with open(path, "w") as fh:
                json.dump(out, fh)
        return out

    def drain_chrome_events(self) -> List[Dict[str, Any]]:
        """Chrome events recorded since the LAST drain: new recorder spans
        plus the lifecycles of requests finished since then (pid layout as
        :meth:`chrome_trace`).  The batch a fleet ``metrics_pull`` returns
        — non-destructive (watermarked), no device sync, no file I/O, so
        it is safe on the worker's RPC thread between ticks."""
        events = self.recorder.drain_chrome_events(pid=0)
        with self._lock:
            new = self._traces_total - self._traces_drained
            traces = list(self._traces)[-new:] if new else []
            self._traces_drained = self._traces_total
            pid_of = self._drain_req_pids
            for ns in sorted({tr.ns for tr in traces}):
                if ns not in pid_of:
                    pid_of[ns] = 3 + 2 * (len(pid_of) - 1)
        for tr in traces:
            events.extend(tr.chrome_events(pid=pid_of[tr.ns]))
        return events

    def close(self) -> None:
        self.flush()
        if self.enabled and self.chrome_trace_path:
            try:
                self.chrome_trace(self.chrome_trace_path)
            except OSError:
                pass  # an unwritable path at exit: nothing left to report to
        self.registry.close()
