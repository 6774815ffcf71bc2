"""Request router: the client-facing front end over N engine workers —
the port of ``deepspeed_tpu/serving/router.py``, over in-process workers
(``pool.WorkerPool``) or subprocess workers behind the socket transport
(``remote.RemotePool``).

The router owns the request lifecycle — typed admission at the front door,
placement, re-route / replay on worker death — and dispatches to the
:class:`~deepspeed_tpu_torch.serving.pool.WorkerPool`'s schedulers.  Four
policies compose:

* **Prefix-affinity routing** — a prompt's leading FULL blocks hash into a
  chained content key (``(parent_key, block_tokens)``), and the router
  remembers which worker last served each chain; a new prompt routes to
  the deepest-matching live worker, so shared system prompts land where
  their blocks already live.
* **Least-loaded fallback** — placement cost: shed state, then queue depth
  + running count, then the worker's TTFT median, then pool headroom.
* **Prefill/decode disaggregation** — prompts at or over
  ``disagg_threshold`` route to a PREFILL-role worker; at the first token
  the request migrates to a decode worker through the paged-KV handoff
  (``serving/handoff.py``, payload optionally int8 / fp8 on the wire).
* **SLO-aware admission** — a worker's ``RETRY_LATER`` backs that worker
  off for its ``retry_after_ms`` hint and re-routes; the router's own
  backlog sheds at the front door; a worker death (the chaos
  ``worker_kill`` point, a heartbeat lease expiry, or ``WorkerDead``)
  re-routes and replays every
  lost request from its prompt under the ``max_replays`` budget; zero live
  workers is a loud typed refusal, never a hang.

A kernel or CUDA error is neither a worker death nor a failed handoff: the
router lets it propagate out of ``tick()`` (``ops.kernels.surfaces``), as
the schedulers' guards do; a subprocess worker replies it typed and its
``RemoteWorker`` raises it as ``KernelError`` from the op that met it.

Single-threaded like the engine tick loop: ``tick()`` drives every live
worker once and the router's control work happens between ticks.  Router
telemetry lives in the shared registry's ``router/*`` namespace, next to
each worker's ``serve*/*``.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

from ..config.config import RouterConfig, _coerce
from ..inference import scheduler as sched_mod
from ..inference.faults import WORKER_KILL, InjectedFault
from ..inference.sampling import SamplingParams
from ..ops.kernels import surfaces
from ..inference.scheduler import (
    CLIENT_ERRORS,
    QUEUED,
    REJECT_DUPLICATE_UID,
    REJECT_EMPTY_PROMPT,
    REJECT_SAMPLING_CONFLICT,
    RETRY_LATER,
    SubmitResult,
)
from ..telemetry import RateView, StatsView
from .errors import WorkerDead
from .pool import MIXED_ROLE, WorkerPool

BACKLOG, SUBMITTED, DONE = "backlog", "submitted", "done"


@dataclass
class RouterRequest:
    """Router-side lifecycle of one client request — enough state to replay
    it from the prompt on another worker (re-route after worker death)."""

    uid: int
    prompt: List[int]
    sampling: SamplingParams
    submit_time: float
    deadline_ms: Optional[float] = None
    ttft_deadline_ms: Optional[float] = None
    phase: str = BACKLOG
    worker: Optional[int] = None
    disagg: bool = False  # prefilling on a PREFILL-role worker, will migrate
    routed_by: str = ""  # affinity | least_loaded | prefill
    replays: int = 0
    chain_keys: List[object] = field(default_factory=list)
    # open "queued" recorder span while the request sits in the router
    # backlog (None otherwise) — ended when it routes, expires or fails
    queue_span: Any = None


class Router:
    def __init__(self, pool: WorkerPool, config=None, faults=None):
        self.pool = pool
        self.config: RouterConfig = (
            config if isinstance(config, RouterConfig)
            else _coerce(RouterConfig, config)
        )
        # chaos harness: WORKER_KILL fires per (tick, worker) with the
        # WORKER index as the uid filter — independent of any engine-level
        # injector the pool's workers may carry
        self.faults = faults
        self.telemetry = pool.telemetry
        self._clock = self.telemetry.clock
        w0 = pool.workers[0]
        self._block_size = w0.block_size
        self._disagg_threshold = (
            self.config.disagg_threshold
            if self.config.disagg_threshold is not None
            else w0.disagg_default
        )
        self._ns = self.telemetry.claim_prefix("router")
        self._c = self.telemetry.counters(self._ns, (
            "submitted",
            "rejected",  # CLIENT_ERRORS surfaced to the caller
            "shed_rejections",  # front-door RETRY_LATER (router backlog)
            "no_worker_refusals",  # typed refusals with ZERO live workers
            "routed_affinity",  # placements won by the prefix-chain map
            "routed_least_loaded",
            "routed_prefill",  # long prompts placed on PREFILL-role workers
            "worker_retry_later",  # worker-level shed rejections absorbed
            "handoffs",  # completed prefill->decode migrations
            "handoff_wire_bytes",  # payload+scales bytes across all handoffs
            "handoff_fallbacks",  # migrations that stayed put (no room)
            "worker_deaths",
            "discovered_deaths",  # deaths found by health probe/lease expiry
            "replays",  # requests re-routed + replayed from the prompt
            "finished", "failed", "timed_out", "cancelled",
        ))
        self.stats = StatsView(self._c)
        self._reqs: Dict[int, RouterRequest] = {}
        self._backlog: Deque[int] = deque()
        # (state, tokens, error) per terminal uid, until popped
        self._results: Dict[int, Tuple[str, List[int], Optional[str]]] = {}
        # chained prefix key -> worker index, LRU-bounded
        self._affinity: "OrderedDict[object, int]" = OrderedDict()
        self.tick_no = 0
        self._closed = False
        # windowed first derivatives over the router's health counters —
        # the drift signals ``signals()`` publishes (RateView is internally
        # locked, so a controller thread may sample them freely)
        self._rates = {k: RateView(self._c[k]) for k in (
            "discovered_deaths", "replays", "shed_rejections",
            "no_worker_refusals")}
        # the attached fleet observability plane (telemetry/fleet.py) —
        # None until ``attach_fleet_collector`` wires one on.  The router
        # never imports the fleet module; it consumes the attached
        # collector by duck type in signals()/close().
        self._fleet_collector = None

    # -- affinity map --------------------------------------------------------
    def _chain_keys(self, tokens: Sequence[int]) -> List[object]:
        """Chained content keys of the prompt's FULL leading blocks,
        shallowest first.  Structurally-shared nested tuples — exact
        equality like the allocator's ``block_key``, no digest to collide —
        capped like ``_match_prefix`` (the final token always recomputes)."""
        if not self.config.affinity:
            return []
        bs = self._block_size
        keys: List[object] = []
        parent: object = None
        for i in range((len(tokens) - 1) // bs):
            parent = (parent, tuple(tokens[i * bs:(i + 1) * bs]))
            keys.append(parent)
        return keys

    def _note_affinity(self, keys: Sequence[object], widx: int) -> None:
        for k in keys:
            self._affinity[k] = widx
            self._affinity.move_to_end(k)
        while len(self._affinity) > self.config.affinity_max_keys:
            self._affinity.popitem(last=False)

    def _affinity_match(self, keys: Sequence[object]):
        """Deepest chain key already mapped to a LIVE worker (None if
        nothing matches) — one dict probe per prompt block, deepest
        first."""
        for k in reversed(keys):
            widx = self._affinity.get(k)
            if widx is not None and self.pool.workers[widx].alive:
                return self.pool.workers[widx]
        return None

    # -- placement -----------------------------------------------------------
    @staticmethod
    def _cost(w) -> tuple:
        """Placement cost, lower is better: never prefer a shedding worker,
        then queue+running load, then the worker's recent TTFT median (the
        SLO signal — 0.0 with telemetry disabled, so it is a pure
        tiebreaker there), then LESS pool headroom (ties broken by index
        for determinism)."""
        return (w.shedding, w.load, w.ttft_p50_ms(), -w.headroom_blocks,
                w.index)

    def _candidates(self, rec: RouterRequest) -> List[tuple]:
        """(worker, route_kind) in preference order for ``rec``."""
        now = self._clock()
        decode = [w for w in self.pool.decode_workers
                  if w.backoff_until <= now]
        order: List[tuple] = []
        long_prompt = (self.pool.prefill_workers
                       and len(rec.prompt) >= self._disagg_threshold)
        if long_prompt:
            pre = [w for w in self.pool.prefill_workers
                   if w.backoff_until <= now]
            order += [(w, "prefill") for w in sorted(pre, key=self._cost)]
        else:
            aff = self._affinity_match(rec.chain_keys)
            if aff is not None and aff in decode and not aff.shedding:
                order.append((aff, "affinity"))
                decode = [w for w in decode if w is not aff]
            if not decode:
                # every MIXED worker is dead/backing off: prefill-role
                # workers are still full engines — better a non-disaggregated
                # placement than a request that can never land
                decode = [w for w in self.pool.prefill_workers
                          if w.backoff_until <= now]
        order += [(w, "least_loaded") for w in sorted(decode, key=self._cost)]
        return order

    def _remaining_deadline(self, rec: RouterRequest) -> Optional[float]:
        if rec.deadline_ms is None:
            return None
        elapsed = (self._clock() - rec.submit_time) * 1e3
        return max(rec.deadline_ms - elapsed, 0.001)

    def _route(self, rec: RouterRequest) -> SubmitResult:
        """One routing attempt, stamped as a ``route`` span on the shared
        recorder's ``router`` track (uid-tagged, so the stitched fleet
        trace shows where each placement decision sits on the timeline).
        Placement itself is :meth:`_route_to_worker`."""
        sp = self.telemetry.recorder.start(
            "route", track="router", uid=rec.uid, replays=rec.replays)
        res = self._route_to_worker(rec)
        sp.end(accepted=res.accepted, worker=rec.worker,
               kind=rec.routed_by or res.reason)
        return res

    def _route_to_worker(self, rec: RouterRequest) -> SubmitResult:
        """Place ``rec`` on a worker.  CLIENT_ERRORS propagate (every worker
        shares one engine config, so an invalid request is invalid
        everywhere) — EXCEPT sampling conflicts, which are per-worker BATCH
        state, not request validity: those skip to the next candidate and
        degrade to RETRY_LATER (the batch drains, the request lands later);
        RETRY_LATER backs the rejecting worker off by its hint and tries
        the next candidate."""
        hints: List[float] = []
        for w, kind in self._candidates(rec):
            res = w.try_submit(
                rec.uid, rec.prompt, rec.sampling,
                deadline_ms=self._remaining_deadline(rec),
                ttft_deadline_ms=rec.ttft_deadline_ms,
            )
            if res.accepted:
                rec.worker = w.index
                rec.phase = SUBMITTED
                # migrate-at-first-token only for requests ROUTED for
                # disaggregation — a short prompt that lands on a
                # prefill-role worker as a last-resort fallback decodes
                # where it is
                rec.disagg = kind == "prefill"
                rec.routed_by = kind
                self._c[f"routed_{kind}"].inc()
                if rec.chain_keys and w.role == MIXED_ROLE:
                    self._note_affinity(rec.chain_keys, w.index)
                return res
            if res.reason == REJECT_SAMPLING_CONFLICT:
                hints.append(self.config.retry_backoff_ms)
                continue  # no backoff: clears as soon as the batch drains
            if res.reason in CLIENT_ERRORS:
                return res
            # worker-level shed: honor the backoff hint, try the next one
            self._c["worker_retry_later"].inc()
            back = (res.retry_after_ms if res.retry_after_ms is not None
                    else self.config.retry_backoff_ms)
            hints.append(back)
            w.backoff_until = self._clock() + back / 1e3
        return SubmitResult(
            rec.uid, RETRY_LATER, "no worker can take the request now",
            retry_after_ms=min(hints) if hints else
            self.config.retry_backoff_ms,
        )

    # -- client surface ------------------------------------------------------
    def try_submit(
        self, uid: int, tokens: Sequence[int],
        sampling: SamplingParams = SamplingParams(),
        deadline_ms: Optional[float] = None,
        ttft_deadline_ms: Optional[float] = None,
    ) -> SubmitResult:
        """Admit a request at the front door; NEVER raises.  ``QUEUED``
        covers both immediate placement and the router-side backlog (a
        worker-level shed is the router's problem, not the client's);
        ``RETRY_LATER`` + ``retry_after_ms`` only when the router itself is
        over its backlog depth."""
        tokens = [int(t) for t in tokens]
        if uid in self._reqs or uid in self._results:
            return SubmitResult(uid, REJECT_DUPLICATE_UID,
                                f"uid {uid} already in use")
        if not tokens:
            return SubmitResult(uid, REJECT_EMPTY_PROMPT, "empty prompt")
        if not self.pool.alive:
            # the bottom of the degradation ladder: a loud typed refusal,
            # never a silent backlog nothing will ever drain
            self._c["no_worker_refusals"].inc()
            return SubmitResult(
                uid, RETRY_LATER, "no live workers in the pool",
                retry_after_ms=self.config.retry_backoff_ms)
        depth = self.config.shed_queue_depth
        if depth is not None and len(self._backlog) >= depth:
            self._c["shed_rejections"].inc()
            hints = [w.retry_after_ms()
                     for w in self.pool.alive] or [
                         self.config.retry_backoff_ms]
            return SubmitResult(
                uid, RETRY_LATER,
                f"router backlog over {depth}; retry later",
                retry_after_ms=max(hints),
            )
        rec = RouterRequest(
            uid=uid, prompt=tokens, sampling=sampling,
            submit_time=self._clock(), deadline_ms=deadline_ms,
            ttft_deadline_ms=ttft_deadline_ms,
            chain_keys=self._chain_keys(tokens),
        )
        res = self._route(rec)
        if res.reason in CLIENT_ERRORS:
            self._c["rejected"].inc()
            return res
        self._reqs[uid] = rec
        self._c["submitted"].inc()
        if not res.accepted:  # every worker shedding: queue at the router
            rec.phase = BACKLOG
            self._backlog.append(uid)
            rec.queue_span = self.telemetry.recorder.start(
                "queued", track="router", uid=uid)
        return SubmitResult(uid, QUEUED)

    def submit(self, uid: int, tokens: Sequence[int],
               sampling: SamplingParams = SamplingParams(),
               **kw) -> SubmitResult:
        """Raising wrapper (same contract as the scheduler's)."""
        res = self.try_submit(uid, tokens, sampling, **kw)
        if res.reason in CLIENT_ERRORS:
            raise ValueError(res.detail)
        if res.reason == RETRY_LATER:
            raise RuntimeError(res.detail)
        return res

    def cancel(self, uid: int) -> bool:
        rec = self._reqs.get(uid)
        if rec is None:
            return False
        if rec.phase == SUBMITTED:
            w = self.pool.workers[rec.worker]
            if w.alive and w.cancel(uid):
                w.pop_result(uid)
        self._finish(rec, sched_mod.CANCELLED, [], None)
        return True

    def next_uid(self) -> int:
        uid = 1
        while uid in self._reqs or uid in self._results:
            uid += 1
        return uid

    # -- terminal bookkeeping ------------------------------------------------
    def _finish(self, rec: RouterRequest, state: str, tokens: List[int],
                error: Optional[str]) -> None:
        if rec.queue_span is not None:
            rec.queue_span.end(outcome=state)
            rec.queue_span = None
        self._results[rec.uid] = (state, tokens, error)
        rec.phase = DONE
        self._reqs.pop(rec.uid, None)
        try:
            self._backlog.remove(rec.uid)
        except ValueError:
            pass
        if state in (sched_mod.FINISHED, sched_mod.FAILED,
                     sched_mod.TIMED_OUT, sched_mod.CANCELLED):
            self._c[state].inc()

    def pop_result(self, uid: int) -> Tuple[str, List[int]]:
        """(terminal state, tokens) — tokens follow ``generate()``
        semantics (stop stripped, capped).  Raises ``KeyError`` until the
        request reaches a terminal state."""
        state, tokens, _ = self._results.pop(uid)
        return state, tokens

    def state_of(self, uid: int) -> str:
        if uid in self._results:
            return self._results[uid][0]
        rec = self._reqs.get(uid)
        if rec is None:
            raise KeyError(uid)
        return rec.phase

    @property
    def idle(self) -> bool:
        return not self._reqs

    # -- worker death --------------------------------------------------------
    def _kill_worker(self, w, discovered: bool = False) -> None:
        self._c["worker_deaths"].inc()
        if discovered:
            # found by the health probe (heartbeat lease expiry, transport
            # retry exhaustion) rather than injected — the out-of-process
            # death-detection path
            self._c["discovered_deaths"].inc()
        lost = [r for r in self._reqs.values()
                if r.phase == SUBMITTED and r.worker == w.index]
        w.kill()
        # a dead worker's cache is gone: purge its affinity entries so new
        # arrivals stop chasing it
        for k in [k for k, v in self._affinity.items() if v == w.index]:
            del self._affinity[k]
        for rec in lost:
            self._replay_lost(rec)

    def _replay_lost(self, rec: RouterRequest) -> None:
        """Reclaim a request whose worker is gone: replay from the prompt on
        another worker (greedy decode makes the retried result
        token-identical to the lost one) under the ``max_replays`` budget,
        then typed FAILED.  Called from ``_kill_worker`` for the requests
        known at death time AND from the tick's collection loop — a submit
        racing a death can land on a worker in the instant it dies, and
        that straggler must heal the same way instead of being tracked
        forever."""
        rec.worker = None
        rec.disagg = False
        if rec.replays >= self.config.max_replays:
            self._finish(rec, sched_mod.FAILED, [],
                         "worker died; replay budget exhausted")
            return
        rec.replays += 1
        self._c["replays"].inc()
        self.telemetry.recorder.start(
            "replay", track="router", uid=rec.uid,
            attempt=rec.replays).end()
        rec.phase = BACKLOG
        self._backlog.append(rec.uid)
        if rec.queue_span is None:
            rec.queue_span = self.telemetry.recorder.start(
                "queued", track="router", uid=rec.uid)

    # -- prefill/decode migration -------------------------------------------
    def _maybe_migrate(self, rec: RouterRequest) -> None:
        src = self.pool.workers[rec.worker]
        view = src.request_view(rec.uid)
        if view is None or view.state != sched_mod.DECODE \
                or not view.generated:
            return  # still prefilling (or already terminal — collected below)
        if view.cancel_requested:
            return  # deferred cancel pending: never migrate doomed work
        targets = [w for w in self.pool.decode_workers
                   if not w.shedding and w is not src]
        ho = None
        sp = None
        for tgt in sorted(targets, key=self._cost):
            if ho is None:
                sp = self.telemetry.recorder.start(
                    "handoff", track="router", uid=rec.uid, src=src.index,
                    fmt=self.config.handoff_fmt)
                try:
                    ho = src.extract_handoff(rec.uid,
                                             fmt=self.config.handoff_fmt)
                except Exception as e:  # noqa: BLE001
                    if surfaces(e):
                        raise  # a kernel or CUDA fault, not a failed handoff
                    # source died/stalled mid-extract (network): the request
                    # keeps decoding where it is; the health probe owns the
                    # death path
                    rec.disagg = False
                    self._c["handoff_fallbacks"].inc()
                    sp.end(outcome="extract_failed")
                    return
            res = tgt.adopt_handoff(
                ho, sampling=rec.sampling,
                deadline_ms=self._remaining_deadline(rec),
                ttft_deadline_ms=rec.ttft_deadline_ms,
            )
            if res.accepted:
                if not src.detach_migrated(rec.uid):
                    # the source refused (a deferred cancel won the race
                    # and released CANCELLED): kill the adopted copy and
                    # let terminal collection pick the cancel up from src
                    tgt.cancel(rec.uid)
                    tgt.pop_result(rec.uid)
                    rec.disagg = False
                    sp.end(outcome="cancelled")
                    return
                rec.worker = tgt.index
                rec.disagg = False
                self._c["handoffs"].inc()
                self._c["handoff_wire_bytes"].inc(ho.wire_bytes)
                sp.end(outcome="migrated", tgt=tgt.index,
                       wire_bytes=ho.wire_bytes)
                if rec.chain_keys and ho.fmt == "none":
                    # only the exact wire publishes the migrated prefix on
                    # the target (lossy pages stay unkeyed) — re-pointing
                    # the chain at a worker that can't serve it would turn
                    # every later shared-prefix arrival into a full miss
                    self._note_affinity(rec.chain_keys, tgt.index)
                return
            if res.reason in CLIENT_ERRORS:
                break  # adoption impossible anywhere with these params
        # nowhere to go: keep decoding on the prefill worker (correct, just
        # not disaggregated) and stop retrying
        rec.disagg = False
        self._c["handoff_fallbacks"].inc()
        if sp is not None:
            sp.end(outcome="fallback")

    # -- the loop ------------------------------------------------------------
    def tick(self) -> None:
        """One front-end tick: death checks (injected worker-kill chaos AND
        the ``healthy()`` probe) -> one scheduler tick per live worker ->
        first-token migrations -> terminal collection -> backlog re-route +
        front-door deadline expiry.  At zero live workers every tracked
        request fails LOUDLY typed — the router never hangs on an empty
        pool.  A kernel or CUDA error raised by a worker's tick propagates
        out of here untouched."""
        self.tick_no += 1
        ticked = []
        for w in list(self.pool.alive):
            if self.faults is not None:
                try:
                    self.faults.maybe_raise(WORKER_KILL, uids=(w.index,))
                except InjectedFault:
                    self._kill_worker(w)
                    continue
            if not w.healthy():
                self._kill_worker(w, discovered=True)
                continue
            # one pipelined RPC per remote worker per megastep (a step_burst
            # of up to decode_megastep ticks; in-process workers run them
            # here): remote ticks overlap across processes, and death
            # discovery/cancel/collection move to megastep boundaries
            w.begin_tick(self.config.decode_megastep)
            ticked.append(w)
        for w in ticked:
            w.finish_tick()
        if not self.pool.alive:
            for rec in list(self._reqs.values()):
                self._finish(rec, sched_mod.FAILED, [],
                             "no live workers in the pool")
            return
        # first-token migrations off prefill-role workers
        for rec in [r for r in list(self._reqs.values())
                    if r.phase == SUBMITTED and r.disagg]:
            if self.pool.workers[rec.worker].alive:
                self._maybe_migrate(rec)
        # collect terminals into router results
        for rec in [r for r in list(self._reqs.values())
                    if r.phase == SUBMITTED]:
            w = self.pool.workers[rec.worker]
            if not w.alive:
                # usually _kill_worker already replayed this worker's loss
                # (re-phasing its requests to BACKLOG) — anything still
                # SUBMITTED here slipped in racing the death and must heal
                # through the same replay path, never be tracked forever
                self._replay_lost(rec)
                continue
            view = w.request_view(rec.uid)
            if view is None or view.state not in sched_mod.TERMINAL:
                continue
            popped = w.pop_state(rec.uid)
            if popped is None:
                continue  # worker died between view and pop: replay next tick
            state, error, tokens = popped
            self._finish(rec, state, tokens, error)
        # re-route the backlog (deadline-expire what cannot wait)
        for uid in list(self._backlog):
            rec = self._reqs.get(uid)
            if rec is None:
                continue
            dl = self._remaining_deadline(rec)
            if dl is not None and dl <= 0.001:
                self._finish(rec, sched_mod.TIMED_OUT, [],
                             "deadline expired in router backlog")
                continue
            res = self._route(rec)
            if res.accepted:
                self._backlog.remove(uid)
                if rec.queue_span is not None:
                    rec.queue_span.end(outcome="routed")
                    rec.queue_span = None
            elif res.reason in CLIENT_ERRORS:
                # genuinely invalid against the shared worker config (e.g.
                # a replay hitting a pool-impossible condition): terminal
                # typed failure, never a silent forever-retry
                self._finish(rec, sched_mod.FAILED, [], res.detail)

    def run(self, wait_for: Optional[Sequence[int]] = None,
            max_ticks: int = 1_000_000) -> Dict[int, Tuple[str, List[int]]]:
        """Tick until every tracked request (or every uid in ``wait_for``)
        reaches a terminal state; returns {uid: (state, tokens)} without
        popping."""
        def pending() -> bool:
            if wait_for is not None:
                return any(u not in self._results for u in wait_for)
            return not self.idle

        ticks = 0
        while pending():
            if ticks >= max_ticks:
                raise RuntimeError(f"router: no convergence after "
                                   f"{max_ticks} ticks")
            self.tick()
            ticks += 1
        uids = wait_for if wait_for is not None else list(self._results)
        return {u: (self._results[u][0], self._results[u][1]) for u in uids}

    def apply_knobs(self, knobs: Dict[str, Any]) -> Dict[int, Any]:
        """Push one live-retune batch to EVERY live worker (the fan-out leg
        of the adaptation controller).  Per-worker failures are isolated:
        a validation refusal or a dead worker records an error entry for
        that index and the push continues — a retune must never be able to
        take the pool down.  Returns {worker index: staged dict | error
        string}."""
        out: Dict[int, Any] = {}
        for w in list(self.pool.alive):
            try:
                out[w.index] = w.apply_knobs(dict(knobs))
            except (ValueError, WorkerDead) as e:
                out[w.index] = f"{type(e).__name__}: {e}"
        return out

    # -- observability seam --------------------------------------------------
    def attach_fleet(self, collector) -> None:
        """Adopt a fleet collector (``telemetry.fleet.FleetCollector``,
        duck-typed — use ``attach_fleet_collector`` to build one from this
        router).  ``signals()`` starts publishing its registry/SLO views
        and ``close()`` stops its thread.  Attaching replaces (and stops)
        any previous collector."""
        prev, self._fleet_collector = self._fleet_collector, collector
        if prev is not None and prev is not collector:
            prev.stop(final_pull=False)

    def signals(self) -> Dict[str, Any]:
        """Router-tier observability snapshot, mirroring
        ``ServeScheduler.signals()`` so a controller consumes the router
        through the same seam it uses for a single engine.  Safe from any thread: counter/RateView
        reads are internally consistent, the worker facades are lock-free
        host reads, and everything else is an advisory point-in-time
        sample.  With a fleet collector attached, adds the per-worker pull
        health, the fleet counter rollup, and the SLO monitor's
        availability/burn-rate report."""
        now = self._clock()
        alive = list(self.pool.alive)
        n = len(alive)
        depth = self.config.shed_queue_depth
        headrooms = [w.headroom_fraction for w in alive]
        out: Dict[str, Any] = {
            "tick_no": self.tick_no,
            "workers_alive": n,
            "backlog": len(self._backlog),
            "inflight": len(self._reqs),
            # fleet queue pressure: router backlog + every live worker's
            # waiting queue (the elastic scaler's primary up signal)
            "queue_depth": len(self._backlog) + sum(
                w.queue_depth for w in alive),
            "shed_pressure": (sum(1 for w in alive if w.shedding) / n
                              if n else 1.0),
            "shedding": depth is not None and len(self._backlog) >= depth,
            "headroom_fraction": min(headrooms) if headrooms else 0.0,
            "worker_backoff_s": {
                w.index: max(w.backoff_until - now, 0.0) for w in alive},
            "rates": {k: v.sample(now) for k, v in self._rates.items()},
            "counters": dict(self.stats),
        }
        collector = self._fleet_collector
        if collector is not None:
            fleet = collector.fleet
            out["fleet"] = fleet.snapshot()
            out["fleet_counters"] = fleet.counter_rollup()
            if collector.slo is not None:
                out["slo"] = collector.slo.report(now, fleet=fleet)
        return out

    # -- teardown ------------------------------------------------------------
    def prefix_hit_rate(self) -> float:
        return self.pool.prefix_hit_rate()

    def close(self) -> List[Dict[str, int]]:
        """Tear the pool down through the audited ``engine.close()`` path
        and release the router's telemetry namespace.  Idempotent; returns
        the per-worker zero-leak audits."""
        if self._closed:
            return [w.close_audit or {} for w in self.pool.workers]
        # stop the fleet collector FIRST (with one final pull while the
        # workers still answer), so teardown never races a pull
        collector, self._fleet_collector = self._fleet_collector, None
        if collector is not None:
            collector.stop(final_pull=True)
        audits = self.pool.close()
        self.telemetry.release_prefix(self._ns)
        self._closed = True
        return audits


def build_router(params, cfg, sec, router=None, telemetry=None, serve=None,
                 faults=None, engine_faults=None, device=None) -> Router:
    """One-call front-end construction: a :class:`WorkerPool` stamped out
    from ``sec`` (one ``ServeEngineConfig`` for every worker) under a
    shared ``Telemetry``, wrapped in a :class:`Router` configured by
    ``router`` (a ``RouterConfig`` or dict).  ``faults`` is the ROUTER-level
    injector (``worker_kill``); ``engine_faults`` goes to every engine's
    internal chaos points.  ``device``: where every worker runs (CUDA
    unless the caller names another); the workers share ``params``."""
    rc = router if isinstance(router, RouterConfig) \
        else _coerce(RouterConfig, router)
    pool = WorkerPool(
        params, cfg, sec, n_workers=rc.n_workers,
        prefill_workers=rc.prefill_workers, telemetry=telemetry,
        serve=serve, faults=engine_faults, device=device,
    )
    return Router(pool, rc, faults=faults)
