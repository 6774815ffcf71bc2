"""Serving scheduler — the port of ``deepspeed_tpu/inference/scheduler.py``:
continuous batching with queueing admission, chunked prefill,
preemption-by-recompute, and the fault-tolerance layer (typed lifecycle
states, deadlines, cancellation, per-request failure isolation,
watchdog/shed degradation, live knobs, KV-handoff adoption) over the
paged-KV engine.  Names, counters and decisions follow JAX's, so one
workload, one seed and one fault-injector seed give the same terminal
states and tokens in both packages.

``submit()`` never throws on capacity: requests wait in a FIFO queue and
each ``tick()`` runs

    expire  ->  admission  ->  chunked prefill  ->  decode  ->  degradation

* **Admission** pops waiting requests in arrival order under a watermark
  (``kv_watermark`` of the pool stays allocatable while a batch runs);
  younger requests may pass one that does not fit until it has waited
  ``starvation_ticks``.
* **Chunked prefill**: each tick dispatches at most ``prefill_chunk``
  prompt tokens, page-aligned.
* **Decode**: one batched tick over the running set; when page growth
  finds the pool exhausted, the youngest running request is preempted by
  recompute.  Speculation drafts under the chunk budget the prefill left
  over; a request sheds its own drafts before anyone is preempted.
* **Megastep** (``serve.decode_megastep`` = n > 1): a decode-only tick
  fuses up to n decode ticks into ONE device-resident engine burst; the
  plan collapses to one tick whenever the tick has other work, collapses
  under pool pressure before anyone is preempted, and clamps to the
  nearest request deadline (headroom over the per-tick duration EMA).

Fault tolerance:

* **Typed terminal states** — ``FINISHED`` / ``FAILED`` / ``TIMED_OUT`` /
  ``CANCELLED`` / ``MIGRATED``, all through the single leak-free
  ``_release()`` path.
* **Deadlines** — per-request e2e and TTFT deadlines (``ServeConfig``
  defaults, per-request overrides), checked at tick boundaries.
* **Cancellation** from any state; a cancel landing mid-tick on a running
  request defers its release to the next tick boundary.
* **Per-request failure isolation** — the dispatch guard retries
  transient failures (``faults.is_transient``) with bounded exponential
  backoff, then dispatches each request alone so only the implicated ones
  FAIL.  NaN/inf logits arrive as the engine's ``-1`` sentinel and fail
  exactly the poisoned row.  **Kernel and CUDA errors are not request
  failures**: the guard re-raises every exception ``ops.kernels.surfaces``
  recognizes (a ``KernelError`` from building or launching a kernel, a
  CUDA error, anything raised inside a kernel wrapper) before it looks at
  ``is_transient`` — never retried, never isolated, so ``tick()`` raises
  it and the run fails loudly.
* **Watchdog + graceful degradation** — a tick-duration watchdog and a
  queue-depth detector flip the scheduler into shed mode (``try_submit``
  returns typed ``RETRY_LATER`` with a ``retry_after_ms`` hint,
  speculation off until the queue drains).  A burst's duration divides by
  its fused tick count.
* **Live knobs** — ``apply_knobs`` stages a validated batch that lands at
  the next tick boundary.
* **KV handoff** — ``adopt_prefilled`` / ``detach`` (``serving/``).

One restriction: all concurrently scheduled requests share the sampling
triple (temperature/top_k/top_p); the triple resets when the scheduler
drains idle.

Concurrency: ``tick()`` is single-owner; the intake surface
(``waiting``/``requests``/``_running`` membership, the triple election,
uid allocation) is shared with any thread calling ``try_submit`` /
``cancel`` / ``pop_result`` under one reentrant ``_lock``; the dispatch
phases run outside it.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence

from ..config.config import ServeConfig, _coerce
from ..ops.kernels import surfaces
from ..telemetry import NULL_REQUEST_TRACE, StatsView, Telemetry
from .faults import is_transient
from .sampling import SamplingParams

WAITING, PREFILL, DECODE = "waiting", "prefill", "decode"
FINISHED, FAILED, TIMED_OUT, CANCELLED, MIGRATED = (
    "finished", "failed", "timed_out", "cancelled", "migrated"
)
TERMINAL = frozenset((FINISHED, FAILED, TIMED_OUT, CANCELLED, MIGRATED))

# -- typed submission outcomes (front ends distinguish client error from
# capacity without parsing exception strings) --------------------------------
QUEUED = "queued"
REJECT_DUPLICATE_UID = "duplicate_uid"
REJECT_EMPTY_PROMPT = "empty_prompt"
REJECT_PROMPT_TOO_LONG = "prompt_too_long"
# retired in JAX (over-budget prompts queue normally); kept for front ends
# that branch on historical reasons
REJECT_PROMPT_OVER_BUDGET = "prompt_over_budget"
REJECT_POOL_IMPOSSIBLE = "pool_impossible"
REJECT_SAMPLING_CONFLICT = "sampling_conflict"
RETRY_LATER = "retry_later"
# invalid-outright rejections (the caller's bug: retrying cannot help)
CLIENT_ERRORS = frozenset((
    REJECT_DUPLICATE_UID, REJECT_EMPTY_PROMPT, REJECT_PROMPT_TOO_LONG,
    REJECT_PROMPT_OVER_BUDGET, REJECT_POOL_IMPOSSIBLE,
    REJECT_SAMPLING_CONFLICT,
))


@dataclass(frozen=True)
class SubmitResult:
    """Typed handle ``try_submit`` returns: ``accepted`` or a reason enum
    (``CLIENT_ERRORS`` member = invalid request; ``RETRY_LATER`` = shed
    mode, back off and resubmit).  ``retry_after_ms`` accompanies
    ``RETRY_LATER``: the scheduler's drain-rate estimate of when a resubmit
    has a chance (queue excess over the shed-exit watermark x the recent
    tick duration) — clients back off proportionally instead of
    blind-polling.

    ``budget_blocks``/``budget_scope`` accompany ``REJECT_POOL_IMPOSSIBLE``:
    the KV-block budget the request was actually judged against and what
    that budget spans (``"replica_pool"``, or
    ``"replica_pool(aggregate over N seq shards)"`` on a seq-sharded mesh)
    — so a caller can distinguish "too long for THIS config" (a wider
    ``seq_shards``/``num_blocks`` deployment could serve it) from "too
    long ever" (``REJECT_PROMPT_TOO_LONG``, past ``max_seq_len``)."""

    uid: int
    reason: str
    detail: str = ""
    retry_after_ms: Optional[float] = None
    budget_blocks: Optional[int] = None
    budget_scope: str = ""

    @property
    def accepted(self) -> bool:
        return self.reason == QUEUED


@dataclass
class ServeRequest:
    """Host-side lifecycle of one submitted generation request."""

    uid: int
    prompt: List[int]  # original prompt (output accounting)
    sampling: SamplingParams
    tokens: List[int]  # prefilled on (re)admission: prompt + generated so far
    state: str = WAITING
    generated: List[int] = field(default_factory=list)
    submit_tick: int = 0
    admit_tick: int = -1  # first admission
    preemptions: int = 0
    denied_state: Optional[tuple] = None  # admission state at last failed probe
    trace: Any = NULL_REQUEST_TRACE  # telemetry RequestTrace (no-op unless enabled)
    # fault-tolerance state
    submit_time: float = 0.0  # scheduler clock at submit (deadline base)
    deadline_ms: Optional[float] = None  # e2e deadline (None = scheduler default)
    ttft_deadline_ms: Optional[float] = None
    error: Optional[str] = None  # recorded cause for FAILED/TIMED_OUT
    retries: int = 0  # transient-failure retries charged to this request
    # cancel() arrived mid-tick while this request was RUNNING: the release
    # defers to the next tick boundary (expire phase) so the in-flight
    # dispatch phases never lose the descriptor under their feet
    cancel_requested: bool = False


class ServeScheduler:
    def __init__(
        self,
        engine,
        prefill_chunk: Optional[int] = None,
        kv_watermark: float = 0.0625,
        starvation_ticks: int = 32,
        serve: Optional[ServeConfig] = None,
        faults=None,
    ):
        self.engine = engine
        bs = engine.block_size
        chunk = min(prefill_chunk or engine.prefill_budget, engine.prefill_budget)
        self.prefill_chunk = max(bs, (chunk // bs) * bs)
        # watermark headroom is per REPLICA group: on a 2-D batch x model
        # serve mesh each replica grows its own decode batch against its own
        # block range, so aggregate headroom in another replica's pool is
        # unusable to it
        total = engine.mgr.allocator.total_blocks // engine.mgr.replicas
        self._watermark_blocks = max(1, round(total * kv_watermark))
        self.kv_watermark = float(kv_watermark)
        self.starvation_ticks = starvation_ticks
        self.serve: ServeConfig = serve if isinstance(serve, ServeConfig) \
            else _coerce(ServeConfig, serve)
        self.faults = faults if faults is not None \
            else getattr(engine, "faults", None)
        # the INTAKE lock: owns waiting/requests/_running membership, the
        # sampling-triple election, and uid allocation — everything a
        # non-owner thread (router, controller) may touch concurrently
        # with the single-owner tick loop.  Reentrant because the release
        # path nests under cancel/close.  Device-dispatch phases run
        # outside it by design (a forward pass must never stall a submit).
        self._lock = threading.RLock()
        self.waiting: "deque[ServeRequest]" = deque()
        self.requests: Dict[int, ServeRequest] = {}
        self._running: List[ServeRequest] = []  # admission order
        # single-owner flag (written only by the tick thread): a cancel
        # landing while True defers running requests' release to the next
        # expire phase instead of freeing a descriptor the in-flight
        # dispatch still indexes
        self._in_tick = False
        # live-retune staging: ``apply_knobs`` validates and parks the new
        # values here under the intake lock; the tick pops + applies them at
        # its own boundary, so no dispatch phase ever observes a knob change
        # mid-burst (the invariant scenario_retune_vs_tick replays)
        self._staged_knobs: Optional[Dict[str, Any]] = None
        self.knob_epoch = 0  # bumps once per applied retune batch
        self.last_knob_error: Optional[str] = None
        # terminal trace events recorded under the intake lock, fired
        # OUTSIDE it by _flush_released: trace.finished writes the JSONL
        # request summary, and disk I/O must never ride the intake lock
        self._released_pending: List[ServeRequest] = []
        self.tick_no = 0
        self._triple = None  # shared device sampling triple
        self._uid_counter = 0
        # leftover chunk tokens per tick PER REPLICA (replica -> tokens):
        # chunked prefill and speculation share one per-tick token headroom,
        # and on a partitioned pool each replica group accounts its own
        # share (a tick saturated by one replica's prompt chunks must not
        # silence every other replica's drafts)
        self._spec_budget: Dict[int, int] = {}
        self._admit_transient = False  # last admit probe failed transiently
        # degradation state
        self._shed = False
        self._shed_span = None
        self._slow_streak = 0  # consecutive ticks over watchdog_tick_ms
        # telemetry rides the engine's: one registry per engine+scheduler
        # pair, ``stats`` a read-through view over "sched/*" counters plus
        # the fault-tolerance counters living in the paired engine ("serve/*")
        # namespace — deadline/cancel/shed transitions are serve-level events
        self.telemetry: Telemetry = getattr(engine, "telemetry", None) \
            or Telemetry.ensure(None)
        self._clock = self.telemetry.clock
        # the engine pre-claimed the paired sched namespace at its own
        # __init__ (sched2/ goes with serve2/ regardless of which engine's
        # scheduler is touched first); standalone construction claims fresh
        self._ns = getattr(engine, "_sched_ns", None) \
            or self.telemetry.claim_prefix("sched")
        self._eng_ns = getattr(engine, "_ns", "serve")
        self._c = self.telemetry.counters(self._ns, (
            "submitted", "finished", "admissions",
            "preemptions", "queue_wait_ticks", "prefill_chunks",
            "drafts_shed",  # draft sets dropped under pool pressure
            "migrated",  # requests detached to another worker (KV handoff)
            "adopted",  # requests adopted mid-flight (the receiving side)
            "retunes",  # knob batches applied at a tick boundary
            "retune_rejects",  # staged batches refused at apply time
        ))
        self._tick_ms_ema: Optional[float] = None  # retry_after_ms basis
        # decode ticks fused into this tick's device burst (megastep): 1 =
        # per-tick decode; read by tick() to normalize the watchdog's
        # measured duration back to a per-device-tick figure
        self._last_fused = 1
        # fault-tolerance transitions count in the paired SERVE namespace
        # (they are serve-level events; the engine's stats view lists them
        # too — registry counters are memoized by name, so these are the
        # very same objects the engine registered at its __init__)
        self._flt = self.telemetry.counters(self._eng_ns, (
            "failed", "timed_out", "cancelled", "retries", "nan_failures",
            "isolation_probes", "shed_transitions", "shed_rejections",
            "watchdog_trips",
        ))
        self.stats = StatsView(self._c)

    # -- request intake -----------------------------------------------------
    def next_uid(self) -> int:
        with self._lock:
            while True:
                self._uid_counter += 1
                uid = self._uid_counter
                if uid not in self.requests \
                        and uid not in self.engine.mgr.seqs:
                    return uid

    def try_submit(
        self, uid: int, tokens: Sequence[int],
        sampling: SamplingParams = SamplingParams(),
        deadline_ms: Optional[float] = None,
        ttft_deadline_ms: Optional[float] = None,
    ) -> SubmitResult:
        """Queue a request; NEVER raises.  Returns a :class:`SubmitResult`
        whose reason distinguishes client error (``CLIENT_ERRORS``: the
        request is invalid outright) from backpressure (``RETRY_LATER``:
        shed mode — resubmit later).  Capacity that merely requires waiting
        still queues (``QUEUED``).  Safe from any thread: the whole
        validate-elect-enqueue sequence holds the intake lock, so a
        concurrent submit can neither double-win the triple election nor
        interleave into the queue mid-validation."""
        with self._lock:
            return self._try_submit_locked(
                uid, tokens, sampling, deadline_ms, ttft_deadline_ms)

    def _try_submit_locked(
        self, uid: int, tokens: Sequence[int],
        sampling: SamplingParams,
        deadline_ms: Optional[float],
        ttft_deadline_ms: Optional[float],
    ) -> SubmitResult:
        tokens = [int(t) for t in tokens]
        if uid in self.requests or uid in self.engine.mgr.seqs:
            # the mgr check covers put()-admitted sequences: deferring the
            # collision to admission would blow up mid-tick instead
            return SubmitResult(uid, REJECT_DUPLICATE_UID,
                                f"uid {uid} already in use")
        if not tokens:
            return SubmitResult(uid, REJECT_EMPTY_PROMPT, "empty prompt")
        eng = self.engine
        if len(tokens) >= eng.max_seq_len:
            return SubmitResult(
                uid, REJECT_PROMPT_TOO_LONG,
                f"prompt length {len(tokens)} leaves no room to generate "
                f"(max_seq_len {eng.max_seq_len})",
            )
        # the request must fit the pool ALONE at its maximum length — prompt
        # plus full generation budget — or decode growth eventually exhausts
        # the pool with no victim left to preempt and the whole loop dies.
        # (Over-budget prompts queue like anyone else: continuation prefill
        # packs are replica-local, so REJECT_PROMPT_OVER_BUDGET is retired.)
        max_len = min(len(tokens) + sampling.max_new_tokens, eng.max_seq_len)
        blocks = -(-max_len // eng.block_size)
        # a sequence lives entirely inside ONE replica's block range, so the
        # feasibility bound is the per-replica pool, not the cross-replica
        # aggregate.  A replica's pool DOES aggregate its seq shards (the
        # sequence stripes across all S slices), so the budget here is S x
        # one slice — bigger contexts fit by raising seq_shards.
        pool = eng.mgr.allocator.total_blocks // eng.mgr.replicas
        if blocks > pool:
            scope = ("replica_pool" if eng.mgr.seq_shards <= 1 else
                     f"replica_pool(aggregate over {eng.mgr.seq_shards} "
                     f"seq shards)")
            return SubmitResult(
                uid, REJECT_POOL_IMPOSSIBLE,
                f"prompt + max_new_tokens needs {blocks} KV blocks; a "
                f"replica's pool only has {pool} ({scope})",
                budget_blocks=pool, budget_scope=scope,
            )
        triple = (sampling.temperature, sampling.top_k, sampling.top_p)
        if not self._running and not self.waiting:
            self._triple = triple
        elif triple != self._triple:
            return SubmitResult(
                uid, REJECT_SAMPLING_CONFLICT,
                f"sampling triple {triple} conflicts with the scheduled "
                f"batch's {self._triple} (one triple per dispatch)",
            )
        if self._shed:
            # graceful degradation: a shedding scheduler refuses new load
            # with a typed retryable rejection instead of queueing
            # unboundedly behind a backlog it cannot drain
            self._flt["shed_rejections"].inc()
            return SubmitResult(
                uid, RETRY_LATER,
                "scheduler is shedding load (queue backlog / watchdog); "
                "retry later",
                retry_after_ms=self.retry_after_ms(),
            )
        req = ServeRequest(uid=uid, prompt=tokens, sampling=sampling,
                           tokens=list(tokens), submit_tick=self.tick_no,
                           submit_time=self._clock(),
                           deadline_ms=deadline_ms,
                           ttft_deadline_ms=ttft_deadline_ms,
                           trace=self.telemetry.request_trace(
                               uid, ns=self._eng_ns))
        req.trace.submitted(prompt_tokens=len(tokens))
        self.requests[uid] = req
        self.waiting.append(req)
        self._c["submitted"].inc()
        return SubmitResult(uid, QUEUED)

    def submit(
        self, uid: int, tokens: Sequence[int],
        sampling: SamplingParams = SamplingParams(),
        deadline_ms: Optional[float] = None,
        ttft_deadline_ms: Optional[float] = None,
    ) -> SubmitResult:
        """Raising compat wrapper over :meth:`try_submit`: client-error
        rejections raise ``ValueError`` (as they always did), shed-mode
        backpressure raises ``RuntimeError``; capacity still queues."""
        res = self.try_submit(uid, tokens, sampling, deadline_ms=deadline_ms,
                              ttft_deadline_ms=ttft_deadline_ms)
        if res.reason in CLIENT_ERRORS:
            raise ValueError(res.detail)
        if res.reason == RETRY_LATER:
            raise RuntimeError(res.detail)
        return res

    def _base_sampling(self) -> SamplingParams:
        t, k, p = self._triple
        return SamplingParams(temperature=t, top_k=k, top_p=p)

    # -- the single release path --------------------------------------------
    def _release(self, req: ServeRequest, state: str,
                 error: Optional[str] = None) -> None:
        """Move ``req`` to a terminal ``state`` from ANY live state, always
        leak-free: folds the descriptor's spec totals into the trace, frees
        its pages (full cached blocks retire to the prefix LRU as usual),
        removes it from whichever structure holds it, and counts the
        transition.  Every terminal transition in the scheduler funnels
        through here — finish, failure, timeout, and cancel differ only in
        the state label and counters."""
        with self._lock:
            self._release_locked(req, state, error)

    def _release_locked(self, req: ServeRequest, state: str,
                        error: Optional[str]) -> None:
        assert state in TERMINAL, state
        if req.state in TERMINAL:
            return  # idempotent: a racing cancel/finish pair releases once
        if req.cancel_requested and state in (FINISHED, FAILED):
            # a deferred mid-tick cancel already promised True to its
            # caller; the same tick finishing (or failing — the error
            # stays recorded on the request) must not out-race it into a
            # different terminal state (a client would double-process
            # "cancelled" work it sees as FINISHED)
            state = CANCELLED
        seq = self.engine.mgr.seqs.get(req.uid)
        if seq is not None:
            req.trace.add_spec(seq.spec_drafted, seq.spec_accepted)
            if error is None and seq.error is not None:
                error = seq.error
            self.engine.mgr.release(req.uid)
        if req in self._running:
            self._running.remove(req)
        try:
            self.waiting.remove(req)
        except ValueError:
            pass
        req.state = state
        req.error = error
        if state == FINISHED:
            self._c["finished"].inc()
        elif state == FAILED:
            self._flt["failed"].inc()
        elif state == TIMED_OUT:
            self._flt["timed_out"].inc()
        elif state == CANCELLED:
            self._flt["cancelled"].inc()
        elif state == MIGRATED:
            self._c["migrated"].inc()
        # the terminal trace event writes the JSONL request summary —
        # deferred to _flush_released so the disk write happens OUTSIDE
        # the intake lock (tick end / intake-method exit)
        self._released_pending.append(req)

    def _flush_released(self) -> None:
        """Fire the terminal trace events recorded by ``_release_locked``
        — called with the intake lock NOT held (tick end and the public
        intake methods' exits): a JSONL summary write under the lock
        would stall every concurrent submit behind disk latency."""
        with self._lock:
            pending, self._released_pending = self._released_pending, []
        for req in pending:
            req.trace.finished(outcome=req.state)

    def _fail(self, req: ServeRequest, error: str, nan: bool = False) -> None:
        """Quarantine ``req``: typed FAILED terminal state with the error
        recorded on the request (it stays in ``requests`` — with whatever
        tokens it produced — until the caller pops it)."""
        if nan:
            self._flt["nan_failures"].inc()
        self._release(req, FAILED, error=error)

    def cancel(self, uid: int) -> bool:
        """Cancel a request from any non-terminal state (queued, mid-prefill
        chunk, decoding, mid-draft, preempted-back-to-queue).  Returns True
        if the request transitioned to ``CANCELLED``; False if it is unknown
        or already terminal (too late to cancel).  Safe from any thread —
        the lookup and the release are one atomic step, so a cancel racing
        the tick's own finish cannot double-release.  A cancel landing
        MID-TICK on a running request defers its release to the next tick
        boundary (the dispatch phases run outside the intake lock by
        design, and must not lose a descriptor they are indexing); the
        request may carry at most one more emitted token."""
        with self._lock:
            req = self.requests.get(uid)
            if req is None or req.state in TERMINAL:
                return False
            if self._in_tick and req in self._running:
                req.cancel_requested = True
            else:
                self._release_locked(req, CANCELLED, None)
        self._flush_released()
        return True

    # -- prefill/decode disaggregation (the KV-handoff seam) -----------------
    def adopt_prefilled(
        self, uid: int, tokens: Sequence[int], n_ctx: int,
        sampling: SamplingParams = SamplingParams(),
        deadline_ms: Optional[float] = None,
        ttft_deadline_ms: Optional[float] = None,
    ) -> SubmitResult:
        """Adopt a request another worker already prefilled: admit
        ``tokens`` (= prompt + the first sampled token) straight into the
        DECODE state with ``n_ctx`` tokens' KV assumed present.  NEVER
        raises — returns a :class:`SubmitResult` (``RETRY_LATER`` when this
        worker has no room; the router then leaves the request decoding
        where it was).

        On success the sequence holds freshly-allocated, EXCLUSIVELY-owned
        pages (no prefix-cache sharing: the caller is about to scatter
        migrated KV into them via ``engine.inject_kv_blocks``) and
        ``seen_tokens = n_ctx``; the caller must inject the extracted pages
        for positions ``[0, n_ctx)`` before the next tick, then publish the
        prefix chain with ``mgr.update_hashes`` (serving/handoff.py wraps
        both)."""
        with self._lock:
            return self._adopt_prefilled_locked(
                uid, tokens, n_ctx, sampling, deadline_ms, ttft_deadline_ms)

    def _adopt_prefilled_locked(
        self, uid: int, tokens: Sequence[int], n_ctx: int,
        sampling: SamplingParams,
        deadline_ms: Optional[float],
        ttft_deadline_ms: Optional[float],
    ) -> SubmitResult:
        tokens = [int(t) for t in tokens]
        if uid in self.requests or uid in self.engine.mgr.seqs:
            return SubmitResult(uid, REJECT_DUPLICATE_UID,
                                f"uid {uid} already in use")
        if not 0 < n_ctx < len(tokens):
            return SubmitResult(
                uid, REJECT_EMPTY_PROMPT,
                f"adoption needs 0 < n_ctx ({n_ctx}) < len(tokens) "
                f"({len(tokens)}): the last token is the un-written first "
                "sample, everything before it has KV",
            )
        eng = self.engine
        # remaining generation budget (one token already emitted)
        max_len = min(n_ctx + sampling.max_new_tokens, eng.max_seq_len)
        if len(tokens) >= eng.max_seq_len:
            return SubmitResult(
                uid, REJECT_PROMPT_TOO_LONG,
                f"adopted length {len(tokens)} leaves no room to decode "
                f"(max_seq_len {eng.max_seq_len})",
            )
        blocks = -(-max_len // eng.block_size)
        pool = eng.mgr.allocator.total_blocks // eng.mgr.replicas
        if blocks > pool:
            scope = ("replica_pool" if eng.mgr.seq_shards <= 1 else
                     f"replica_pool(aggregate over {eng.mgr.seq_shards} "
                     f"seq shards)")
            return SubmitResult(
                uid, REJECT_POOL_IMPOSSIBLE,
                f"adopted request needs {blocks} KV blocks at max length; "
                f"a replica's pool only has {pool} ({scope})",
                budget_blocks=pool, budget_scope=scope,
            )
        triple = (sampling.temperature, sampling.top_k, sampling.top_p)
        if not self._running and not self.waiting:
            self._triple = triple
        elif triple != self._triple:
            return SubmitResult(
                uid, REJECT_SAMPLING_CONFLICT,
                f"sampling triple {triple} conflicts with the scheduled "
                f"batch's {self._triple}",
            )
        if self._shed:
            self._flt["shed_rejections"].inc()
            return SubmitResult(
                uid, RETRY_LATER, "scheduler is shedding load",
                retry_after_ms=self.retry_after_ms(),
            )
        mgr = eng.mgr
        if not mgr.free_slots:
            return SubmitResult(uid, RETRY_LATER, "no free sequence slots",
                                retry_after_ms=self.retry_after_ms())
        # fresh exclusively-owned pages (match_prefix=False): injection is
        # about to overwrite them, so cache sharing would stomp live blocks
        snap = mgr.hit_stats_snapshot()
        seq = mgr.admit(uid, tokens, match_prefix=False)
        fresh = -(-len(tokens) // mgr.block_size)
        headroom = self._watermark_blocks \
            if self._replica_busy(mgr, seq) else 0
        ok = fresh + headroom <= mgr._alloc_of(seq).available_blocks
        if ok:
            try:
                mgr.ensure_capacity(seq, 0)
            except RuntimeError:
                ok = False
        # hit-rate accounting restores on EVERY path: the source worker
        # already counted this prompt at original admission, and the target
        # never prefills it (KV is injected) — letting the admit's bump
        # stand would deflate the pool-aggregate prefix_hit_rate with a
        # phantom full-prompt miss per migration
        mgr.hit_stats_restore(snap)
        if not ok:
            mgr.release(uid)
            return SubmitResult(
                uid, RETRY_LATER,
                "KV pool cannot hold the migrated sequence under the "
                "watermark", retry_after_ms=self.retry_after_ms(),
            )
        seq.seen_tokens = n_ctx
        req = ServeRequest(
            uid=uid, prompt=tokens[:-1], sampling=sampling,
            tokens=tokens, state=DECODE, generated=[tokens[-1]],
            submit_tick=self.tick_no, admit_tick=self.tick_no,
            submit_time=self._clock(), deadline_ms=deadline_ms,
            ttft_deadline_ms=ttft_deadline_ms,
            trace=self.telemetry.request_trace(uid, ns=self._eng_ns),
        )
        req.trace.submitted(prompt_tokens=len(tokens) - 1)
        req.trace.admitted()
        req.trace.tokens(1)
        self.requests[uid] = req
        self._running.append(req)
        self._c["adopted"].inc()
        self._c["admissions"].inc()
        return SubmitResult(uid, QUEUED)

    def detach(self, uid: int) -> bool:
        """Release a request whose ownership moved to ANOTHER worker (KV
        handoff): typed ``MIGRATED`` terminal state through the single
        release path — pages free locally (full cached blocks retire to the
        prefix LRU, warming future affinity hits), tokens stay on the
        request until popped.  Returns False if unknown/already
        terminal.  OWNER-THREAD only, between ticks: migration is a
        handoff-protocol step (extract -> adopt -> inject -> detach on one
        thread) — unlike ``cancel`` it cannot defer mid-tick, because the
        destination worker is already decoding the migrated sequence.  A
        request with a DEFERRED CANCEL pending refuses migration: it is
        released CANCELLED here (keeping the cancel's promise) and the
        caller gets False — the router must then cancel the adopted copy
        instead of completing the handoff."""
        with self._lock:
            req = self.requests.get(uid)
            if req is None or req.state in TERMINAL:
                return False
            if req.cancel_requested:
                self._release_locked(req, CANCELLED, None)
                migrated = False
            else:
                self._release_locked(req, MIGRATED, None)
                migrated = True
        self._flush_released()
        return migrated

    def close(self) -> None:
        """Drive every live request to a terminal state (CANCELLED) and
        empty the queue — the scheduler half of ``engine.close()``: all
        block/slot ownership goes back through the one ``_release`` path,
        so a torn-down trial engine cannot leak pages a later engine's
        allocator would then double-own.  Idempotent.  Releases directly
        (never the mid-tick deferral): teardown must not leave a deferred
        cancel holding pages after the queues are cleared."""
        with self._lock:
            for uid in list(self.requests):
                req = self.requests[uid]
                if req.state not in TERMINAL:
                    self._release_locked(req, CANCELLED, None)
            self.waiting.clear()
            self._running.clear()
        self._flush_released()

    # -- deadlines ----------------------------------------------------------
    def _deadline_of(self, req: ServeRequest) -> Optional[float]:
        return req.deadline_ms if req.deadline_ms is not None \
            else self.serve.deadline_ms

    def _ttft_deadline_of(self, req: ServeRequest) -> Optional[float]:
        return req.ttft_deadline_ms if req.ttft_deadline_ms is not None \
            else self.serve.ttft_deadline_ms

    def _expire_phase(self) -> None:
        """Tick-boundary deadline check over every live request (queued AND
        running): e2e deadline always applies; the TTFT deadline only until
        the first token lands.  Runs FIRST so an expired request's pages are
        back in the pool before this tick's admission."""
        with self._lock:
            now = self._clock()
            for req in list(self.waiting) + list(self._running):
                if req.state in TERMINAL:
                    continue
                if req.cancel_requested:
                    # a cancel deferred from mid-tick lands here, at the
                    # first safe boundary of the NEXT tick
                    self._release_locked(req, CANCELLED, None)
                    continue
                waited_ms = (now - req.submit_time) * 1e3
                dl = self._deadline_of(req)
                if dl is not None and waited_ms > dl:
                    self._release_locked(
                        req, TIMED_OUT, f"e2e deadline {dl}ms exceeded")
                    continue
                tdl = self._ttft_deadline_of(req)
                if tdl is not None and not req.generated and waited_ms > tdl:
                    self._release_locked(
                        req, TIMED_OUT, f"ttft deadline {tdl}ms exceeded")

    # -- transient-failure retry --------------------------------------------
    def _backoff(self, attempt: int) -> None:
        base = self.serve.retry_backoff_ms / 1e3
        if base > 0:
            time.sleep(base * (2 ** (attempt - 1)))

    def _charge_retry(self, reqs: Sequence[Optional[ServeRequest]]) -> None:
        self._flt["retries"].inc()
        for r in reqs:
            if r is not None:
                r.retries += 1

    # -- admission ----------------------------------------------------------
    def _replica_busy(self, mgr, seq) -> bool:
        """Whether the watermark's decode-growth headroom applies to
        ``seq``'s replica: some RUNNING request's sequence lives in the same
        replica group (growth in another replica's range cannot touch this
        pool slice, so its headroom reservation would only starve
        admission).  Single-replica managers keep the historical rule —
        any running batch at all."""
        if mgr.replicas == 1:
            return bool(self._running)
        r = mgr.replica_of(seq)
        for other in self._running:
            s = mgr.seqs.get(other.uid)
            if s is not None and s is not seq and mgr.replica_of(s) == r:
                return True
        return False

    def _try_admit_locked(self, req: ServeRequest) -> bool:
        mgr = self.engine.mgr
        if not mgr.free_slots:
            return False
        total_blocks = -(-len(req.tokens) // mgr.block_size)
        # tentative admit performs the replica-affine placement AND the
        # prefix match (refs cached blocks); roll it — and its hit-rate
        # counters — back if the fresh remainder does not fit under the
        # watermark
        snap = mgr.hit_stats_snapshot()
        seq = mgr.admit(req.uid, req.tokens)
        fresh = total_blocks - len(seq.blocks)
        # the watermark reserves decode-growth headroom, but only while a
        # running batch exists IN THIS REPLICA to grow — an idle pool (or
        # an idle replica of a partitioned pool) admits to the brim.
        # Checked against the CHOSEN replica's allocator: aggregate headroom
        # in another replica's range cannot serve this sequence's growth.
        headroom = self._watermark_blocks \
            if self._replica_busy(mgr, seq) else 0
        if fresh + headroom > mgr._alloc_of(seq).available_blocks:
            mgr.release(req.uid)
            mgr.hit_stats_restore(snap)
            return False
        try:
            mgr.ensure_capacity(seq, 0)  # reserve every prompt page up front
        except RuntimeError as e:
            # roll the tentative admit back cleanly — admission is a probe,
            # never a place to crash the loop
            mgr.release(req.uid)
            mgr.hit_stats_restore(snap)
            if surfaces(e):
                raise
            if is_transient(e):
                # transient reservation failure (injected allocator race):
                # retry next tick.  The flag keeps _admit_phase from
                # memoizing this denial — the pool state did not move, so
                # the denied_state cache would otherwise pin the request
                # out forever.
                self._admit_transient = True
            else:
                # a fatal reservation fault must reach a typed terminal
                # state, not spin in WAITING forever
                self._fail(req, f"admission reservation failed: {e}")
            return False
        req.state = PREFILL
        if req.admit_tick < 0:
            req.admit_tick = self.tick_no
            self._c["queue_wait_ticks"].inc(self.tick_no - req.submit_tick)
        req.trace.admitted()
        self._running.append(req)
        self._c["admissions"].inc()
        return True

    def _admit_phase(self) -> None:
        # one intake-lock scope for the whole scan: admission decides on a
        # consistent queue snapshot, and a submit landing mid-scan waits
        # for the next tick instead of being half-considered (the probe is
        # pure host math — holding the lock across it is cheap)
        with self._lock:
            mgr = self.engine.mgr
            for req in list(self.waiting):
                if not mgr.free_slots:
                    break
                # admission outcome depends only on free slots, allocatable
                # blocks, and cache contents (every content change bumps
                # `registrations` or moves `available_blocks`): skip the full
                # tentative-admit probe — an O(prompt) prefix walk — when none
                # of that moved since this request was last denied.
                # PER-REPLICA availability, not the aggregate: balanced
                # cross-replica churn (one replica frees N while another
                # consumes N) changes where a request fits without moving
                # any aggregate number.
                state = (mgr.free_slots,
                         tuple(a.available_blocks for a in mgr.allocators),
                         mgr.allocator.registrations)
                self._admit_transient = False
                denied = req.denied_state == state \
                    or not self._try_admit_locked(req)
                if not denied:
                    self.waiting.remove(req)
                else:
                    # a transiently-failed probe must NOT be memoized: the
                    # pool state it keyed on did not change, so the cache
                    # would otherwise deny the request forever once the
                    # transient cleared
                    req.denied_state = None if self._admit_transient else state
                    if self.tick_no - req.submit_tick >= self.starvation_ticks:
                        break  # aged request: nothing may jump the queue

    # -- prefill ------------------------------------------------------------
    def _dispatch_prefill(self, entries, sampling) -> Dict[int, int]:
        """Guarded prefill dispatch: transient failures retry with bounded
        exponential backoff; a persistent failure falls back to per-entry
        solo dispatches so only the implicated request(s) fail.  Progress is
        re-derived from the live descriptors (``seen_tokens``) because a
        multi-pack dispatch may have completed some packs before failing."""
        eng = self.engine
        reqs = [self.requests.get(s.uid) for s, _, _ in entries]
        attempt = 0
        last_err: Optional[BaseException] = None
        while True:
            # re-derive ranges: completed packs advanced seen_tokens (and
            # appended first tokens), so a retry must not re-run them
            live = []
            done: Dict[int, int] = {}
            for seq, start, end in entries:
                req = self.requests.get(seq.uid)
                if req is None or req.state != PREFILL:
                    continue
                if seq.seen_tokens >= end:
                    if len(seq.tokens) == end + 1:  # sampled its first token
                        done[seq.uid] = seq.tokens[-1]
                    elif seq.error is not None:
                        # a pack that completed before the failure poisoned
                        # this row (its -1 result died with the exception)
                        done[seq.uid] = -1
                    continue
                live.append((seq, seq.seen_tokens, end))
            if not live:
                return done
            try:
                out = eng.prefill_entries(live, sampling)
                out.update(done)
                return out
            except Exception as e:  # noqa: BLE001 — the tick-level guard
                if surfaces(e):
                    raise  # a kernel or CUDA fault: never a request failure
                last_err = e
                if is_transient(e) and attempt < self.serve.max_retries:
                    attempt += 1
                    self._charge_retry(reqs)
                    self._backoff(attempt)
                    continue
                break
        # isolation: one solo dispatch per surviving entry — only requests
        # whose OWN dispatch still fails are quarantined
        out = {}
        for seq, start, end in entries:
            req = self.requests.get(seq.uid)
            if req is None or req.state != PREFILL:
                continue
            if seq.seen_tokens >= end:
                if len(seq.tokens) == end + 1:
                    out[seq.uid] = seq.tokens[-1]
                elif seq.error is not None:
                    out[seq.uid] = -1  # poisoned before the batch failure
                continue
            self._flt["isolation_probes"].inc()
            solo_attempt = 0
            while True:
                try:
                    out.update(eng.prefill_entries(
                        [(seq, seq.seen_tokens, end)], sampling))
                    break
                except Exception as e:  # noqa: BLE001
                    if surfaces(e):
                        raise  # a kernel or CUDA fault: never a request failure
                    if is_transient(e) and solo_attempt < self.serve.max_retries:
                        solo_attempt += 1
                        self._charge_retry([req])
                        self._backoff(solo_attempt)
                        continue
                    self._fail(req, f"prefill dispatch failed: {e}")
                    break
        return out

    def _prefill_phase(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        bs = self.engine.block_size
        mgr = self.engine.mgr
        R = mgr.replicas
        # the chunk budget is accounted PER REPLICA: packs are built as
        # per-replica chunks at R > 1 (engine.prefill_entries), so each
        # replica group gets its proportional share of the tick's prompt
        # tokens — one replica's long prompt cannot starve another's.
        # Shared rounding with the engine's pack budget (ragged.py) so a
        # scheduler-sized chunk always fits one engine per-replica chunk.
        per_chunk = mgr.per_replica_token_budget(self.prefill_chunk)
        budgets = {r: per_chunk for r in range(R)}
        entries = []
        for req in list(self._running):  # _fail below mutates _running
            if req.state != PREFILL:
                continue
            seq = mgr.seqs[req.uid]
            r = mgr.replica_of(seq)
            if budgets[r] < bs:
                continue
            # pick up prefix blocks published since admission (a request
            # queued behind the cold request that is WRITING its prefix
            # would otherwise recompute it)
            mgr.extend_match(seq)
            start = seq.seen_tokens
            remaining = len(seq.tokens) - start
            if remaining <= 0:
                # fully prefilled but unsampled: only reachable when the row
                # was poisoned and its result then lost to a same-batch
                # failure — fail it here rather than let it linger
                self._fail(req, seq.error or "non-finite logits in prefill",
                           nan=seq.error is not None)
                continue
            take = min(remaining, budgets[r])
            if take < remaining:
                take -= take % bs  # chunk boundaries stay page-aligned
                if take == 0:
                    continue
            entries.append((seq, start, start + take))
            budgets[r] -= take
        # leftover chunk tokens become this tick's speculative-draft budget:
        # drafting k tokens costs a k+1-position verify forward, so DRAFTED
        # tokens (not emitted ones) share the admission headroom chunked
        # prefill already accounts in — a tick saturated by prompt chunks
        # speculates less, an idle-prefill tick speculates up to the chunk.
        # Per replica, like the chunk budget it is the remainder of.
        self._spec_budget = {r: max(0, b) for r, b in budgets.items()}
        if not entries:
            return out
        clock = self.telemetry.clock
        t0 = clock()
        first = self._dispatch_prefill(entries, self._base_sampling())
        t1 = clock()
        for seq, start, end in entries:
            r = self.requests.get(seq.uid)
            if r is not None and r.state == PREFILL:
                # chunks share the tick's pack dispatch(es); each request's
                # chunk span carries the shared window + its own token count
                r.trace.prefill_chunk(t0, t1, end - start)
        self._c["prefill_chunks"].inc(len(entries))
        for req in list(self._running):
            if req.state == PREFILL and req.uid in first:
                tok = first[req.uid]
                if tok < 0:
                    # engine sentinel: this row's logits were non-finite
                    self._fail(req, mgr.seqs[req.uid].error
                               or "non-finite logits in prefill", nan=True)
                    continue
                req.state = DECODE
                req.generated.append(tok)
                req.trace.tokens(1)
                out[req.uid] = tok
                self._maybe_finish(req)
        return out

    # -- decode + preemption ------------------------------------------------
    def _pick_victim(self, exclude: ServeRequest) -> Optional[ServeRequest]:
        """Youngest preemptible request — restricted to the SAME replica
        group as ``exclude`` on a partitioned pool: preempting across
        replicas frees blocks the starved replica's allocator can never
        hand out (it would evict innocent requests for zero relief)."""
        mgr = self.engine.mgr
        replica = None
        if mgr.replicas > 1 and exclude.uid in mgr.seqs:
            replica = mgr.replica_of(mgr.seqs[exclude.uid])
        for req in reversed(self._running):  # youngest admission first
            if req is exclude or req.state not in (PREFILL, DECODE):
                continue
            if replica is not None and req.uid in mgr.seqs \
                    and mgr.replica_of(mgr.seqs[req.uid]) != replica:
                continue
            return req
        return None

    def _preempt(self, req: ServeRequest) -> None:
        """Preemption by recompute: drop the sequence's pages (full ones
        stay in the prefix-cache LRU) and requeue at the FRONT with prompt =
        all tokens so far — re-prefill is then mostly cache hits."""
        with self._lock:
            seq = self.engine.mgr.seqs[req.uid]
            req.tokens = list(seq.tokens)
            # this incarnation's draft/accept totals die with the
            # descriptor — fold them into the request trace before release
            req.trace.add_spec(seq.spec_drafted, seq.spec_accepted)
            req.trace.preempted()
            self.engine.mgr.release(req.uid)
            self._running.remove(req)
            req.state = WAITING
            req.preemptions += 1
            self.waiting.appendleft(req)
            self._c["preemptions"].inc()

    @property
    def _speculating(self) -> bool:
        # shed mode disables speculation: under pressure the verify's k+1
        # positions per sequence are pure extra work, and plain decode is
        # the predictable-latency path the watchdog wants
        return self.engine.enable_speculation and not self._shed

    def _remaining_emit(self, req: ServeRequest) -> int:
        """Tokens ``req`` may still emit: its ``max_new_tokens`` budget and
        the engine's ``max_seq_len`` headroom (>= 1 for a live DECODE
        request — anything at either cap finished last tick)."""
        seq = self.engine.mgr.seqs[req.uid]
        return max(1, min(req.sampling.max_new_tokens - len(req.generated),
                          self.engine.max_seq_len - seq.cur_len))

    def _plan_megastep(self, decoding: List[ServeRequest],
                       proposals) -> int:
        """Decode ticks to fuse into ONE device burst this tick (megastep).

        ``serve.decode_megastep`` is the ceiling; the plan adaptively
        collapses to per-tick (1) whenever the tick has non-decode work —
        queued admissions, running requests still in PREFILL, or live
        speculation proposals (verify ticks stay per-tick; megastep applies
        when spec is off, shed, or throttled to zero drafts) — and clamps
        the fuse count to the nearest survivor deadline (headroom over the
        per-tick duration EMA).  Per-row stop/emission caps ride the burst
        ON DEVICE, so early-finishing rows never decode past their stop;
        the count only follows the LEAST constrained row's budget.

        Deadline/cancel/watchdog phases keep running at tick (= megastep)
        boundaries: fusing n ticks bounds their added reaction latency by
        n x per-tick duration — the knob's documented tradeoff."""
        n = self.serve.decode_megastep
        if n <= 1 or self.waiting:
            return 1
        live = [r for r in decoding if r.state == DECODE]
        if not live:
            return 1
        with self._lock:
            if any(r.state == PREFILL for r in self._running):
                return 1
        if self._speculating and proposals:
            return 1
        per_tick_ms = max(self._tick_ms_ema or 1.0, 0.05)
        now = self._clock()
        for req in live:
            dl = self._deadline_of(req)
            if dl is not None:
                headroom_ms = dl - (now - req.submit_time) * 1e3
                n = min(n, max(1, int(headroom_ms / per_tick_ms)))
        return max(1, min(n, max(self._remaining_emit(r) for r in live)))

    def _dispatch_decode(self, survivors: List[ServeRequest],
                         proposals, n_fuse: int = 1) -> Dict[int, List[int]]:
        """Guarded decode/verify dispatch: transient retry with backoff,
        then per-request solo isolation (each survivor dispatched alone;
        only those whose own dispatch fails are quarantined).  With
        ``n_fuse`` > 1 the dispatch is one megastep burst — up to n_fuse
        fused decode ticks with per-request stop tokens and emission caps
        enforced on device."""
        eng = self.engine
        mgr = eng.mgr

        def run(reqs: List[ServeRequest]) -> Dict[int, List[int]]:
            seqs = [mgr.seqs[r.uid] for r in reqs]
            if n_fuse > 1:
                return eng._decode_burst(
                    seqs, self._base_sampling(), n_fuse,
                    max_emit={r.uid: self._remaining_emit(r) for r in reqs},
                    stop_tokens={r.uid: r.sampling.stop_token for r in reqs},
                )
            if self._speculating:
                props = {r.uid: proposals[r.uid] for r in reqs
                         if r.uid in proposals}
                return eng._spec_tick(seqs, self._base_sampling(), props)
            return {u: [t] for u, t in
                    eng._decode_tick(seqs, self._base_sampling()).items()}

        attempt = 0
        while True:
            try:
                return run(survivors)
            except Exception as e:  # noqa: BLE001
                if surfaces(e):
                    raise  # a kernel or CUDA fault: never a request failure
                if is_transient(e) and attempt < self.serve.max_retries:
                    attempt += 1
                    self._charge_retry(survivors)
                    self._backoff(attempt)
                    continue
                break
        runs: Dict[int, List[int]] = {}
        for req in survivors:
            if req.state != DECODE:
                continue
            self._flt["isolation_probes"].inc()
            solo_attempt = 0
            while True:
                try:
                    runs.update(run([req]))
                    break
                except Exception as e:  # noqa: BLE001
                    if surfaces(e):
                        raise  # a kernel or CUDA fault: never a request failure
                    if is_transient(e) and solo_attempt < self.serve.max_retries:
                        solo_attempt += 1
                        self._charge_retry([req])
                        self._backoff(solo_attempt)
                        continue
                    self._fail(req, f"decode dispatch failed: {e}")
                    break
        return runs

    def _decode_phase(self, decoding: List[ServeRequest]) -> Dict[int, int]:
        out: Dict[int, int] = {}
        eng = self.engine
        mgr = eng.mgr
        # draft proposals for this tick, bounded by the prefill chunk's
        # leftover token budget (speculation and chunked prefill share one
        # per-tick headroom, accounted in DRAFTED tokens PER REPLICA — one
        # plan call per replica group, so a prompt-saturated replica sheds
        # its own drafts without silencing the others); per-request
        # remaining max_new_tokens clamps inside plan_speculation so
        # clamped-away drafts never debit the shared budget
        decode_live = [r for r in decoding if r.state == DECODE]
        proposals: Dict[int, List[int]] = {}
        if self._speculating:
            by_replica: Dict[int, List[ServeRequest]] = {}
            for req in decode_live:
                r = mgr.replica_of(mgr.seqs[req.uid])
                by_replica.setdefault(r, []).append(req)
            for r, reqs in by_replica.items():
                proposals.update(eng.plan_speculation(
                    [mgr.seqs[q.uid] for q in reqs],
                    max_total_draft_tokens=self._spec_budget.get(
                        r, self.prefill_chunk),
                    max_emit={q.uid: q.sampling.max_new_tokens
                              - len(q.generated) for q in reqs},
                ))
        # megastep plan: how many decode ticks this tick fuses into one
        # device burst (1 = classic per-tick decode / verify)
        n_fuse = self._plan_megastep(decoding, proposals)
        for req in decoding:
            if req.state != DECODE:  # preempted by an earlier victim pick
                continue
            seq = mgr.seqs[req.uid]
            grow_retries = 0
            while True:
                # a megastep pre-reserves each row's full burst headroom so
                # its block table is static across the fused ticks; unused
                # tail reservations come back after the burst's fetch
                need = min(n_fuse, self._remaining_emit(req)) if n_fuse > 1 \
                    else 1 + len(proposals.get(req.uid, ()))
                try:
                    mgr.ensure_capacity(seq, need)
                    mgr.ensure_writable(seq, seq.cur_len - 1)
                    break
                except RuntimeError as e:
                    if surfaces(e):
                        raise  # a device fault (a copy-on-write clone): surface it
                    if is_transient(e):
                        # injected allocator race / transient reservation
                        # hiccup — NOT real pool pressure: retry in place
                        # (bounded) instead of preempting an innocent victim
                        if grow_retries < self.serve.max_retries:
                            grow_retries += 1
                            self._charge_retry([req])
                            self._backoff(grow_retries)
                            continue
                        self._fail(req, f"page reservation failed: {e}")
                        break
                    # shed this request's own in-flight drafts before
                    # preempting anyone — speculation is optional, residency
                    # is not (plain decode needs only one page of growth)
                    if proposals.pop(req.uid, None):
                        self._c["drafts_shed"].inc()
                        continue
                    if n_fuse > 1:
                        # real pool pressure: collapse the megastep to a
                        # single tick before evicting anyone — residency
                        # beats amortization (plain decode needs only one
                        # page of growth)
                        n_fuse = 1
                        continue
                    victim = self._pick_victim(exclude=req)
                    if victim is None:
                        raise RuntimeError(
                            "KV pool cannot hold even one growing sequence "
                            f"({mgr.allocator.total_blocks} blocks)"
                        ) from None
                    # a preempted victim's drafts die with its pages — its
                    # committed tokens requeue, the proposal never runs
                    proposals.pop(victim.uid, None)
                    self._preempt(victim)
        survivors = [r for r in decoding if r.state == DECODE]
        if not survivors:
            return out
        runs = self._dispatch_decode(survivors, proposals, n_fuse)
        self._last_fused = max(1, n_fuse)
        for req in survivors:
            if req.state != DECODE or req.uid not in runs:
                continue  # failed in isolation (already released)
            emitted = runs[req.uid]
            if not emitted:
                continue  # no emission headroom this burst
            if emitted and emitted[-1] < 0:
                # engine sentinel: non-finite logits in this row's forward
                self._fail(req, mgr.seqs[req.uid].error
                           or "non-finite logits in decode", nan=True)
                continue
            # tokens speculated past the stop are dropped from the request
            # and its descriptor
            emitted = eng.cut_at_stop(mgr.seqs[req.uid], emitted,
                                      req.sampling.stop_token)
            req.generated.extend(emitted)
            req.trace.tokens(len(emitted))
            out[req.uid] = emitted[-1]
            self._maybe_finish(req)
        return out

    # -- completion ---------------------------------------------------------
    def _maybe_finish(self, req: ServeRequest) -> None:
        samp = req.sampling
        seq = self.engine.mgr.seqs[req.uid]
        done = (
            (samp.stop_token is not None
             and req.generated[-1] == samp.stop_token)
            or len(req.generated) >= samp.max_new_tokens
            or seq.cur_len >= self.engine.max_seq_len
        )
        if done:
            self._release(req, FINISHED)

    def result(self, uid: int) -> List[int]:
        """Generated tokens with ``generate()`` semantics: trailing stop
        token stripped, capped at ``max_new_tokens``.  Terminal requests
        stay in ``self.requests`` (pinning their token history and, for
        FAILED/TIMED_OUT, the recorded ``error``) until ``pop_result`` —
        long-lived serve loops must pop, or host memory grows with every
        request ever served."""
        req = self.requests[uid]
        toks = list(req.generated)
        samp = req.sampling
        if samp.stop_token is not None and toks and toks[-1] == samp.stop_token:
            toks = toks[:-1]
        return toks[: samp.max_new_tokens]

    def pop_result(self, uid: int) -> List[int]:
        with self._lock:
            toks = self.result(uid)
            del self.requests[uid]
        self._flush_released()
        return toks

    # -- degradation (watchdog + sustained exhaustion) ----------------------
    def _set_shed(self, on: bool, reason: str) -> None:
        if on == self._shed:
            return
        self._shed = on
        self._flt["shed_transitions"].inc()
        if on:
            # one span covers the whole shed episode: visible as a block on
            # the engine's track in the Chrome trace
            self._shed_span = self.telemetry.recorder.start(
                "shed_mode", track=self._eng_ns, reason=reason,
                queue_depth=len(self.waiting), tick=self.tick_no,
            )
        else:
            if self._shed_span is not None:
                self._shed_span.end(tick_end=self.tick_no)
                self._shed_span = None

    def retry_after_ms(self) -> float:
        """Backoff hint for ``RETRY_LATER``: shed mode exits once the queue
        drains to half ``shed_queue_depth``, and roughly one queued request
        leaves per tick, so the estimate is (queue excess over the exit
        watermark) x (recent tick duration EMA).  Always >= one tick — a
        watchdog-triggered shed can hold with an empty queue, and a zero
        hint would invite the blind-polling this field exists to stop."""
        depth = self.serve.shed_queue_depth
        exit_depth = depth // 2 if depth is not None else 0
        excess = max(1, len(self.waiting) - exit_depth)
        per_tick = max(self._tick_ms_ema or 1.0, 0.05)
        return excess * per_tick

    def _update_degradation(self, tick_ms: float) -> None:
        # drain-rate estimate feeding retry_after_ms (EMA so one slow
        # compile tick does not dominate the hint)
        self._tick_ms_ema = tick_ms if self._tick_ms_ema is None \
            else 0.8 * self._tick_ms_ema + 0.2 * tick_ms
        wd = self.serve.watchdog_tick_ms
        if wd is not None:
            if tick_ms > wd:
                self._slow_streak += 1
                if self._slow_streak == self.serve.watchdog_grace_ticks:
                    self._flt["watchdog_trips"].inc()
            else:
                self._slow_streak = 0
        depth = self.serve.shed_queue_depth
        queue_over = depth is not None and len(self.waiting) > depth
        wd_over = wd is not None \
            and self._slow_streak >= self.serve.watchdog_grace_ticks
        if not self._shed:
            if queue_over:
                self._set_shed(True, "queue_depth")
            elif wd_over:
                self._set_shed(True, "watchdog")
        else:
            queue_ok = depth is None or len(self.waiting) <= depth // 2
            if queue_ok and not wd_over:
                self._set_shed(False, "recovered")

    @property
    def shedding(self) -> bool:
        return self._shed

    @property
    def quarantined(self) -> List[int]:
        """Uids held in the FAILED terminal state (error recorded on the
        request) awaiting ``pop_result``."""
        return [u for u, r in self.requests.items() if r.state == FAILED]

    # -- live retune surface ------------------------------------------------
    # knob tiers: everything listed here retunes WITHOUT a rebuild — serve
    # knobs swap the ServeConfig the tick phases read, engine knobs go
    # through ``engine.apply_knobs`` (host-side attributes the dispatch
    # plumbing reads fresh each tick).  Anything frozen into the engine's
    # tensors or captured graphs (quantize_weights, the pool geometry) is
    # REBUILD tier: close() + build_serve_engine.
    _SERVE_KNOBS = frozenset((
        "decode_megastep", "shed_queue_depth", "watchdog_tick_ms",
        "watchdog_grace_ticks", "deadline_ms", "ttft_deadline_ms",
    ))
    _ENGINE_KNOBS = frozenset((
        "prefill_chunk", "kv_watermark", "spec_max_draft",
        "enable_speculation",
    ))

    def apply_knobs(self, **knobs: Any) -> Dict[str, Any]:
        """Stage a validated live-retune batch; it takes effect at the NEXT
        tick boundary.  Safe from any thread (the controller's entry point
        into the engine): validation runs eagerly so the caller gets a
        typed ``ValueError`` for an impossible value, but the swap itself
        is deferred to ``tick()`` — the single-owner dispatch loop never
        observes a knob change between its phases.  Repeated calls between
        ticks merge (later values win).  Returns the staged dict."""
        unknown = set(knobs) - self._SERVE_KNOBS - self._ENGINE_KNOBS
        if unknown:
            raise ValueError(
                f"unknown live knobs {sorted(unknown)}; live tier is "
                f"{sorted(self._SERVE_KNOBS | self._ENGINE_KNOBS)} — "
                "anything else needs an engine rebuild")
        if not knobs:
            return {}
        serve_kw = {k: v for k, v in knobs.items() if k in self._SERVE_KNOBS}
        if serve_kw:
            replace(self.serve, **serve_kw)  # ConfigError (a ValueError) on bad values
        if "prefill_chunk" in knobs and int(knobs["prefill_chunk"]) < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {knobs['prefill_chunk']}")
        if "kv_watermark" in knobs \
                and not 0.0 <= float(knobs["kv_watermark"]) < 1.0:
            raise ValueError(
                f"kv_watermark must be in [0, 1), got {knobs['kv_watermark']}")
        if "spec_max_draft" in knobs and int(knobs["spec_max_draft"]) < 1:
            raise ValueError(
                f"spec_max_draft must be >= 1, got {knobs['spec_max_draft']}")
        with self._lock:
            staged = dict(self._staged_knobs or ())
            staged.update(knobs)
            self._staged_knobs = staged
            return dict(staged)

    def _apply_pending_knobs(self) -> None:
        """Tick-boundary application of a staged retune batch.  Runs on the
        owner tick thread before any phase looks at scheduling state; the
        whole swap happens under the intake lock and is pure host math (no
        device work, no blocking calls).  A batch the engine refuses at
        apply time (e.g. speculation turning on while sequences are live)
        is dropped whole and recorded — a mid-tick raise would kill the
        serve loop over a controller's stale guess."""
        with self._lock:
            staged, self._staged_knobs = self._staged_knobs, None
            if not staged:
                return
            try:
                self._apply_knobs_locked(staged)
                self.knob_epoch += 1
                self.last_knob_error = None
                self._c["retunes"].inc()
            except ValueError as e:
                self.last_knob_error = str(e)
                self._c["retune_rejects"].inc()

    def _apply_knobs_locked(self, staged: Dict[str, Any]) -> None:
        eng_kw = {k: staged[k] for k in self._ENGINE_KNOBS if k in staged}
        if eng_kw:
            # all-or-nothing inside the engine; raises before mutating
            self.engine.apply_knobs(**eng_kw)
        serve_kw = {k: staged[k] for k in self._SERVE_KNOBS if k in staged}
        if serve_kw:
            self.serve = replace(self.serve, **serve_kw)
        if "prefill_chunk" in staged:
            bs = self.engine.block_size
            chunk = min(int(staged["prefill_chunk"]),
                        self.engine.prefill_budget)
            self.prefill_chunk = max(bs, (chunk // bs) * bs)
        if "kv_watermark" in staged:
            self.kv_watermark = float(staged["kv_watermark"])
            total = self.engine.mgr.allocator.total_blocks \
                // self.engine.mgr.replicas
            self._watermark_blocks = max(1, round(total * self.kv_watermark))

    def knobs(self) -> Dict[str, Any]:
        """Current EFFECTIVE live-tier knob values (staged-but-unapplied
        batches are not reflected — they land at the next tick)."""
        eng = self.engine
        with self._lock:
            return {
                "prefill_chunk": self.prefill_chunk,
                "kv_watermark": self.kv_watermark,
                "enable_speculation": bool(eng.enable_speculation),
                "spec_max_draft": int(eng.spec_max_draft),
                "decode_megastep": self.serve.decode_megastep,
                "shed_queue_depth": self.serve.shed_queue_depth,
                "watchdog_tick_ms": self.serve.watchdog_tick_ms,
                "watchdog_grace_ticks": self.serve.watchdog_grace_ticks,
                "deadline_ms": self.serve.deadline_ms,
                "ttft_deadline_ms": self.serve.ttft_deadline_ms,
                "knob_epoch": self.knob_epoch,
            }

    def signals(self) -> Dict[str, Any]:
        """Host-only load snapshot for the adaptation controller: queue and
        pool pressure the registry's counters cannot express as state.
        Reads scheduler fields under the intake lock and the allocator's
        host-side accounting — no device sync, no dispatch state, so it is
        safe from the controller thread at any time."""
        mgr = self.engine.mgr
        alloc = mgr.allocator
        free, total = alloc.available_blocks, alloc.total_blocks
        pt, ct = mgr.prompt_tokens_total, mgr.cached_prompt_tokens
        with self._lock:
            return {
                "tick_no": self.tick_no,
                "prompt_tokens_total": pt,
                "cached_prompt_tokens": ct,
                "prefix_hit_rate": (ct / pt) if pt else 0.0,
                "preemptions": self._c["preemptions"].value,
                "queue_depth": len(self.waiting),
                "running": len(self._running),
                "shedding": self._shed,
                "tick_ms_ema": self._tick_ms_ema,
                "free_blocks": free,
                "total_blocks": total,
                "watermark_blocks": self._watermark_blocks,
                "headroom_fraction": free / total if total else 0.0,
                "knob_epoch": self.knob_epoch,
                "last_knob_error": self.last_knob_error,
            }

    # -- the loop -----------------------------------------------------------
    @property
    def idle(self) -> bool:
        return not self.waiting and not self._running

    def tick(self) -> Dict[int, int]:
        """One scheduler tick: expire -> admission -> chunked prefill ->
        decode -> degradation check.  Returns the newest token per request
        that emitted one (a request finishing its prefill emits its first
        token; it joins the decode batch from the NEXT tick).  Failed /
        timed-out / cancelled requests never appear in the returned dict —
        read their terminal state off ``requests[uid]``."""
        self.tick_no += 1
        self._in_tick = True  # single-owner write: cancels now defer
        self._apply_pending_knobs()  # staged retunes land HERE, never mid-phase
        t0 = self._clock()  # BEFORE the fault delay: an injected stall must
        # land inside the watchdog's measured window or it cannot trip it
        try:
            if self.faults is not None:
                d = self.faults.delay("slow_tick")
                if d > 0:
                    time.sleep(d)  # chaos harness: stalls the tick, trips the watchdog
            self._expire_phase()
            self._admit_phase()
            decoding = [r for r in self._running if r.state == DECODE]
            out = self._prefill_phase()
            self._last_fused = 1
            out.update(self._decode_phase(decoding))
            # a megastep deliberately makes the tick n_fuse x longer —
            # normalize the watchdog/EMA duration back to per-device-tick
            # so fused decode cannot trip the slow-tick shed path
            self._update_degradation(
                (self._clock() - t0) * 1e3 / self._last_fused)
            if self.engine.mgr.replicas > 1:
                # per-replica hit/headroom/spec-accept gauges: cheap host
                # math, refreshed at the tick boundary (engine doubles
                # without the method just skip)
                up = getattr(self.engine, "update_replica_gauges", None)
                if up is not None:
                    up()
            return out
        finally:
            self._in_tick = False
            # releases from the phases (finish/fail/expire) fire their
            # JSONL trace summaries here, outside every lock
            self._flush_released()

    def run(self, wait_for: Optional[Sequence[int]] = None,
            max_ticks: int = 1_000_000) -> Dict[int, List[int]]:
        """Tick until every request (or every uid in ``wait_for``) reaches a
        terminal state; returns {uid: result} (partial tokens for non-
        FINISHED terminals — check ``requests[uid].state``)."""
        def pending() -> bool:
            if wait_for is not None:
                return any(self.requests[u].state not in TERMINAL
                           for u in wait_for)
            return not self.idle

        ticks = stalled = 0
        while pending():
            if ticks >= max_ticks:
                raise RuntimeError(f"no convergence after {max_ticks} ticks")
            self.tick()
            ticks += 1
            # nothing running and nothing admittable: the pool/slots are
            # held outside the scheduler (put()-admitted sequences) and no
            # tick can ever make progress — fail loudly instead of spinning
            stalled = stalled + 1 if (not self._running and self.waiting) else 0
            if stalled > 1000:
                raise RuntimeError(
                    "scheduler stalled: waiting requests cannot be admitted "
                    "(KV blocks/slots held by sequences outside the scheduler)"
                )
        uids = wait_for if wait_for is not None else [
            u for u, r in self.requests.items() if r.state in TERMINAL
        ]
        return {u: self.result(u) for u in uids}
