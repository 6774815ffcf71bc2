"""Serving scheduler — counterpart of the core of ``deepspeed_tpu/inference/
scheduler.py``: continuous batching with queueing admission, chunked
prefill and preemption-by-recompute over the paged-KV engine.

``submit()`` never throws on capacity: requests wait in a FIFO queue and
each ``tick()`` runs

    admission  ->  chunked prefill  ->  decode

* **Admission** pops waiting requests in arrival order under a watermark:
  a request is admitted only if its fresh (non-prefix-cached) prompt blocks
  leave ``kv_watermark`` of the pool allocatable while a batch is running.
  Younger requests may pass one that does not fit until it has waited
  ``starvation_ticks``; then nothing jumps the queue.
* **Chunked prefill**: each tick dispatches at most ``prefill_chunk``
  prompt tokens, page-aligned.
* **Decode**: one batched tick over the running set.  When page growth
  finds the pool exhausted, the youngest running request is preempted by
  recompute (its pages retire to the prefix cache, it requeues at the
  front with prompt = all tokens so far).
* **Speculation** (``engine.enable_speculation``): the chunk budget that
  prefill left over is the tick's draft budget; each request's drafts are
  proposed before its pages are reserved, a request sheds its own drafts
  before anyone is preempted, and tokens speculated past a stop token are
  dropped.
* **Megastep** (``engine.serve.decode_megastep`` = n > 1): a decode-only
  tick fuses up to n decode ticks into ONE device-resident engine burst
  (``engine._decode_burst``: one host sync, per-request stop tokens and
  emission caps enforced on the device).  The plan collapses to one tick
  whenever a request waits, a running request is still in prefill, or
  speculation has proposals; under pool pressure it collapses to one tick
  before anyone is preempted.

Every request ends in one terminal state (``finished`` / ``failed`` /
``cancelled``) through the single ``_release`` path.  A row whose logits
were non-finite (the engine's -1 sentinel) fails that request only.

Not ported yet: deadlines (and with them the megastep's deadline clamp),
shed mode and the watchdog, transient retries and per-request isolation of
a failing dispatch, fault injection, live knobs, KV-handoff adoption, and
the intake lock (this scheduler is driven from one thread).  A dispatch
exception — a kernel build or launch error, or a graph capture or replay
error, included — propagates out of ``tick()``.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from .sampling import SamplingParams

WAITING, PREFILL, DECODE = "waiting", "prefill", "decode"
FINISHED, FAILED, CANCELLED = "finished", "failed", "cancelled"
TERMINAL = frozenset((FINISHED, FAILED, CANCELLED))

# typed submission outcomes
QUEUED = "queued"
REJECT_DUPLICATE_UID = "duplicate_uid"
REJECT_EMPTY_PROMPT = "empty_prompt"
REJECT_PROMPT_TOO_LONG = "prompt_too_long"
REJECT_POOL_IMPOSSIBLE = "pool_impossible"
REJECT_SAMPLING_CONFLICT = "sampling_conflict"
CLIENT_ERRORS = frozenset((
    REJECT_DUPLICATE_UID, REJECT_EMPTY_PROMPT, REJECT_PROMPT_TOO_LONG,
    REJECT_POOL_IMPOSSIBLE, REJECT_SAMPLING_CONFLICT,
))

STAT_NAMES = ("submitted", "finished", "failed", "cancelled", "admissions",
              "preemptions", "queue_wait_ticks", "prefill_chunks",
              "drafts_shed")  # draft sets dropped under pool pressure


@dataclass(frozen=True)
class SubmitResult:
    """What ``try_submit`` returns: ``accepted`` or a reason
    (``CLIENT_ERRORS``: the request is invalid outright).

    ``budget_blocks`` / ``budget_scope`` accompany ``REJECT_POOL_IMPOSSIBLE``:
    the KV-block budget the request was judged against and what it spans
    (``"replica_pool"``, or ``"replica_pool(aggregate over S seq shards)"``
    on a seq-sharded engine), so a caller can tell "too long for THIS
    configuration" (more ``seq_shards`` / ``num_blocks`` would serve it)
    from "too long ever" (``REJECT_PROMPT_TOO_LONG``)."""

    uid: int
    reason: str
    detail: str = ""
    budget_blocks: Optional[int] = None
    budget_scope: str = ""

    @property
    def accepted(self) -> bool:
        return self.reason == QUEUED


@dataclass
class ServeRequest:
    """Host-side lifecycle of one submitted generation request."""

    uid: int
    prompt: List[int]
    sampling: SamplingParams
    tokens: List[int]  # prefilled on (re)admission: prompt + generated so far
    state: str = WAITING
    generated: List[int] = field(default_factory=list)
    submit_tick: int = 0
    admit_tick: int = -1
    preemptions: int = 0
    denied_state: Optional[tuple] = None  # admission state at last failed probe
    error: Optional[str] = None


class ServeScheduler:
    def __init__(self, engine, prefill_chunk: Optional[int] = None,
                 kv_watermark: float = 0.0625, starvation_ticks: int = 32):
        self.engine = engine
        bs = engine.block_size
        chunk = min(prefill_chunk or engine.prefill_budget, engine.prefill_budget)
        self.prefill_chunk = max(bs, (chunk // bs) * bs)
        total = engine.mgr.allocator.total_blocks
        self._watermark_blocks = max(1, round(total * kv_watermark))
        self.kv_watermark = float(kv_watermark)
        self.starvation_ticks = starvation_ticks
        self.waiting: "deque[ServeRequest]" = deque()
        self.requests: Dict[int, ServeRequest] = {}
        self._running: List[ServeRequest] = []  # admission order
        self.tick_no = 0
        self._triple = None  # the batch's shared (temperature, top_k, top_p)
        self._uid_counter = 0
        # this tick's draft budget: the prefill chunk's leftover tokens
        self._spec_budget = self.prefill_chunk
        self.stats: Dict[str, int] = {name: 0 for name in STAT_NAMES}

    # -- request intake -----------------------------------------------------
    def next_uid(self) -> int:
        while True:
            self._uid_counter += 1
            uid = self._uid_counter
            if uid not in self.requests and uid not in self.engine.mgr.seqs:
                return uid

    def try_submit(self, uid: int, tokens: Sequence[int],
                   sampling: SamplingParams = SamplingParams()) -> SubmitResult:
        """Queue a request; never raises.  Capacity that only needs waiting
        queues; an invalid request returns its typed reason."""
        tokens = [int(t) for t in tokens]
        eng = self.engine
        if uid in self.requests or uid in eng.mgr.seqs:
            return SubmitResult(uid, REJECT_DUPLICATE_UID, f"uid {uid} already in use")
        if not tokens:
            return SubmitResult(uid, REJECT_EMPTY_PROMPT, "empty prompt")
        if len(tokens) >= eng.max_seq_len:
            return SubmitResult(
                uid, REJECT_PROMPT_TOO_LONG,
                f"prompt length {len(tokens)} leaves no room to generate "
                f"(max_seq_len {eng.max_seq_len})")
        # the request must fit the pool ALONE at its maximum length, or decode
        # growth eventually exhausts the pool with no victim left to preempt
        max_len = min(len(tokens) + sampling.max_new_tokens, eng.max_seq_len)
        blocks = -(-max_len // eng.block_size)
        # a replica's pool aggregates its seq shards (the sequence stripes
        # across all S slices): bigger contexts fit by raising seq_shards
        pool = eng.mgr.allocator.total_blocks // eng.mgr.replicas
        if blocks > pool:
            scope = ("replica_pool" if eng.mgr.seq_shards <= 1 else
                     f"replica_pool(aggregate over {eng.mgr.seq_shards} seq shards)")
            return SubmitResult(
                uid, REJECT_POOL_IMPOSSIBLE,
                f"prompt + max_new_tokens needs {blocks} KV blocks; a replica's pool "
                f"only has {pool} ({scope})", budget_blocks=pool, budget_scope=scope)
        triple = (sampling.temperature, sampling.top_k, sampling.top_p)
        if not self._running and not self.waiting:
            self._triple = triple
        elif triple != self._triple:
            return SubmitResult(
                uid, REJECT_SAMPLING_CONFLICT,
                f"sampling triple {triple} conflicts with the scheduled batch's "
                f"{self._triple} (one triple per dispatch)")
        req = ServeRequest(uid=uid, prompt=tokens, sampling=sampling,
                           tokens=list(tokens), submit_tick=self.tick_no)
        self.requests[uid] = req
        self.waiting.append(req)
        self.stats["submitted"] += 1
        return SubmitResult(uid, QUEUED)

    def submit(self, uid: int, tokens: Sequence[int],
               sampling: SamplingParams = SamplingParams()) -> SubmitResult:
        """Raising wrapper over :meth:`try_submit` (client errors raise
        ``ValueError``); capacity still queues."""
        res = self.try_submit(uid, tokens, sampling)
        if res.reason in CLIENT_ERRORS:
            raise ValueError(res.detail)
        return res

    def _base_sampling(self) -> SamplingParams:
        t, k, p = self._triple
        return SamplingParams(temperature=t, top_k=k, top_p=p)

    # -- the single release path --------------------------------------------
    def _release(self, req: ServeRequest, state: str, error: Optional[str] = None) -> None:
        """Move ``req`` to a terminal ``state`` from any live state,
        leak-free: frees its pages (full cached blocks retire to the prefix
        LRU) and removes it from whichever queue holds it."""
        if req.state in TERMINAL:
            return
        seq = self.engine.mgr.seqs.get(req.uid)
        if seq is not None:
            if error is None and seq.error is not None:
                error = seq.error
            self.engine.mgr.release(req.uid)
        if req in self._running:
            self._running.remove(req)
        if req in self.waiting:
            self.waiting.remove(req)
        req.state = state
        req.error = error
        self.stats[state] += 1

    def cancel(self, uid: int) -> bool:
        """Cancel a request from any non-terminal state.  False if unknown
        or already terminal."""
        req = self.requests.get(uid)
        if req is None or req.state in TERMINAL:
            return False
        self._release(req, CANCELLED)
        return True

    def close(self) -> None:
        """Cancel every live request and empty the queues (the scheduler
        half of ``engine.close()``).  Idempotent."""
        for req in list(self.requests.values()):
            self._release(req, CANCELLED)
        self.waiting.clear()
        self._running.clear()

    # -- admission ----------------------------------------------------------
    def _try_admit(self, req: ServeRequest) -> bool:
        mgr = self.engine.mgr
        if not mgr.free_slots:
            return False
        total_blocks = -(-len(req.tokens) // mgr.block_size)
        # tentative admit performs the prefix match (refs cached blocks);
        # roll it back if the fresh remainder does not fit the watermark
        snap = mgr.hit_stats_snapshot()
        seq = mgr.admit(req.uid, req.tokens)
        fresh = total_blocks - len(seq.blocks)
        # the watermark keeps decode-growth headroom while a batch runs; an
        # idle pool admits to the brim
        headroom = self._watermark_blocks if self._running else 0
        if fresh + headroom > mgr.allocator.available_blocks:
            mgr.release(req.uid)
            mgr.hit_stats_restore(snap)
            return False
        try:
            mgr.ensure_capacity(seq, 0)  # reserve every prompt page up front
        except RuntimeError:
            # a seq-sharded pool: one stripe is full behind aggregate headroom.
            # Roll back and wait for the running requests to free pages
            mgr.release(req.uid)
            mgr.hit_stats_restore(snap)
            return False
        req.state = PREFILL
        if req.admit_tick < 0:
            req.admit_tick = self.tick_no
            self.stats["queue_wait_ticks"] += self.tick_no - req.submit_tick
        self._running.append(req)
        self.stats["admissions"] += 1
        return True

    def _admit_phase(self) -> None:
        mgr = self.engine.mgr
        for req in list(self.waiting):
            if not mgr.free_slots:
                break
            # the outcome depends only on free slots, allocatable blocks and
            # cache contents: skip the prefix-walk probe when none moved
            # since this request was last denied
            state = (mgr.free_slots, mgr.allocator.available_blocks,
                     mgr.allocator.registrations)
            if req.denied_state != state and self._try_admit(req):
                self.waiting.remove(req)
            else:
                req.denied_state = state
                if self.tick_no - req.submit_tick >= self.starvation_ticks:
                    break  # aged request: nothing may jump the queue

    # -- prefill ------------------------------------------------------------
    def _prefill_phase(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        bs = self.engine.block_size
        mgr = self.engine.mgr
        budget = self.prefill_chunk
        entries = []
        for req in list(self._running):  # _release below mutates _running
            if req.state != PREFILL:
                continue
            if budget < bs:
                continue
            seq = mgr.seqs[req.uid]
            # pick up prefix blocks published since admission
            mgr.extend_match(seq)
            start = seq.seen_tokens
            remaining = len(seq.tokens) - start
            if remaining <= 0:
                # fully prefilled but unsampled: its row was poisoned
                self._release(req, FAILED, seq.error or "non-finite logits in prefill")
                continue
            take = min(remaining, budget)
            if take < remaining:
                take -= take % bs  # chunk boundaries stay page-aligned
                if take == 0:
                    continue
            entries.append((seq, start, start + take))
            budget -= take
        # drafting k tokens costs a k+1-row verify forward, so DRAFTED tokens
        # share the tick's headroom with prompt chunks: a tick saturated by
        # chunks speculates less
        self._spec_budget = max(0, budget)
        if not entries:
            return out
        first = self.engine.prefill_entries(entries, self._base_sampling())
        self.stats["prefill_chunks"] += len(entries)
        for req in list(self._running):
            if req.state == PREFILL and req.uid in first:
                tok = first[req.uid]
                if tok < 0:
                    self._release(req, FAILED,
                                  mgr.seqs[req.uid].error or "non-finite logits in prefill")
                    continue
                req.state = DECODE
                req.generated.append(tok)
                out[req.uid] = tok
                self._maybe_finish(req)
        return out

    # -- decode + preemption ------------------------------------------------
    def _pick_victim(self, exclude: ServeRequest) -> Optional[ServeRequest]:
        """Youngest preemptible request."""
        for req in reversed(self._running):
            if req is not exclude and req.state in (PREFILL, DECODE):
                return req
        return None

    def _preempt(self, req: ServeRequest) -> None:
        """Preemption by recompute: drop the sequence's pages (full ones stay
        in the prefix-cache LRU) and requeue at the FRONT with prompt = all
        tokens so far — re-prefill is then mostly cache hits."""
        seq = self.engine.mgr.seqs[req.uid]
        req.tokens = list(seq.tokens)
        self.engine.mgr.release(req.uid)
        self._running.remove(req)
        req.state = WAITING
        req.preemptions += 1
        self.waiting.appendleft(req)
        self.stats["preemptions"] += 1

    @property
    def _speculating(self) -> bool:
        return self.engine.enable_speculation

    def _remaining_emit(self, req: ServeRequest) -> int:
        """Tokens ``req`` may still emit: its ``max_new_tokens`` budget and
        the engine's ``max_seq_len`` headroom (>= 1 for a live DECODE
        request: anything at either cap finished last tick)."""
        seq = self.engine.mgr.seqs[req.uid]
        return max(1, min(req.sampling.max_new_tokens - len(req.generated),
                          self.engine.max_seq_len - seq.cur_len))

    def _plan_megastep(self, decoding: List[ServeRequest], proposals) -> int:
        """Decode ticks to fuse into ONE device burst this tick (JAX
        ``_plan_megastep`` without its deadline clamp: the port has no
        deadlines yet).  ``serve.decode_megastep`` is the ceiling; the plan
        is 1 whenever the tick has other work (waiting requests, running
        requests still in PREFILL, live speculation proposals), else the
        ceiling clamped to the largest remaining emission."""
        n = self.engine.serve.decode_megastep
        if n <= 1 or self.waiting:
            return 1
        live = [r for r in decoding if r.state == DECODE]
        if not live or any(r.state == PREFILL for r in self._running):
            return 1
        if self._speculating and proposals:
            return 1
        return max(1, min(n, max(self._remaining_emit(r) for r in live)))

    def _decode_phase(self, decoding: List[ServeRequest]) -> Dict[int, int]:
        out: Dict[int, int] = {}
        eng = self.engine
        mgr = eng.mgr
        # this tick's drafts, under the leftover chunk budget; each
        # request's remaining max_new_tokens clamps inside plan_speculation
        # so a clamped-away draft never debits the shared budget
        proposals: Dict[int, List[int]] = {}
        if self._speculating:
            live = [r for r in decoding if r.state == DECODE]
            proposals = eng.plan_speculation(
                [mgr.seqs[r.uid] for r in live],
                max_total_draft_tokens=self._spec_budget,
                max_emit={r.uid: r.sampling.max_new_tokens - len(r.generated) for r in live})
        # how many decode ticks this tick fuses into one device burst
        n_fuse = self._plan_megastep(decoding, proposals)
        for req in decoding:
            if req.state != DECODE:  # preempted by an earlier victim pick
                continue
            seq = mgr.seqs[req.uid]
            while True:
                # a megastep reserves each row's whole burst up front
                need = (min(n_fuse, self._remaining_emit(req)) if n_fuse > 1
                        else 1 + len(proposals.get(req.uid, ())))
                try:
                    mgr.ensure_capacity(seq, need)
                    mgr.ensure_writable(seq, seq.cur_len - 1)
                    break
                except RuntimeError:
                    # shed this request's own drafts before preempting
                    # anyone: speculation is optional, residency is not
                    if proposals.pop(req.uid, None):
                        self.stats["drafts_shed"] += 1
                        continue
                    if n_fuse > 1:
                        # pool pressure: collapse the megastep to one tick
                        # before evicting anyone (plain decode needs only
                        # one page of growth)
                        n_fuse = 1
                        continue
                    victim = self._pick_victim(exclude=req)
                    if victim is None:
                        raise RuntimeError(
                            "KV pool cannot hold even one growing sequence "
                            f"({mgr.allocator.total_blocks} blocks)") from None
                    # a preempted victim's drafts die with its pages
                    proposals.pop(victim.uid, None)
                    self._preempt(victim)
        survivors = [r for r in decoding if r.state == DECODE]
        if not survivors:
            return out
        seqs = [mgr.seqs[r.uid] for r in survivors]
        if n_fuse > 1:
            runs = eng._decode_burst(
                seqs, self._base_sampling(), n_fuse,
                max_emit={r.uid: self._remaining_emit(r) for r in survivors},
                stop_tokens={r.uid: r.sampling.stop_token for r in survivors})
        elif self._speculating:  # proposals hold survivors only: victims' were dropped
            runs = eng._spec_tick(seqs, self._base_sampling(), proposals)
        else:
            runs = {u: [t] for u, t in eng._decode_tick(seqs, self._base_sampling()).items()}
        for req in survivors:
            emitted = runs[req.uid]
            if not emitted:
                continue  # no emission headroom this burst
            if emitted[-1] < 0:
                self._release(req, FAILED,
                              mgr.seqs[req.uid].error or "non-finite logits in decode")
                continue
            emitted = eng.cut_at_stop(mgr.seqs[req.uid], emitted, req.sampling.stop_token)
            req.generated.extend(emitted)
            out[req.uid] = emitted[-1]
            self._maybe_finish(req)
        return out

    # -- completion ---------------------------------------------------------
    def _maybe_finish(self, req: ServeRequest) -> None:
        samp = req.sampling
        seq = self.engine.mgr.seqs[req.uid]
        if ((samp.stop_token is not None and req.generated[-1] == samp.stop_token)
                or len(req.generated) >= samp.max_new_tokens
                or seq.cur_len >= self.engine.max_seq_len):
            self._release(req, FINISHED)

    def result(self, uid: int) -> List[int]:
        """Generated tokens: trailing stop token stripped, capped at
        ``max_new_tokens``.  Terminal requests stay in ``requests`` until
        ``pop_result``."""
        req = self.requests[uid]
        toks = list(req.generated)
        samp = req.sampling
        if samp.stop_token is not None and toks and toks[-1] == samp.stop_token:
            toks = toks[:-1]
        return toks[: samp.max_new_tokens]

    def pop_result(self, uid: int) -> List[int]:
        toks = self.result(uid)
        del self.requests[uid]
        return toks

    # -- the loop -----------------------------------------------------------
    @property
    def idle(self) -> bool:
        return not self.waiting and not self._running

    def tick(self) -> Dict[int, int]:
        """One tick: admission -> chunked prefill -> decode.  Returns the
        newest token per request that emitted one (a request finishing its
        prefill emits its first token and decodes from the NEXT tick)."""
        self.tick_no += 1
        self._admit_phase()
        decoding = [r for r in self._running if r.state == DECODE]
        out = self._prefill_phase()
        out.update(self._decode_phase(decoding))
        return out

    def run(self, wait_for: Optional[Sequence[int]] = None,
            max_ticks: int = 1_000_000) -> Dict[int, List[int]]:
        """Tick until every request (or every uid in ``wait_for``) is
        terminal; returns {uid: result}."""
        def pending() -> bool:
            if wait_for is not None:
                return any(self.requests[u].state not in TERMINAL for u in wait_for)
            return not self.idle

        ticks = stalled = 0
        while pending():
            if ticks >= max_ticks:
                raise RuntimeError(f"no convergence after {max_ticks} ticks")
            self.tick()
            ticks += 1
            # nothing running and nothing admittable: the pool/slots are held
            # outside the scheduler (put()-admitted sequences)
            stalled = stalled + 1 if (not self._running and self.waiting) else 0
            if stalled > 1000:
                raise RuntimeError(
                    "scheduler stalled: waiting requests cannot be admitted "
                    "(KV blocks/slots held by sequences outside the scheduler)")
        uids = wait_for if wait_for is not None else [
            u for u, r in self.requests.items() if r.state in TERMINAL]
        return {u: self.result(u) for u in uids}
