"""The race analysis' dynamic half: a seeded deterministic-interleaving
harness — counterpart of ``deepspeed_tpu/analysis/schedviz.py``, driving
the port's serving stack.

CHESS-style bounded schedule exploration (PAPERS.md, systematic concurrency
testing) for the host-side serving stack: a cooperative scheduler runs each
"thread" of a scenario as a real OS thread but gates them so EXACTLY ONE
runs at a time, switching only at explicit preemption points — cooperative
lock acquire/release, condition wait/notify, and :func:`checkpoint` calls.
A seeded RNG drives every scheduling choice, so a schedule is a pure
function of ``(seed, max_preemptions, preempt_p)``: a failing interleaving
replays exactly, forever, from its seed.

Pieces:

- :class:`Schedule` — spawn tasks, ``run()`` to completion.  Detects
  deadlock (every live task blocked) and reports who holds/awaits what.
  ``instrument()`` monkeypatches ``threading.Lock`` / ``RLock`` /
  ``Condition`` / ``Thread`` for the duration, so objects CONSTRUCTED
  inside the context (a ``Telemetry``, a ``ServeScheduler``) get
  cooperative primitives — every lock the code under test takes becomes an
  interleaving point, which is exactly where GIL preemption bites real
  threads.  Outside a managed task the cooperative primitives degrade to
  plain uncontended locks, so instrumented objects keep working after the
  run.
- :func:`explore` — sweep a scenario over many seeds (bounded preemption
  a la CHESS: ``max_preemptions`` caps forced switches per schedule;
  blocking switches are always allowed), collecting per-seed failures.
- :class:`HostStubEngine` — a host-only engine double (allocator, sequence
  descriptors, deterministic prefill/decode) good enough to drive the REAL
  ``ServeScheduler``/``Router`` through thousands of schedules in
  milliseconds, on no device.
- ``scenario_*`` — the hot concurrent scenarios the serve stack must
  survive: telemetry namespace claim/drop vs snapshot,
  submit-vs-tick-vs-cancel, shed-mode entry/exit vs watchdog,
  worker-kill-vs-route, prefix-cached admission, heartbeat expiry vs
  route, cancel-vs-megastep (cancels landing while the scheduler fuses
  decode ticks into one burst), retune vs tick and a metrics pull vs a
  worker death.  Each raises ``AssertionError`` on an invariant
  violation; :func:`run_scenarios` aggregates them for the tier-1 gate
  (``tests/test_torch_analysis.py``).
"""
from __future__ import annotations

import random
import threading as _threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

# real primitives captured BEFORE any instrumentation
_REAL_LOCK = _threading.Lock
_REAL_RLOCK = _threading.RLock
_REAL_CONDITION = _threading.Condition
_REAL_THREAD = _threading.Thread
_REAL_EVENT = _threading.Event
_REAL_SEMAPHORE = _threading.Semaphore

_ACTIVE: Optional["Schedule"] = None  # the schedule currently instrumenting
# task lookup by OS thread: a cooperative primitive must bind to the
# schedule that owns the CALLING task, not whichever schedule happens to
# be instrumenting — two Schedules may legitimately coexist (a scenario's
# claim phase and its release phase), and a task of the second must keep
# interleaving even while the first holds the instrument() patch
_TASK_BY_THREAD: Dict[Any, "_Task"] = {}


@contextmanager
def _unpatched():
    """Temporarily restore the real ``threading`` primitives (no-op when
    nothing is patched) — for scheduler-internal machinery that must stay
    on OS primitives even inside an ``instrument()`` context."""
    saved = (_threading.Lock, _threading.RLock, _threading.Condition,
             _threading.Thread)
    (_threading.Lock, _threading.RLock, _threading.Condition,
     _threading.Thread) = (_REAL_LOCK, _REAL_RLOCK, _REAL_CONDITION,
                           _REAL_THREAD)
    try:
        yield
    finally:
        (_threading.Lock, _threading.RLock, _threading.Condition,
         _threading.Thread) = saved


class DeadlockError(RuntimeError):
    """Every live task is blocked — the report lists who holds/awaits what."""


class ScheduleTimeout(RuntimeError):
    """A task ran too long between preemption points (runaway loop)."""


class _TaskCancelled(BaseException):
    """Raised INSIDE a parked task when its schedule aborts (deadlock /
    timeout): unwinds the task thread so a failing schedule leaks no
    parked OS threads.  BaseException so scenario-code ``except
    Exception`` cannot swallow the unwind."""


class _JoinWait:
    def __init__(self, target: "_Task"):
        self.target = target

    def ready(self) -> bool:
        return self.target.done

    def __str__(self) -> str:
        return f"join({self.target.name})"


class _CondWait:
    def __init__(self, cond: "CoopCondition", timed: bool):
        self.cond = cond
        self.timed = timed  # a timed wait may legally expire at "deadlock"
        self.notified = False
        self.timed_out = False

    def ready(self) -> bool:
        return self.notified or self.timed_out

    def __str__(self) -> str:
        return f"wait({self.cond!r})"


class _Task:
    def __init__(self, sched: "Schedule", tid: int, fn: Callable,
                 args: tuple, kwargs: dict, name: Optional[str]):
        self.sched = sched
        self.tid = tid
        self.name = name or f"task{tid}"
        self.gate = _REAL_EVENT()
        self.done = False
        self.blocked_on: Any = None  # None | CoopLock | _JoinWait | _CondWait
        self.error: Optional[BaseException] = None
        self.result: Any = None
        self._fn, self._args, self._kwargs = fn, args, kwargs
        self.thread = _REAL_THREAD(
            target=self._main, name=f"schedviz-{self.name}", daemon=True)

    def _main(self) -> None:
        _TASK_BY_THREAD[_threading.current_thread()] = self
        self.gate.wait()
        self.gate.clear()
        try:
            if not self.sched._poison:
                self.result = self._fn(*self._args, **self._kwargs)
        except _TaskCancelled:
            pass  # schedule aborted: unwind quietly, run() already raised
        except BaseException as e:  # noqa: BLE001 — re-raised by run()
            self.error = e
        finally:
            self.done = True
            _TASK_BY_THREAD.pop(_threading.current_thread(), None)
            self.sched._sem.release()

    def runnable(self) -> bool:
        if self.done:
            return False
        b = self.blocked_on
        if b is None:
            return True
        if isinstance(b, CoopLock):
            return b._owner is None
        return b.ready()


class Schedule:
    """One deterministic cooperative schedule.

    ``seed`` drives every choice; ``max_preemptions`` bounds FORCED
    context switches per schedule (CHESS-style — switches at blocking
    points are always allowed and never counted); ``preempt_p`` is the
    per-preemption-point switch probability.
    """

    def __init__(self, seed: int = 0, max_preemptions: Optional[int] = None,
                 preempt_p: float = 0.5):
        self.seed = seed
        self.rng = random.Random(seed)
        self.max_preemptions = max_preemptions
        self.preempt_p = preempt_p
        self.preemptions = 0
        self._poison = False  # set by _abort(): parked tasks unwind
        self.tasks: List[_Task] = []
        self.current: Optional[_Task] = None
        # Semaphore builds its Condition from threading globals at call
        # time — keep the scheduler's own token on real primitives even
        # when THIS Schedule is constructed inside another's instrument()
        with _unpatched():
            self._sem = _REAL_SEMAPHORE(0)
        self.trace: List[int] = []  # tid per scheduling decision (replayable)

    # -- task surface -------------------------------------------------------
    def spawn(self, fn: Callable, *args, name: Optional[str] = None,
              **kwargs) -> _Task:
        # stdlib Event/Thread resolve Condition/Lock from the threading
        # module AT CALL TIME, so the task's own gate and the OS thread's
        # bootstrap event must be constructed with the patching lifted —
        # otherwise the scheduler machinery itself becomes cooperative and
        # deadlocks on "wait outside a managed task".  The window cannot
        # race: either no task is running yet, or the one spawning task
        # holds the execution token.
        with _unpatched():
            t = _Task(self, len(self.tasks), fn, args, kwargs, name)
            self.tasks.append(t)
            t.thread.start()
        return t

    def current_task(self) -> Optional[_Task]:
        cur = self.current
        if cur is not None and _threading.current_thread() is cur.thread:
            return cur
        return None

    # -- preemption machinery (called from task threads) --------------------
    def _abort(self) -> None:
        """Poison the schedule and wake every parked task so its thread
        unwinds (via :class:`_TaskCancelled`) instead of waiting forever
        on a gate nobody will ever set again."""
        self._poison = True
        for t in self.tasks:
            if not t.done:
                t.gate.set()

    def _switch(self) -> None:
        """Unconditionally yield to the scheduler until rescheduled."""
        me = self.current_task() or self.current
        self._sem.release()
        me.gate.wait()
        me.gate.clear()
        if self._poison:
            raise _TaskCancelled()

    def _maybe_preempt(self) -> None:
        """Bounded random preemption point: switch with ``preempt_p`` while
        the forced-preemption budget lasts.  On a poisoned schedule this is
        an unwind point: a task reaching it after an abort dies here."""
        if self.current_task() is None:
            return
        if self._poison:
            raise _TaskCancelled()
        if self.max_preemptions is not None \
                and self.preemptions >= self.max_preemptions:
            return
        others = [t for t in self.tasks
                  if t is not self.current and t.runnable()]
        if others and self.rng.random() < self.preempt_p:
            self.preemptions += 1
            self._switch()

    # -- the scheduler loop -------------------------------------------------
    def _deadlock_report(self) -> str:
        lines = ["deterministic schedule deadlocked "
                 f"(seed={self.seed}, trace={self.trace}):"]
        for t in self.tasks:
            if t.done:
                continue
            b = t.blocked_on
            if isinstance(b, CoopLock):
                owner = b._owner.name if b._owner is not None else "nobody"
                lines.append(f"  {t.name}: awaits {b!r} held by {owner}")
            else:
                lines.append(f"  {t.name}: awaits {b}")
        return "\n".join(lines)

    def run(self, timeout: float = 60.0,
            max_decisions: int = 1_000_000) -> None:
        """Drive every task to completion.  Raises the first task error,
        :class:`DeadlockError` when all live tasks block, or
        :class:`ScheduleTimeout`.  ``timeout`` is PER PREEMPTION WINDOW —
        the longest one task may run between two scheduling points (the
        runaway-loop guard); long schedules that keep making progress
        never trip it.  ``max_decisions`` bounds total scheduling points
        (the unbounded-ping-pong guard).  Both failure paths poison the
        schedule so parked task threads unwind instead of leaking."""
        while any(not t.done for t in self.tasks):
            runnable = [t for t in self.tasks if t.runnable()]
            if not runnable:
                # expire ONE timed condition wait before declaring deadlock
                timed = [t for t in self.tasks if not t.done
                         and isinstance(t.blocked_on, _CondWait)
                         and t.blocked_on.timed]
                if timed:
                    timed[0].blocked_on.timed_out = True
                    continue
                try:
                    raise DeadlockError(self._deadlock_report())
                finally:
                    self._abort()
            if len(self.trace) >= max_decisions:
                self._abort()
                raise ScheduleTimeout(
                    f"schedule made {max_decisions} scheduling decisions "
                    f"without completing (seed={self.seed}) — "
                    "livelock/ping-pong?")
            nxt = runnable[0] if len(runnable) == 1 else self.rng.choice(runnable)
            self.current = nxt
            self.trace.append(nxt.tid)
            nxt.gate.set()
            if not self._sem.acquire(timeout=timeout):
                self._abort()
                raise ScheduleTimeout(
                    f"task {nxt.name} ran > {timeout}s without reaching a "
                    "preemption point (runaway loop?)")
            self.current = None
        for t in self.tasks:
            if t.error is not None:
                raise t.error

    # -- instrumentation ----------------------------------------------------
    @contextmanager
    def instrument(self):
        """Patch ``threading.Lock/RLock/Condition/Thread`` so objects
        constructed inside the context use cooperative primitives.  Also
        covers stdlib machinery that builds on them at call time
        (``queue.Queue``, ``threading.Event``)."""
        global _ACTIVE
        prev_active = _ACTIVE
        saved = (_threading.Lock, _threading.RLock, _threading.Condition,
                 _threading.Thread)
        _ACTIVE = self
        _threading.Lock = CoopLock  # type: ignore[assignment, misc]
        _threading.RLock = CoopRLock  # type: ignore[assignment, misc]
        _threading.Condition = CoopCondition  # type: ignore[assignment, misc]
        _threading.Thread = CoopThread  # type: ignore[assignment, misc]
        try:
            yield self
        finally:
            (_threading.Lock, _threading.RLock, _threading.Condition,
             _threading.Thread) = saved
            _ACTIVE = prev_active


def _current() -> tuple:
    task = _TASK_BY_THREAD.get(_threading.current_thread())
    if task is not None and not task.done:
        return task.sched, task
    if _ACTIVE is not None:
        # instrumenting but called from a non-task thread (construction,
        # post-run assertions): external/uncontended mode
        return _ACTIVE, None
    return None, None


def checkpoint() -> None:
    """Explicit preemption point — no-op outside a managed task.  Sprinkle
    into scenario code (or planted-bug reproductions) to model an arbitrary
    GIL switch between two host operations."""
    sched, task = _current()
    if task is not None:
        sched._maybe_preempt()


class CoopLock:
    """Cooperative ``threading.Lock``: acquire/release are preemption
    points; contention parks the task until the owner releases.  Outside a
    managed run (construction time, post-run assertions) it degrades to an
    uncontended flag."""

    _REENTRANT = False

    def __init__(self):
        self._owner: Any = None
        self._count = 0
        self.name: Optional[str] = None

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name or hex(id(self))})"

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        sched, task = _current()
        if task is None:
            # serialized-by-construction context: model an uncontended lock
            if self._owner is not None:
                raise RuntimeError(
                    f"{self!r} contended outside a managed schedule")
            self._owner = "<external>"
            self._count = 1
            return True
        sched._maybe_preempt()  # interleaving point BEFORE the acquire
        while self._owner is not None:
            if self._owner is task:
                if self._REENTRANT:
                    self._count += 1
                    return True
                raise DeadlockError(
                    f"{task.name} re-acquires non-reentrant {self!r} it "
                    "already holds (seed replays deterministically: "
                    f"seed={sched.seed})")
            if not blocking:
                return False
            task.blocked_on = self
            sched._switch()
            task.blocked_on = None
        self._owner = task
        self._count = 1
        return True

    def release(self) -> None:
        _sched, task = _current()
        if self._owner is None:
            raise RuntimeError(f"release of unheld {self!r}")
        # same contract as the real primitives: only the owner may
        # release — a wrong-thread or unbalanced release is a bug the
        # harness must surface, not absorb (it would quietly open the
        # critical section to another task mid-schedule)
        holder = self._owner
        if task is not None and holder is not task:
            holder_name = getattr(holder, "name", holder)
            raise RuntimeError(
                f"{task.name} releases {self!r} held by {holder_name}")
        if task is None and holder != "<external>":
            raise RuntimeError(
                f"external release of {self!r} held by "
                f"{getattr(holder, 'name', holder)}")
        self._count -= 1
        if self._count == 0:
            self._owner = None
            if task is not None:
                task.sched._maybe_preempt()

    def locked(self) -> bool:
        return self._owner is not None

    def __enter__(self) -> "CoopLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class CoopRLock(CoopLock):
    _REENTRANT = True


class CoopCondition:
    """Cooperative ``threading.Condition`` over a :class:`CoopLock`."""

    def __init__(self, lock: Optional[CoopLock] = None):
        self._lock = lock if lock is not None else CoopRLock()
        self._waiters: List[_CondWait] = []

    acquire = property(lambda self: self._lock.acquire)
    release = property(lambda self: self._lock.release)

    def __enter__(self) -> "CoopCondition":
        self._lock.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self._lock.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        sched, task = _current()
        if task is None:
            raise RuntimeError("CoopCondition.wait outside a managed task")
        if self._lock._owner is not task:
            raise RuntimeError("wait() on un-acquired condition")
        saved, self._lock._count = self._lock._count, 1
        self._lock.release()  # full release regardless of recursion depth
        waiter = _CondWait(self, timed=timeout is not None)
        self._waiters.append(waiter)
        task.blocked_on = waiter
        sched._switch()
        task.blocked_on = None
        if waiter in self._waiters:
            self._waiters.remove(waiter)
        self._lock.acquire()
        self._lock._count = saved
        return waiter.notified

    def notify(self, n: int = 1) -> None:
        for w in self._waiters[:n]:
            w.notified = True
        del self._waiters[:n]

    def notify_all(self) -> None:
        self.notify(len(self._waiters))

    wait_for = None  # unsupported; loud AttributeError beats silent wrong


class CoopThread:
    """Cooperative ``threading.Thread``: ``start()`` registers the target
    as a task on the active schedule; ``join()`` parks cooperatively."""

    def __init__(self, group=None, target=None, name=None, args=(),
                 kwargs=None, daemon=None):
        self._target = target
        self._name = name
        self._args = args
        self._kwargs = kwargs or {}
        self.daemon = daemon
        self._task: Optional[_Task] = None

    def start(self) -> None:
        sched = _ACTIVE
        if sched is None:
            raise RuntimeError("CoopThread.start outside an instrumented "
                               "schedule")
        self._task = sched.spawn(self._target, *self._args,
                                 name=self._name, **self._kwargs)

    def is_alive(self) -> bool:
        return self._task is not None and not self._task.done

    def join(self, timeout: Optional[float] = None) -> None:
        sched, task = _current()
        if self._task is None:
            return
        if task is None:
            self._task.thread.join(timeout)
            return
        while not self._task.done:
            task.blocked_on = _JoinWait(self._task)
            sched._switch()
            task.blocked_on = None


def explore(scenario: Callable[..., Any], seeds: Iterable[int] = range(16),
            **kw) -> Dict[str, Any]:
    """Run ``scenario(seed, **kw)`` over every seed; collect failures.
    The report is JSON-able."""
    seeds = list(seeds)
    failures: Dict[int, str] = {}
    for seed in seeds:
        try:
            scenario(seed, **kw)
        except Exception as e:  # noqa: BLE001 — the report IS the result
            failures[seed] = f"{type(e).__name__}: {e}"
    return {
        "scenario": getattr(scenario, "__name__", str(scenario)),
        "schedules": len(seeds),
        "failures": {str(k): v for k, v in failures.items()},
        "passed": not failures,
    }


# ---------------------------------------------------------------------------
# host-only engine double: drives the REAL scheduler/router on no device
# ---------------------------------------------------------------------------
class _StubAllocator:
    def __init__(self, total_blocks: int):
        self.total_blocks = total_blocks
        self.available_blocks = total_blocks
        self.registrations = 0


class _StubSeq:
    def __init__(self, uid: int, tokens: List[int]):
        self.uid = uid
        self.tokens = list(tokens)
        self.seen_tokens = 0
        self.blocks: List[int] = []
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.error: Optional[str] = None

    @property
    def cur_len(self) -> int:
        return len(self.tokens)


class _StubMgr:
    """Paged-KV state-manager double: slot/block accounting only (the
    scenario invariants are about leaks and lifecycle, not attention)."""

    def __init__(self, block_size: int, num_blocks: int, max_seqs: int):
        self.block_size = block_size
        self.max_seqs = max_seqs
        self.replicas = 1
        self.seqs: Dict[int, _StubSeq] = {}
        self.allocator = _StubAllocator(num_blocks)
        self.allocators = [self.allocator]
        self.prompt_tokens_total = 0
        self.cached_prompt_tokens = 0

    def per_replica_token_budget(self, total: int) -> int:
        return total  # replicas == 1

    def hit_stats_snapshot(self) -> tuple:
        return (self.prompt_tokens_total, self.cached_prompt_tokens)

    def hit_stats_restore(self, snap: tuple) -> None:
        self.prompt_tokens_total, self.cached_prompt_tokens = snap

    @property
    def free_slots(self) -> int:
        return self.max_seqs - len(self.seqs)

    def admit(self, uid: int, tokens: Sequence[int],
              match_prefix: bool = True) -> _StubSeq:
        seq = _StubSeq(uid, list(tokens))
        self.seqs[uid] = seq
        self.prompt_tokens_total += len(tokens)
        return seq

    def _blocks_needed(self, seq: _StubSeq, extra: int) -> int:
        total = -(-(len(seq.tokens) + extra) // self.block_size)
        return total - len(seq.blocks)

    def ensure_capacity(self, seq: _StubSeq, extra: int) -> None:
        need = self._blocks_needed(seq, extra)
        if need > self.allocator.available_blocks:
            raise RuntimeError(
                f"stub pool exhausted: need {need}, have "
                f"{self.allocator.available_blocks}")
        self.allocator.available_blocks -= need
        seq.blocks.extend(range(need))
        self.allocator.registrations += 1

    def ensure_writable(self, seq: _StubSeq, idx: int) -> None:
        pass

    def extend_match(self, seq: _StubSeq) -> None:
        pass

    def release(self, uid: int) -> None:
        seq = self.seqs.pop(uid, None)
        if seq is not None:
            self.allocator.available_blocks += len(seq.blocks)
            seq.blocks = []

    def _alloc_of(self, seq: _StubSeq) -> _StubAllocator:
        return self.allocator

    def replica_of(self, seq: _StubSeq) -> int:
        return 0


class HostStubEngine:
    """Host-only ``InferenceEngineV2`` double for interleaving scenarios:
    deterministic prefill/decode over stub sequences, the real telemetry
    namespace protocol (group claim + release), no device."""

    def __init__(self, telemetry=None, block_size: int = 8,
                 num_blocks: int = 64, max_seqs: int = 4,
                 max_seq_len: int = 128, prefill_budget: int = 64):
        from ..telemetry import Telemetry

        self.telemetry = Telemetry.ensure(telemetry)
        self.block_size = block_size
        self.max_seq_len = max_seq_len
        self.prefill_budget = prefill_budget
        self.prefill_chunk = prefill_budget
        self.serve_replicas = 1
        self.enable_speculation = False
        self.spec_max_draft = 4
        self.kv_watermark = 0.0625
        self.faults = None
        self.mgr = _StubMgr(block_size, num_blocks, max_seqs)
        self._ns, self._sched_ns = self.telemetry.claim_prefixes(
            ("serve", "sched"))
        # the serve-namespace counters the scheduler's fault layer shares
        self.stats_counters = self.telemetry.counters(self._ns, (
            "failed", "timed_out", "cancelled", "retries", "nan_failures",
            "isolation_probes", "shed_transitions", "shed_rejections",
            "watchdog_trips",
        ))
        self.scheduler = None  # attached by the scenario after construction
        self._closed = False

    def _tok(self, seq: _StubSeq) -> int:
        return (seq.uid + len(seq.tokens)) % 97 + 1

    def prefill_entries(self, entries, sampling) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for seq, start, end in entries:
            seq.seen_tokens = end
            if end == len(seq.tokens):  # fully prefilled: sample first token
                tok = self._tok(seq)
                seq.tokens.append(tok)
                out[seq.uid] = tok
        return out

    def _decode_tick(self, seqs, sampling) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for seq in seqs:
            tok = self._tok(seq)
            seq.tokens.append(tok)
            seq.seen_tokens = len(seq.tokens) - 1
            out[seq.uid] = tok
        return out

    def _decode_burst(self, seqs, sampling, n, max_emit=None,
                      stop_tokens=None) -> Dict[int, List[int]]:
        """Megastep burst double: same per-row contract as the real
        ``InferenceEngineV2._decode_burst`` — up to ``n`` emissions per
        row, clamped by ``max_emit`` and the engine length cap, stopping
        a row early (stop token INCLUDED, like ``step()``) when its
        per-request stop fires."""
        out: Dict[int, List[int]] = {}
        for seq in seqs:
            cap = min(n, self.max_seq_len - seq.cur_len)
            if max_emit is not None and seq.uid in max_emit:
                cap = min(cap, max_emit[seq.uid])
            stop = (stop_tokens or {}).get(seq.uid)
            run: List[int] = []
            for _ in range(max(0, cap)):
                tok = self._tok(seq)
                seq.tokens.append(tok)
                run.append(tok)
                if stop is not None and tok == stop:
                    break
            seq.seen_tokens = len(seq.tokens) - 1
            out[seq.uid] = run
        return out

    def plan_speculation(self, seqs, **kw) -> Dict[int, list]:
        return {}

    @staticmethod
    def cut_at_stop(seq, run: List[int], stop_token: Optional[int]) -> List[int]:
        """The real engine's stop cut: ``run`` up to and including the first
        ``stop_token``, the tokens past it dropped from the descriptor."""
        if stop_token is None or stop_token not in run:
            return run
        cut = len(run) - run.index(stop_token) - 1
        if cut:
            del seq.tokens[-cut:]
            seq.seen_tokens = min(seq.seen_tokens, seq.cur_len - 1)
        return run[:len(run) - cut]

    def apply_knobs(self, *, enable_speculation=None, spec_max_draft=None,
                    kv_watermark=None, prefill_chunk=None) -> Dict[str, Any]:
        """Live-retune double: same validate-then-apply contract as the
        real ``InferenceEngineV2.apply_knobs`` (including the spec-on
        drain gate), so the retune-vs-tick scenario exercises the genuine
        scheduler staging path."""
        spec_on = (self.enable_speculation if enable_speculation is None
                   else bool(enable_speculation))
        draft = (self.spec_max_draft if spec_max_draft is None
                 else int(spec_max_draft))
        if spec_on and draft < 1:
            raise ValueError("spec_max_draft must be >= 1 when speculating")
        if spec_on and not self.enable_speculation \
                and self.scheduler is not None and not self.scheduler.idle:
            raise ValueError("enable_speculation can only turn on while "
                             "the scheduler is drained")
        if kv_watermark is not None \
                and not 0.0 <= float(kv_watermark) < 1.0:
            raise ValueError(f"kv_watermark must be in [0, 1), "
                             f"got {kv_watermark}")
        if prefill_chunk is not None and int(prefill_chunk) < 1:
            raise ValueError(f"prefill_chunk must be >= 1, "
                             f"got {prefill_chunk}")
        applied: Dict[str, Any] = {}
        if enable_speculation is not None:
            self.enable_speculation = bool(enable_speculation)
            applied["enable_speculation"] = self.enable_speculation
        if spec_max_draft is not None:
            self.spec_max_draft = int(spec_max_draft)
            applied["spec_max_draft"] = self.spec_max_draft
        if kv_watermark is not None:
            self.kv_watermark = float(kv_watermark)
            applied["kv_watermark"] = self.kv_watermark
        if prefill_chunk is not None:
            self.prefill_chunk = int(prefill_chunk)
            applied["prefill_chunk"] = self.prefill_chunk
        return applied

    def close(self) -> Dict[str, int]:
        if not self._closed:
            self._closed = True
            if self.scheduler is not None:
                self.scheduler.close()
            for uid in list(self.mgr.seqs):
                self.mgr.release(uid)
            for ns in (self._ns, self._sched_ns):
                self.telemetry.release_prefix(ns)
        used = (self.mgr.allocator.total_blocks
                - self.mgr.allocator.available_blocks)
        return {"blocks_in_use": used, "leaked_arrays": 0}


def _stub_scheduler(telemetry=None, serve=None, **engine_kw):
    """A real ``ServeScheduler`` over a :class:`HostStubEngine`."""
    from ..inference.scheduler import ServeScheduler

    eng = HostStubEngine(telemetry=telemetry, **engine_kw)
    sched = ServeScheduler(eng, serve=serve)
    eng.scheduler = sched
    return eng, sched


# ---------------------------------------------------------------------------
# the hot concurrent scenarios (each raises AssertionError on violation)
# ---------------------------------------------------------------------------
def scenario_namespace_claims(seed: int, claimants: int = 3) -> None:
    """Telemetry ``claim_prefix``/``release_prefix``/``drop_prefix`` vs
    ``snapshot``: N engine-shaped claimants grab (serve, sched) namespace
    PAIRS concurrently, register counters, count, snapshot races everything,
    then everyone releases.  Invariants: pairs are suffix-consistent and
    collision-free; a claimant's counters are never dropped by ANOTHER
    claimant's release; the namespace map drains empty."""
    import math

    from ..telemetry import Telemetry

    sched = Schedule(seed, max_preemptions=24)
    with sched.instrument():
        tel = Telemetry(True)
        claims: List[tuple] = []

        def claimant(i: int) -> None:
            ns, sns = tel.claim_prefixes(("serve", "sched"))
            c = tel.counters(ns, ("ticks",))
            for _ in range(3):
                c["ticks"].inc()
            claims.append((i, ns, sns, c["ticks"]))

        def snapshotter() -> None:
            for _ in range(4):
                for name, value, _step in tel.registry.snapshot():
                    assert math.isfinite(value), (name, value)
                checkpoint()

        for i in range(claimants):
            sched.spawn(claimant, i, name=f"claimant{i}")
        sched.spawn(snapshotter, name="snapshot")
        sched.run()

        assert len(claims) == claimants
        pairs = {(ns, sns) for _i, ns, sns, _c in claims}
        assert len(pairs) == claimants, f"namespace collision: {sorted(pairs)}"
        for _i, ns, sns, _c in claims:
            # group claim keeps the pairing suffix-consistent: serve2<->sched2
            assert sns == "sched" + ns[len("serve"):], (ns, sns)
        for _i, ns, _sns, counter in claims:
            # counters survive other claimants' churn until OUR release
            assert counter.value == 3, (ns, counter.value)
            assert tel.registry.get(f"{ns}/ticks") is counter, ns

        def releaser(i: int) -> None:
            _, ns, sns, _ = claims[i]
            tel.release_prefix(ns)
            tel.release_prefix(sns)

        rel = Schedule(seed + 1, max_preemptions=24)
        for i in range(claimants):
            rel.spawn(releaser, i, name=f"release{i}")
        rel.run()
        for _i, ns, _sns, _c in claims:
            assert tel.registry.get(f"{ns}/ticks") is None, ns
        assert tel.claim_prefix("serve") == "serve"  # map fully drained


def scenario_submit_tick_cancel(seed: int, n_requests: int = 4) -> None:
    """Client submits (mixed sampling triples) and cancels race the owner
    tick loop.  Invariants: every queued/running request shares ONE
    sampling triple at every interleaving point; every accepted request
    reaches exactly one terminal state; zero blocks leak."""
    from ..inference.sampling import SamplingParams
    from ..inference.scheduler import TERMINAL

    sched = Schedule(seed, max_preemptions=32)
    with sched.instrument():
        eng, ss = _stub_scheduler()
        accepted: List[int] = []

        def triple_invariant() -> None:
            live = list(ss.waiting) + list(ss._running)
            triples = {(r.sampling.temperature, r.sampling.top_k,
                        r.sampling.top_p) for r in live}
            assert len(triples) <= 1, (
                f"conflicting sampling triples co-scheduled: {triples}")

        def submitter() -> None:
            for i in range(n_requests):
                temp = 0.0 if i % 2 == 0 else 0.7  # conflicting triples
                res = ss.try_submit(
                    100 + i, [1, 2, 3, 4, 5],
                    SamplingParams(temperature=temp, max_new_tokens=3))
                triple_invariant()
                if res.accepted:
                    accepted.append(100 + i)
                else:
                    assert res.reason == "sampling_conflict", res

        def ticker() -> None:
            for _ in range(10):
                ss.tick()
                triple_invariant()

        def canceller() -> None:
            ss.cancel(101)
            ss.cancel(999)  # unknown uid: must be a quiet no-op
            triple_invariant()

        sched.spawn(submitter, name="submit")
        sched.spawn(ticker, name="tick")
        sched.spawn(canceller, name="cancel")
        sched.run()

        for _ in range(64):  # drain on the owner thread
            if all(ss.requests[u].state in TERMINAL for u in accepted):
                break
            ss.tick()
        states = {u: ss.requests[u].state for u in accepted}
        assert all(s in TERMINAL for s in states.values()), states
        for u in accepted:
            ss.pop_result(u)
        alloc = eng.mgr.allocator
        assert alloc.available_blocks == alloc.total_blocks, (
            f"leak: {alloc.total_blocks - alloc.available_blocks} blocks")


def scenario_shed_watchdog(seed: int) -> None:
    """Shed-mode entry/exit vs a submit storm: the queue-depth detector
    flips shed mode while clients keep submitting.  Invariants: every
    ``retry_after_ms`` hint is finite and positive, rejections are typed,
    shed mode exits once the queue drains, nothing leaks."""
    import math

    from ..config.config import ServeConfig
    from ..inference.sampling import SamplingParams
    from ..inference.scheduler import RETRY_LATER

    sched = Schedule(seed, max_preemptions=32)
    with sched.instrument():
        eng, ss = _stub_scheduler(
            serve=ServeConfig(shed_queue_depth=2), max_seqs=2)
        outcomes: List[str] = []

        def submitter(base: int) -> None:
            for i in range(4):
                res = ss.try_submit(
                    base + i, [1, 2, 3],
                    SamplingParams(temperature=0.0, max_new_tokens=2))
                outcomes.append(res.reason)
                if res.reason == RETRY_LATER:
                    assert res.retry_after_ms is not None
                    assert math.isfinite(res.retry_after_ms), res
                    assert res.retry_after_ms > 0, res
                hint = ss.retry_after_ms()
                assert math.isfinite(hint) and hint > 0, hint

        def ticker() -> None:
            for _ in range(8):
                ss.tick()

        sched.spawn(submitter, 100, name="submitA")
        sched.spawn(submitter, 200, name="submitB")
        sched.spawn(ticker, name="tick")
        sched.run()

        for _ in range(64):
            ss.tick()
            if ss.idle:
                break
        assert ss.idle
        assert not ss.shedding  # drained queue must exit shed mode
        for uid in list(ss.requests):
            ss.pop_result(uid)
        alloc = eng.mgr.allocator
        assert alloc.available_blocks == alloc.total_blocks


def scenario_kill_vs_route(seed: int, n_requests: int = 5) -> None:
    """Worker kill (an external health-checker, the roadmap's router-side
    health checks) races routing and the router tick.  Invariants: no
    request is ever lost (terminal or still tracked), replays stay within
    budget, dead workers' requests land elsewhere, blocks drain to zero."""
    from ..inference import scheduler as sched_mod
    from ..inference.sampling import SamplingParams
    from ..serving.pool import Worker
    from ..serving.router import Router
    from ..telemetry import Telemetry

    sched = Schedule(seed, max_preemptions=32)
    with sched.instrument():
        tel = Telemetry(True)
        engines = []
        workers = []
        for i in range(2):
            eng, _ss = _stub_scheduler(telemetry=tel)
            engines.append(eng)
            workers.append(Worker(i, eng))

        class _StubPool:
            def __init__(self, ws, telemetry):
                self.workers = ws
                self.telemetry = telemetry

            @property
            def alive(self):
                return [w for w in self.workers if w.alive]

            @property
            def decode_workers(self):
                return self.alive

            prefill_workers: List[Any] = []

            def prefix_hit_rate(self):
                return 0.0

            def close(self):
                return [w.close() if w.alive else (w.close_audit or {})
                        for w in self.workers]

        router = Router(_StubPool(workers, tel))
        submitted: List[int] = []

        def submitter() -> None:
            for i in range(n_requests):
                res = router.try_submit(
                    300 + i, [1, 2, 3, 4],
                    SamplingParams(temperature=0.0, max_new_tokens=2))
                if res.accepted:
                    submitted.append(300 + i)

        def ticker() -> None:
            for _ in range(10):
                router.tick()
                for uid in submitted:  # conservation: tracked or terminal
                    assert (uid in router._reqs) != (uid in router._results), uid

        def killer() -> None:
            checkpoint()
            if workers[1].alive:
                router._kill_worker(workers[1])

        sched.spawn(submitter, name="submit")
        sched.spawn(ticker, name="tick")
        sched.spawn(killer, name="kill")
        sched.run()

        results = router.run(wait_for=submitted, max_ticks=256)
        for uid in submitted:
            state, _toks = results[uid]
            assert state in (sched_mod.FINISHED, sched_mod.FAILED,
                             sched_mod.TIMED_OUT), (uid, state)
        for rec in router._reqs.values():
            assert rec.replays <= router.config.max_replays
        audits = router.close()
        assert all(a.get("blocks_in_use", 0) == 0 for a in audits), audits


def _replica_stub_scheduler(replicas: int = 1, telemetry=None, serve=None,
                            **engine_kw):
    """A real ``ServeScheduler`` over a :class:`HostStubEngine` whose state
    manager is the REAL replica-partitioned ``StateManager`` (prefix
    caching on) — host-only still, but admission placement, per-replica
    allocators, prefix matching and the hash-publish path are the genuine
    articles, so interleavings exercise the replica-affine admission code
    rather than a stub approximation."""
    from ..inference.ragged import StateManager
    from ..inference.scheduler import ServeScheduler

    eng = HostStubEngine(telemetry=telemetry, **engine_kw)
    eng.mgr = StateManager(
        num_blocks=engine_kw.get("num_blocks", 64),
        block_size=engine_kw.get("block_size", 8),
        max_seqs=engine_kw.get("max_seqs", 4),
        enable_prefix_caching=True, replicas=replicas,
    )
    real_prefill = eng.prefill_entries

    def prefill_entries(entries, sampling):
        out = real_prefill(entries, sampling)
        for seq, _s, _e in entries:
            # publish the freshly "written" full blocks so later arrivals
            # can prefix-match them — the engine does this per pack
            eng.mgr.update_hashes(seq)
        return out

    eng.prefill_entries = prefill_entries
    sched = ServeScheduler(eng, serve=serve)
    eng.scheduler = sched
    return eng, sched


def scenario_replica_affine_admission(seed: int, n_requests: int = 6) -> None:
    """Prefix-cached admission vs cancel vs the owner tick loop on the
    port's real ``StateManager`` (JAX runs this at ``replicas=2``; the port
    runs one replica until the replica-partitioned pool lands, ROADMAP
    queue 1 item 7): two submitters race shared-prefix and cold prompts
    while a canceller fires mid-flight.  Invariants at every interleaving
    point: every tracked sequence's blocks stay inside the pool and the
    allocator audits clean; at drain: every accepted request reached
    exactly one terminal state and the pool leaks zero blocks."""
    from ..inference.sampling import SamplingParams
    from ..inference.scheduler import TERMINAL

    sched = Schedule(seed, max_preemptions=32)
    with sched.instrument():
        eng, ss = _replica_stub_scheduler()
        mgr = eng.mgr
        accepted: List[int] = []
        shared = [7] * 24  # three full blocks at bs=8: the affinity family

        def affinity_invariant() -> None:
            per = mgr.allocator.total_blocks
            for seq in list(mgr.seqs.values()):
                r = mgr.replica_of(seq)
                blocks = list(seq.blocks)
                assert all(r * per <= b < (r + 1) * per for b in blocks), (
                    f"cross-replica block ref: replica {r}, blocks {blocks}")

        def submitter(base: int) -> None:
            for i in range(n_requests // 2):
                uid = base + i
                prompt = (shared + [uid, uid + 1] if i % 2 == 0
                          else [uid % 251 + 1] * 12)
                res = ss.try_submit(uid, prompt,
                                    SamplingParams(max_new_tokens=2))
                if res.accepted:
                    accepted.append(uid)
                affinity_invariant()

        def ticker() -> None:
            for _ in range(8):
                ss.tick()
                affinity_invariant()
                mgr.allocator.audit()

        def canceller() -> None:
            ss.cancel(101)  # may be queued, running, or already terminal
            ss.cancel(202)
            affinity_invariant()

        sched.spawn(submitter, 100, name="submitA")
        sched.spawn(submitter, 200, name="submitB")
        sched.spawn(ticker, name="tick")
        sched.spawn(canceller, name="cancel")
        sched.run()

        for _ in range(64):  # drain on the owner thread
            if all(ss.requests[u].state in TERMINAL for u in accepted):
                break
            ss.tick()
        for u in accepted:
            assert ss.requests[u].state in TERMINAL, u
            ss.pop_result(u)
        mgr.allocator.audit()
        audit = eng.close()
        assert audit["blocks_in_use"] == 0, audit


def scenario_heartbeat_expiry_vs_route(seed: int, n_requests: int = 5) -> None:
    """Heartbeat-lease expiry (the out-of-process death-detection path)
    races routing, the router tick, and a prefill->decode migration: a
    monitor task drives the REAL ``HeartbeatMonitor`` state machine
    (watch -> missed acks -> lease expiry on a fake clock) while the
    router submits/ticks/migrates against workers whose ``health_check``
    consults the monitor.  Invariants: no request is ever lost at any
    interleaving point (tracked XOR terminal), the discovered death is
    replayed within budget onto the surviving worker, a mid-migration
    expiry never strands the request on either side, teardown is
    idempotent even when the worker died between health checks, and blocks
    drain to zero."""
    from ..inference import scheduler as sched_mod
    from ..inference.sampling import SamplingParams
    from ..serving.pool import PREFILL_ROLE, Worker
    from ..serving.router import Router
    from ..serving.transport import HeartbeatMonitor
    from ..telemetry import Telemetry

    sched = Schedule(seed, max_preemptions=32)
    with sched.instrument():
        tel = Telemetry(True)
        clock_cell = [0.0]
        mon = HeartbeatMonitor(interval_ms=10.0, lease_ms=50.0,
                               clock=lambda: clock_cell[0])
        workers = []
        for i in range(3):
            eng, _ss = _stub_scheduler(telemetry=tel)
            role = PREFILL_ROLE if i == 0 else None
            w = Worker(i, eng, role or "mixed")
            mon.watch(i)
            w.health_check = (lambda idx=i: not mon.lease_expired(idx))
            workers.append(w)

        class _StubPool:
            def __init__(self, ws, telemetry):
                self.workers = ws
                self.telemetry = telemetry

            @property
            def alive(self):
                return [w for w in self.workers if w.alive]

            @property
            def decode_workers(self):
                return [w for w in self.alive if w.role == "mixed"]

            @property
            def prefill_workers(self):
                return [w for w in self.alive if w.role == PREFILL_ROLE]

            def prefix_hit_rate(self):
                return 0.0

            def close(self):
                return [w.close() if w.alive else (w.close_audit or {})
                        for w in self.workers]

        router = Router(_StubPool(workers, tel),
                        dict(disagg_threshold=6, prefill_workers=1))
        submitted: List[int] = []

        def submitter() -> None:
            for i in range(n_requests):
                # odd requests are long enough to route via the prefill
                # worker and migrate at first token (the handoff path the
                # expiry must race)
                prompt = [1, 2, 3, 4, 5, 6, 7, 8] if i % 2 else [1, 2, 3]
                res = router.try_submit(
                    500 + i, prompt,
                    SamplingParams(temperature=0.0, max_new_tokens=2))
                if res.accepted:
                    submitted.append(500 + i)
                checkpoint()

        def ticker() -> None:
            for _ in range(10):
                router.tick()
                for uid in submitted:  # conservation: tracked XOR terminal
                    assert (uid in router._reqs) != (uid in router._results), uid

        def monitor_task() -> None:
            # the heartbeat thread's bookkeeping, interleaved: worker 1
            # keeps acking for a while, then goes silent past its lease
            for _ in range(2):
                mon.note_ack(1)
                checkpoint()
            for _ in range(4):
                clock_cell[0] += 0.02  # 4 x 20ms of silence > 50ms lease
                mon.note_miss(1)
                checkpoint()
            assert mon.lease_expired(1)

        sched.spawn(submitter, name="submit")
        sched.spawn(ticker, name="tick")
        sched.spawn(monitor_task, name="heartbeat")
        sched.run()

        assert mon.lease_expired(1)  # the lease latched
        results = router.run(wait_for=submitted, max_ticks=256)
        for uid in submitted:
            state, _toks = results[uid]
            assert state in (sched_mod.FINISHED, sched_mod.FAILED,
                             sched_mod.TIMED_OUT), (uid, state)
        assert not workers[1].alive  # the expiry was DISCOVERED, not injected
        assert dict(router.stats)["discovered_deaths"] >= 1
        for rec in router._reqs.values():
            assert rec.replays <= router.config.max_replays
        audits = router.close()
        audits2 = router.close()  # idempotent after a mid-lease death
        assert len(audits) == len(audits2)
        assert all(a.get("blocks_in_use", 0) == 0 for a in audits), audits


def scenario_cancel_during_megastep(seed: int, n_requests: int = 4) -> None:
    """Client cancels race the owner tick loop while the scheduler fuses
    decode ticks into megastep bursts (``serve.decode_megastep`` > 1).
    Invariants: a cancel landing mid-megastep takes effect at the next
    burst boundary (the knob's documented latency bound) — every accepted
    request still reaches exactly one terminal state; a burst never emits
    past a request's ``max_new_tokens`` budget even though each tick now
    commits several tokens; zero blocks leak."""
    from ..config.config import ServeConfig
    from ..inference.sampling import SamplingParams
    from ..inference.scheduler import TERMINAL

    sched = Schedule(seed, max_preemptions=32)
    with sched.instrument():
        eng, ss = _stub_scheduler(serve=ServeConfig(decode_megastep=4))
        accepted: List[int] = []

        def budget_invariant() -> None:
            for uid in list(accepted):
                req = ss.requests.get(uid)
                if req is not None:
                    assert (len(req.generated)
                            <= req.sampling.max_new_tokens), (
                        uid, req.generated)

        def submitter() -> None:
            for i in range(n_requests):
                res = ss.try_submit(
                    300 + i, [1, 2, 3],
                    SamplingParams(temperature=0.0, max_new_tokens=6))
                if res.accepted:
                    accepted.append(300 + i)
                budget_invariant()

        def ticker() -> None:
            for _ in range(10):
                ss.tick()
                budget_invariant()

        def canceller() -> None:
            ss.cancel(301)
            ss.cancel(303)
            ss.cancel(999)  # unknown uid: must be a quiet no-op
            budget_invariant()

        sched.spawn(submitter, name="submit")
        sched.spawn(ticker, name="tick")
        sched.spawn(canceller, name="cancel")
        sched.run()

        for _ in range(64):  # drain on the owner thread
            if all(ss.requests[u].state in TERMINAL for u in accepted):
                break
            ss.tick()
            budget_invariant()
        states = {u: ss.requests[u].state for u in accepted}
        assert all(s in TERMINAL for s in states.values()), states
        for u in accepted:
            toks = ss.pop_result(u)
            assert len(toks) <= 6, (u, toks)
        alloc = eng.mgr.allocator
        assert alloc.available_blocks == alloc.total_blocks, (
            f"leak: {alloc.total_blocks - alloc.available_blocks} blocks")


def scenario_retune_vs_tick(seed: int, n_requests: int = 4) -> None:
    """The REAL :class:`~..autotuning.controller.OnlineController` on a
    fake clock racing submit/decode-tick/megastep/cancel, plus direct
    ``apply_knobs`` pushes (the router fan-out path) landing mid-flight.
    Invariants: every engine dispatch within one tick observes a single
    ``knob_epoch`` — staged retunes land only at the tick boundary, never
    mid-burst; every accepted request still reaches exactly one terminal
    state; invalid retunes are refused at the call site without poisoning
    the staged batch; controller shutdown is idempotent; zero blocks
    leak."""
    from ..autotuning.controller import OnlineController
    from ..config.config import AdaptationConfig, ServeConfig
    from ..inference.sampling import SamplingParams
    from ..inference.scheduler import TERMINAL
    from ..telemetry import Telemetry

    sched = Schedule(seed, max_preemptions=32)
    with sched.instrument():
        eng, ss = _stub_scheduler(telemetry=Telemetry(True),
                                  serve=ServeConfig(decode_megastep=2))
        clock = [0.0]
        ctl = OnlineController(
            ss, config=AdaptationConfig(enabled=True, epoch_s=0.01,
                                        min_window=1, guard_epochs=1,
                                        allow_rebuild=False),
            telemetry=eng.telemetry, serve_ns=eng._ns,
            prefill_budget=eng.prefill_budget, clock=lambda: clock[0])
        accepted: List[int] = []
        # every dispatch a tick makes must see the SAME knob epoch: record
        # the epoch at each engine entry point, keyed by tick number
        seen_epochs: Dict[int, set] = {}

        def _observe() -> None:
            seen_epochs.setdefault(ss.tick_no, set()).add(ss.knob_epoch)

        for _name in ("prefill_entries", "_decode_tick", "_decode_burst"):
            def _wrap(fn=getattr(eng, _name)):
                def inner(*a, **k):
                    _observe()
                    return fn(*a, **k)
                return inner
            setattr(eng, _name, _wrap())

        def submitter() -> None:
            for i in range(n_requests):
                res = ss.try_submit(
                    400 + i, [1, 2, 3],
                    SamplingParams(temperature=0.0, max_new_tokens=6))
                if res.accepted:
                    accepted.append(400 + i)

        def ticker() -> None:
            for _ in range(10):
                clock[0] += 0.05  # the fake clock advances with the ticks
                ss.tick()

        def retuner() -> None:
            # the router fan-out push path: direct staged batches racing
            # the owner tick AND the controller's own epochs
            ss.apply_knobs(decode_megastep=4)
            checkpoint()
            ss.apply_knobs(prefill_chunk=8, kv_watermark=0.125)
            checkpoint()
            try:
                ss.apply_knobs(decode_megastep=0)
            except ValueError:
                pass  # refused at validation, batch untouched
            else:
                raise AssertionError("decode_megastep=0 must be refused")
            try:
                ss.apply_knobs(nonsense_knob=1)
            except ValueError:
                pass
            else:
                raise AssertionError("unknown knob must be refused")

        def adapt() -> None:
            ctl.start()
            ctl.start()  # idempotent while running
            checkpoint()
            clock[0] += 0.05
            checkpoint()
            ctl.stop()
            ctl.stop()  # idempotent after shutdown

        def canceller() -> None:
            ss.cancel(401)
            ss.cancel(999)  # unknown uid: quiet no-op

        sched.spawn(submitter, name="submit")
        sched.spawn(ticker, name="tick")
        sched.spawn(retuner, name="retune")
        sched.spawn(adapt, name="adapt")
        sched.spawn(canceller, name="cancel")
        sched.run()

        for _ in range(64):  # drain on the owner thread
            if all(ss.requests[u].state in TERMINAL for u in accepted):
                break
            clock[0] += 0.05
            ss.tick()
        ss.tick()  # flush any batch staged after the last drain tick
        states = {u: ss.requests[u].state for u in accepted}
        assert all(s in TERMINAL for s in states.values()), states
        # the staging contract: no tick ever dispatched under two epochs
        mixed = {t: e for t, e in seen_epochs.items() if len(e) != 1}
        assert not mixed, f"knob epoch changed mid-tick: {mixed}"
        assert ss._staged_knobs is None, ss._staged_knobs
        assert ss.last_knob_error is None, ss.last_knob_error
        assert ctl._thread is None  # shutdown actually landed
        assert ctl.last_error is None, ctl.last_error
        for d in ctl.decisions:  # every decision carries its evidence
            assert "action" in d and "outcome" in d and "signals" in d, d
        alloc = eng.mgr.allocator
        assert alloc.available_blocks == alloc.total_blocks, (
            f"leak: {alloc.total_blocks - alloc.available_blocks} blocks")


def scenario_metrics_pull_vs_death(seed: int, n_requests: int = 4) -> None:
    """A fleet collector pull races routing, the router tick loop and a
    worker kill.  Invariants: a pull NEVER observes a torn histogram
    state (total count equals the bucket total; the exact-sample list,
    while present, matches the count) or a torn counter table; a pull
    landing on a dead worker degrades to a counted failure, never an
    exception; merged fleet rollups stay well-formed at every
    interleaving; the ticker's request-conservation invariant holds at
    every point (the collector cannot block or break a tick); zero
    blocks leak."""
    from ..inference import scheduler as sched_mod
    from ..inference.sampling import SamplingParams
    from ..serving.pool import Worker
    from ..serving.router import Router
    from ..telemetry import FleetCollector, FleetRegistry, Telemetry

    sched = Schedule(seed, max_preemptions=32)
    with sched.instrument():
        tel = Telemetry(True)
        workers = []
        for i in range(2):
            eng, _ss = _stub_scheduler(telemetry=tel)
            workers.append(Worker(i, eng))

        class _StubPool:
            def __init__(self, ws, telemetry):
                self.workers = ws
                self.telemetry = telemetry

            @property
            def alive(self):
                return [w for w in self.workers if w.alive]

            @property
            def decode_workers(self):
                return self.alive

            prefill_workers: List[Any] = []

            def prefix_hit_rate(self):
                return 0.0

            def close(self):
                return [w.close() if w.alive else (w.close_audit or {})
                        for w in self.workers]

        pool = _StubPool(workers, tel)
        router = Router(pool)
        fleet = FleetRegistry()
        collector = FleetCollector(
            fleet, lambda: [(f"worker{w.index}", w) for w in pool.alive],
            spans=True)
        submitted: List[int] = []

        def submitter() -> None:
            for i in range(n_requests):
                res = router.try_submit(
                    500 + i, [1, 2, 3, 4],
                    SamplingParams(temperature=0.0, max_new_tokens=2))
                if res.accepted:
                    submitted.append(500 + i)

        def ticker() -> None:
            for _ in range(8):
                router.tick()
                for uid in submitted:  # conservation: tracked or terminal
                    assert (uid in router._reqs) != (uid in router._results), uid

        def killer() -> None:
            checkpoint()
            if workers[1].alive:
                router._kill_worker(workers[1])

        def puller() -> None:
            # the collector thread's loop body, interleaved against
            # everything else; each pull validates what it just folded
            for _ in range(4):
                collector.pull_once()
                checkpoint()
                snap = fleet.snapshot()
                for name, slot in snap.items():
                    assert slot["pulls"] + slot["failures"] >= 1, (name, slot)
                for states in (fleet.histogram_states("ttft_ms")
                               + fleet.histogram_states("e2e_ms")):
                    assert states["count"] == sum(states["counts"]), states
                    if states["samples"] is not None:
                        assert len(states["samples"]) == states["count"], states
                merged = fleet.merged_histogram("ttft_ms")
                if merged is not None:
                    assert merged.count == sum(merged._counts)
                assert fleet.merge_conflicts == 0
                # signals() is the cross-thread read surface: it must be
                # callable mid-anything and internally consistent
                sig = router.signals()
                assert sig["workers_alive"] == len(pool.alive)

        sched.spawn(submitter, name="submit")
        sched.spawn(ticker, name="tick")
        sched.spawn(killer, name="kill")
        sched.spawn(puller, name="pull")
        sched.run()

        # a pull against the killed worker must have degraded, not raised
        collector.pull_once()
        assert [w for w in pool.alive] or fleet.snapshot()
        results = router.run(wait_for=submitted, max_ticks=256)
        for uid in submitted:
            state, _toks = results[uid]
            assert state in (sched_mod.FINISHED, sched_mod.FAILED,
                             sched_mod.TIMED_OUT), (uid, state)
        audits = router.close()
        assert all(a.get("blocks_in_use", 0) == 0 for a in audits), audits


SCENARIOS = (
    scenario_namespace_claims,
    scenario_submit_tick_cancel,
    scenario_shed_watchdog,
    scenario_kill_vs_route,
    scenario_replica_affine_admission,
    scenario_heartbeat_expiry_vs_route,
    scenario_cancel_during_megastep,
    scenario_retune_vs_tick,
    scenario_metrics_pull_vs_death,
)


def run_scenarios(seeds: Iterable[int] = range(8)) -> Dict[str, Any]:
    """Sweep every hot scenario over ``seeds``; a JSON-able aggregate for
    the tier-1 gate."""
    seeds = list(seeds)
    reports = [explore(s, seeds=seeds) for s in SCENARIOS]
    return {
        "passed": all(r["passed"] for r in reports),
        "schedules_total": sum(r["schedules"] for r in reports),
        "scenarios": {r["scenario"]: r for r in reports},
    }
