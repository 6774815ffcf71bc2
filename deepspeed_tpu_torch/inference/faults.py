"""Deterministic fault injection for the serving stack (chaos harness) —
a copy of ``deepspeed_tpu/inference/faults.py`` (numpy only, same names):
the injector draws from one seeded ``numpy`` generator in JAX's order, so
one seed fires the same faults in both packages for one call order.

    ============================  ==============================================
    point                         fires where
    ============================  ==============================================
    ``alloc_exhaustion``          ``StateManager.ensure_capacity`` (before the
                                  real block arithmetic) — emulates an
                                  allocator race / transient pool pressure
    ``runner_exception``          engine dispatch sites (``_decode_tick``,
                                  ``_spec_tick``, ``_run_packed_prefill``,
                                  ``_decode_burst`` — one check per burst,
                                  before the graph replays) — emulates a
                                  runtime error.  Raised BEFORE dispatch so
                                  the KV pool is never half-written.
    ``nan_logits``                after the dispatch's token fetch: the
                                  engine poisons the victim rows with the same
                                  ``-1`` sentinel ``finite_guard`` produces
                                  for real non-finite logits, so the whole
                                  host-side quarantine path runs.  In a burst
                                  the injection applies at BURST granularity.
    ``slow_tick``                 scheduler tick start (``delay()`` seconds) —
                                  trips the tick-duration watchdog
    ``checkpoint_crash``          process-global scope (``scope`` / ``check``)
    ``worker_kill``               ``serving.router.Router.tick``, per worker
    ============================  ==============================================

The network points (``conn_drop``, ``conn_delay``, ``partial_write``,
``partition``, ``heartbeat_loss``) fire in ``serving/transport.py``'s
``ChaosLink``, per frame sent or received on a channel to a worker (uids
are worker indices), as JAX's do: ``build_remote_router(faults=...)`` arms
the router-thread RPC channels, ``hb_faults=...`` the heartbeat thread's.

Faults are *typed*: ``InjectedFault.transient`` separates the
retry-with-backoff class (allocator races, transfer hiccups) from the
fail-the-request class, and ``is_transient`` is the classifier the
scheduler's tick guard consults for real exceptions too — after the guard
has re-raised every kernel and CUDA error (``ops.kernels.surfaces``),
which no retry or isolation probe may absorb.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

ALLOC_EXHAUSTION = "alloc_exhaustion"
RUNNER_EXCEPTION = "runner_exception"
NAN_LOGITS = "nan_logits"
SLOW_TICK = "slow_tick"
CHECKPOINT_CRASH = "checkpoint_crash"
# router-scoped: kills a whole ENGINE WORKER (serving/router.py checks it
# per worker per tick with uids=(worker_index,) — uids here are worker
# indices, not request uids); the router must re-route and replay every
# request the dead worker held
WORKER_KILL = "worker_kill"
# network-scoped points (serving/transport.py consults them per frame with
# uids=(worker_index,) — the chaos surface of the out-of-process serve
# plane).  ``conn_drop`` severs the connection mid-stream (the peer sees a
# torn frame / EOF), ``conn_delay`` stalls a send by ``delay_s`` (a slow
# link; fires through the ``delay()`` API), ``partial_write`` ships only a
# frame prefix then drops the connection (the peer reads a torn frame),
# ``partition`` black-holes BOTH directions of every channel to that
# worker for ``delay_s`` seconds (I/O times out, the connection stays
# "up"), and ``heartbeat_loss`` swallows heartbeat acks so the router's
# lease expires against a live worker.
CONN_DROP = "conn_drop"
CONN_DELAY = "conn_delay"
PARTIAL_WRITE = "partial_write"
PARTITION = "partition"
HEARTBEAT_LOSS = "heartbeat_loss"
NETWORK_POINTS = (CONN_DROP, CONN_DELAY, PARTIAL_WRITE, PARTITION,
                  HEARTBEAT_LOSS)

POINTS = (ALLOC_EXHAUSTION, RUNNER_EXCEPTION, NAN_LOGITS, SLOW_TICK,
          CHECKPOINT_CRASH, WORKER_KILL) + NETWORK_POINTS


class InjectedFault(RuntimeError):
    """A deliberately injected failure.  ``transient`` marks the
    retry-with-backoff class; non-transient faults are meant to fail the
    implicated request(s)."""

    def __init__(self, point: str, transient: bool = False,
                 ctx: Optional[Dict[str, Any]] = None):
        self.point = point
        self.transient = transient
        self.ctx = dict(ctx or {})
        kind = "transient" if transient else "fatal"
        super().__init__(f"injected {kind} fault at {point} ({self.ctx})")


class CheckpointWriteCrash(InjectedFault):
    """Injected crash inside the checkpoint write sequence (the harness's
    stand-in for a process kill mid-save)."""

    def __init__(self, stage: str):
        super().__init__(CHECKPOINT_CRASH, transient=False,
                         ctx={"stage": stage})


# Messages of REAL runtime errors that are worth one bounded retry before
# failing a request: allocator/scheduler races and transport hiccups that a
# re-dispatch typically clears.  Pool exhaustion ("cannot allocate") is NOT
# here — the scheduler's preemption path owns that.
_TRANSIENT_MARKERS = (
    "resource_exhausted", "deadline_exceeded", "unavailable",
    "device_put", "transfer", "injected transient",
)


def is_transient(exc: BaseException) -> bool:
    """Single classifier for the scheduler's retry decision."""
    if isinstance(exc, InjectedFault):
        return exc.transient
    msg = str(exc).lower()
    return any(m in msg for m in _TRANSIENT_MARKERS)


@dataclass
class FaultSpec:
    """One armed injection rule.  A spec fires when ALL its filters match:
    ``p`` (seeded Bernoulli per check), ``uids`` (any overlap with the
    checked uids; None = any), ``after`` (only from the Nth check of this
    point on), and a remaining ``times`` budget (None = unlimited)."""

    point: str
    p: float = 1.0
    uids: Optional[frozenset] = None
    after: int = 0
    times: Optional[int] = None
    transient: bool = False
    delay_s: float = 0.0
    fired: int = field(default=0, repr=False)

    def exhausted(self) -> bool:
        return self.times is not None and self.fired >= self.times


class FaultInjector:
    """Seeded, scoped fault injector.  ``arm()`` rules, hand the instance to
    an engine (``InferenceEngineV2(..., faults=inj)``) or ``scope()`` it for
    checkpoint writes; every firing is appended to ``log`` so a bench can
    compute availability over the NON-injected population afterwards."""

    def __init__(self, seed: int = 0, enabled: bool = True):
        self._rng = np.random.default_rng(seed)
        self.enabled = enabled
        self._specs: Dict[str, List[FaultSpec]] = {}
        self._checks: Dict[str, int] = {}
        self.log: List[Tuple[str, Tuple[int, ...]]] = []

    # -- arming --------------------------------------------------------------
    def arm(self, point: str, *, p: float = 1.0,
            uids: Optional[Sequence[int]] = None, after: int = 0,
            times: Optional[int] = None, transient: bool = False,
            delay_s: float = 0.0) -> "FaultInjector":
        if point not in POINTS:
            raise ValueError(f"unknown injection point {point!r} "
                             f"(known: {POINTS})")
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"p must be in [0, 1], got {p}")
        self._specs.setdefault(point, []).append(FaultSpec(
            point=point, p=p,
            uids=frozenset(int(u) for u in uids) if uids is not None else None,
            after=after, times=times, transient=transient, delay_s=delay_s,
        ))
        return self

    @property
    def injected_uids(self) -> frozenset:
        """Uids explicitly TARGETED by any armed spec — the population a
        chaos bench excludes from its availability denominator."""
        out: set = set()
        for specs in self._specs.values():
            for s in specs:
                if s.uids is not None:
                    out |= s.uids
        return frozenset(out)

    def fired(self, point: Optional[str] = None) -> int:
        if point is None:
            return len(self.log)
        return sum(1 for p, _ in self.log if p == point)

    # -- firing --------------------------------------------------------------
    def _match(self, spec: FaultSpec, n_check: int,
               uids: Tuple[int, ...]) -> bool:
        if spec.exhausted() or n_check < spec.after:
            return False
        if spec.uids is not None and not spec.uids.intersection(uids):
            return False
        # the Bernoulli draw happens LAST so exhausted/filtered specs do not
        # consume randomness (keeps replay stable as specs burn out)
        return spec.p >= 1.0 or self._rng.random() < spec.p

    def _fire(self, spec: FaultSpec, uids: Tuple[int, ...]) -> None:
        spec.fired += 1
        hit = (tuple(sorted(spec.uids.intersection(uids)))
               if spec.uids is not None else tuple(uids))
        self.log.append((spec.point, hit))

    def maybe_raise(self, point: str, uids: Sequence[int] = (), **ctx) -> None:
        """Raise an :class:`InjectedFault` if an armed spec for ``point``
        fires against ``uids`` (empty = point has no request scope)."""
        if not self.enabled:
            return
        n = self._checks.get(point, 0)
        self._checks[point] = n + 1
        uids_t = tuple(int(u) for u in uids)
        for spec in self._specs.get(point, ()):
            if self._match(spec, n, uids_t):
                self._fire(spec, uids_t)
                if point == CHECKPOINT_CRASH:
                    raise CheckpointWriteCrash(ctx.get("stage", "?"))
                raise InjectedFault(point, transient=spec.transient,
                                    ctx={"uids": uids_t, **ctx})

    def select(self, point: str, uids: Sequence[int]) -> List[int]:
        """Subset of ``uids`` a spec for ``point`` fires on (per-uid draw for
        probabilistic specs) — used for row-scoped faults like
        ``nan_logits`` where the dispatch survives but rows are poisoned."""
        if not self.enabled:
            return []
        n = self._checks.get(point, 0)
        self._checks[point] = n + 1
        out: List[int] = []
        for spec in self._specs.get(point, ()):
            if spec.exhausted() or n < spec.after:
                continue
            for u in uids:
                if spec.exhausted():
                    break
                if spec.uids is not None and int(u) not in spec.uids:
                    continue
                if spec.p < 1.0 and self._rng.random() >= spec.p:
                    continue
                spec.fired += 1
                self.log.append((spec.point, (int(u),)))
                out.append(int(u))
        return out

    def delay(self, point: str = SLOW_TICK, uids: Sequence[int] = ()) -> float:
        """Seconds to stall (``slow_tick``); 0.0 when nothing fires."""
        if not self.enabled:
            return 0.0
        n = self._checks.get(point, 0)
        self._checks[point] = n + 1
        uids_t = tuple(int(u) for u in uids)
        for spec in self._specs.get(point, ()):
            if self._match(spec, n, uids_t):
                self._fire(spec, uids_t)
                return spec.delay_s
        return 0.0


# -- process-global scope (checkpoint writes have no engine to hang off) -----
_GLOBAL: Optional[FaultInjector] = None


def get_global() -> Optional[FaultInjector]:
    return _GLOBAL


@contextlib.contextmanager
def scope(injector: Optional[FaultInjector]):
    """Install ``injector`` as the process-global fault scope (checkpoint
    crash points consult it).  Always restores the previous scope."""
    global _GLOBAL
    prev, _GLOBAL = _GLOBAL, injector
    try:
        yield injector
    finally:
        _GLOBAL = prev


def check(point: str, **ctx) -> None:
    """Fire the process-global injector at ``point`` (no-op when no scope is
    installed) — the hook a checkpoint writer calls between its write
    stages."""
    if _GLOBAL is not None:
        _GLOBAL.maybe_raise(point, **ctx)
