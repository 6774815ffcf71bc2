"""Engine worker pool: N serve engines stamped out from ONE config — the
port of ``deepspeed_tpu/serving/pool.py`` (in-process workers).

The bottom half of the serve front end (``serving/router.py`` is the top):
each :class:`Worker` wraps an ``InferenceEngineV2`` built through
``build_serve_engine`` plus its ``ServeScheduler``, and exposes the worker
interface the router drives — admission (``try_submit``), the tick pair
(``begin_tick`` / ``finish_tick``), request views and terminal pops, the
KV-handoff ops, and the load signals (queue depth, running count, pool
headroom, shed state, TTFT median).

All workers share one ``Telemetry``: the claim-prefix machinery hands each
engine its own ``serve`` / ``serve2`` / ... namespace, so per-worker stats
never alias and ``engine.close()`` returns the namespace on teardown.  The
workers also share the caller's weight tensors: the engine keeps tensors
already on its device as they are, so each extra worker adds only its KV
pool.

``serving/remote.py RemoteWorker`` implements the SAME interface over the
socket transport, so the router is deployment-agnostic: in-process pools
for tests and shared weights, subprocess pools for workers with a process
(and a CUDA context) each.

:func:`serve_worker_main` is the cross-process stdio worker — it speaks the
FRAMED protocol (``serving/transport.py``: length prefix + version
handshake + payload checksum) over a binary pipe; a torn, oversized, or
junk frame gets a typed protocol-error frame back and a clean audited
shutdown, never an unhandled exception.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..inference.engine_v2 import build_serve_engine
from ..inference.sampling import SamplingParams
from ..telemetry import Telemetry
from . import handoff as handoff_mod

PREFILL_ROLE = "prefill"
MIXED_ROLE = "mixed"


class Worker:
    """One engine + scheduler pair with the router-facing worker surface."""

    def __init__(self, index: int, engine, role: str = MIXED_ROLE):
        if role not in (PREFILL_ROLE, MIXED_ROLE):
            raise ValueError(f"unknown worker role {role!r}")
        self.index = index
        self.engine = engine
        self.role = role
        self.alive = True
        # router-clock time before which routing skips this worker (set from
        # a RETRY_LATER rejection's retry_after_ms hint)
        self.backoff_until = 0.0
        self.close_audit: Optional[Dict[str, int]] = None
        # optional external liveness oracle (a heartbeat lease, say)
        self.health_check = None

    @property
    def scheduler(self):
        return self.engine.scheduler

    @property
    def ns(self) -> str:
        """This worker's telemetry namespace (``serve``, ``serve2``, ...)."""
        return self.engine._ns

    # -- engine geometry (the router's placement inputs) ---------------------
    @property
    def block_size(self) -> int:
        return self.engine.block_size

    @property
    def disagg_default(self) -> int:
        """Default disaggregation threshold when the router config leaves
        it None: one prefill chunk (or the whole budget)."""
        return int(self.engine.prefill_chunk or self.engine.prefill_budget)

    # -- load signals (the router's placement cost) --------------------------
    @property
    def queue_depth(self) -> int:
        return len(self.scheduler.waiting)

    @property
    def running(self) -> int:
        return len(self.scheduler._running)

    @property
    def load(self) -> int:
        return self.queue_depth + self.running

    @property
    def headroom_blocks(self) -> int:
        return self.engine.mgr.allocator.available_blocks

    @property
    def headroom_fraction(self) -> float:
        alloc = self.engine.mgr.allocator
        return alloc.available_blocks / alloc.total_blocks

    @property
    def shedding(self) -> bool:
        return self.scheduler.shedding

    def ttft_p50_ms(self) -> float:
        """Recent TTFT median from this worker's request histograms (0.0
        while empty/disabled) — the SLO half of the placement cost."""
        return float(self.engine.telemetry.request_hists(self.ns)["ttft"].percentile(50))

    @property
    def prompt_tokens_total(self) -> int:
        return self.engine.mgr.prompt_tokens_total

    @property
    def cached_prompt_tokens(self) -> int:
        return self.engine.mgr.cached_prompt_tokens

    # -- liveness ------------------------------------------------------------
    def healthy(self) -> bool:
        """The router's per-tick death probe.  In-process workers die only
        through the chaos ``worker_kill`` path unless an external
        ``health_check`` oracle says otherwise."""
        return self.alive and (self.health_check is None
                               or bool(self.health_check()))

    # -- the op surface the router drives ------------------------------------
    def try_submit(self, uid: int, tokens: Sequence[int],
                   sampling: SamplingParams,
                   deadline_ms: Optional[float] = None,
                   ttft_deadline_ms: Optional[float] = None):
        return self.scheduler.try_submit(
            uid, tokens, sampling, deadline_ms=deadline_ms,
            ttft_deadline_ms=ttft_deadline_ms)

    def begin_tick(self, n: int = 1) -> None:
        """In-process: the tick(s) run synchronously here.  (A remote
        worker would post the RPC here and collect it in ``finish_tick``.)
        ``n`` > 1: up to n scheduler ticks back to back, stopping early
        once the scheduler goes idle."""
        for _ in range(max(1, n)):
            self.scheduler.tick()
            if self.scheduler.idle:
                break

    def finish_tick(self) -> None:
        pass

    def tick(self, n: int = 1) -> None:
        self.begin_tick(n)
        self.finish_tick()

    def request_view(self, uid: int):
        """The live request record (state/error/generated/cancel_requested)
        or None."""
        return self.scheduler.requests.get(uid)

    def pop_result(self, uid: int) -> List[int]:
        return self.scheduler.pop_result(uid)

    def pop_state(self, uid: int) -> Optional[Tuple[str, Optional[str],
                                                    List[int]]]:
        """(terminal state, error, tokens), popped — one atomic collection
        step for the router."""
        req = self.scheduler.requests.get(uid)
        if req is None:
            return None
        state, error = req.state, req.error
        return state, error, self.scheduler.pop_result(uid)

    def cancel(self, uid: int) -> bool:
        return self.scheduler.cancel(uid)

    def retry_after_ms(self) -> float:
        return self.scheduler.retry_after_ms()

    def apply_knobs(self, knobs: Dict[str, Any]) -> Dict[str, Any]:
        """Stage a live-retune batch on this worker's scheduler (applied at
        its next tick boundary) — the in-process leg of the controller's
        per-worker knob push."""
        return self.scheduler.apply_knobs(**knobs)

    def export_metrics(self, spans: bool = False) -> Optional[Dict[str, Any]]:
        """Mergeable snapshot of THIS worker's slice of the shared registry.
        In-process pools share ONE ``Telemetry``, so the snapshot filters by
        the engine's claimed namespaces (``serve`` / ``sched`` / ``comm``
        families) — per-worker views never alias.  ``spans`` is accepted
        for the facade's sake but ignored: the shared recorder already
        holds every in-process span, so the fleet trace reads the local
        telemetry directly.  Host state only and lock-guarded, so the
        collector thread may call this at any time (no device tensor, no
        stream sync).  Returns None once the worker is dead."""
        if not self.alive:
            return None
        eng = self.engine
        prefixes = tuple(
            p for p in (getattr(eng, "_ns", None),
                        getattr(eng, "_sched_ns", None),
                        getattr(eng, "_comm_ns", None))
            if p)
        tel = eng.telemetry
        return {
            "metrics": tel.registry.export_state(prefixes or None),
            "ts": tel.clock(),
            "events": [],
        }

    # -- the KV-handoff surface ----------------------------------------------
    def extract_handoff(self, uid: int, fmt: str) -> handoff_mod.KVHandoff:
        return handoff_mod.extract_request(self.engine, uid, fmt=fmt)

    def adopt_handoff(self, ho: handoff_mod.KVHandoff,
                      sampling: SamplingParams,
                      deadline_ms: Optional[float] = None,
                      ttft_deadline_ms: Optional[float] = None):
        """Adopt + inject in one step."""
        res = self.scheduler.adopt_prefilled(
            ho.uid, ho.tokens, n_ctx=ho.n_ctx, sampling=sampling,
            deadline_ms=deadline_ms, ttft_deadline_ms=ttft_deadline_ms)
        if res.accepted:
            handoff_mod.inject_request(self.engine, ho)
        return res

    def detach_migrated(self, uid: int) -> bool:
        """MIGRATED release + pop on the source after a successful handoff;
        False when a deferred cancel won the race (the caller must then
        cancel the adopted copy)."""
        if self.scheduler.detach(uid):
            self.scheduler.pop_result(uid)
            return True
        return False

    # -- lifecycle -----------------------------------------------------------
    def kill(self) -> None:
        """Simulated worker death (chaos ``worker_kill``): requests it held
        are LOST from the router's perspective — the router replays them
        elsewhere from the prompt.  The engine still tears down through the
        audited ``close()`` so the process reclaims device memory and the
        telemetry namespace."""
        self.alive = False
        self.close_audit = self.engine.close()

    def close(self) -> Dict[str, int]:
        """Graceful teardown via the leak-audited ``engine.close()``;
        idempotent, returns the zero-leak audit."""
        self.alive = False
        self.close_audit = self.engine.close()
        return self.close_audit


class WorkerPool:
    """``n_workers`` engines from one ``ServeEngineConfig`` on one device,
    the first ``prefill_workers`` of them in the PREFILL role (long-prompt
    targets for prefill/decode disaggregation)."""

    def __init__(self, params, cfg, sec, n_workers: int = 2,
                 prefill_workers: int = 0, telemetry=None, serve=None,
                 faults=None, device=None):
        if n_workers < 1:
            raise ValueError(f"need at least one worker, got {n_workers}")
        if not 0 <= prefill_workers < n_workers:
            raise ValueError(
                f"prefill_workers ({prefill_workers}) must leave at least "
                f"one decode-capable worker of {n_workers}")
        self.telemetry = Telemetry.ensure(telemetry)
        self.workers: List[Worker] = []
        for i in range(n_workers):
            eng = build_serve_engine(
                params, cfg, sec, telemetry=self.telemetry, serve=serve,
                faults=faults, device=device,
            )
            role = PREFILL_ROLE if i < prefill_workers else MIXED_ROLE
            self.workers.append(Worker(i, eng, role))

    def __len__(self) -> int:
        return len(self.workers)

    @property
    def alive(self) -> List[Worker]:
        return [w for w in self.workers if w.alive]

    @property
    def decode_workers(self) -> List[Worker]:
        return [w for w in self.alive if w.role == MIXED_ROLE]

    @property
    def prefill_workers(self) -> List[Worker]:
        return [w for w in self.alive if w.role == PREFILL_ROLE]

    def prefix_hit_rate(self) -> float:
        """Aggregate prompt prefix-cache hit rate across all workers."""
        total = sum(w.prompt_tokens_total for w in self.workers)
        cached = sum(w.cached_prompt_tokens for w in self.workers)
        return cached / total if total else 0.0

    def close(self) -> List[Dict[str, int]]:
        """Tear every worker down through ``engine.close()`` (idempotent;
        killed workers report their audit from death time).  Returns the
        per-worker zero-leak audits."""
        return [w.close() if w.alive else (w.close_audit or w.close())
                for w in self.workers]


def serve_worker_main(stdin=None, stdout=None, params=None, cfg=None,
                      sec=None, serve=None, device=None) -> Optional[Dict[str, int]]:
    """Cross-process stdio worker: the FRAMED protocol over a binary pipe.

    Serves the same RPC op set the socket workers speak
    (``transport.WorkerServer``: handshake, ``submit`` / ``tick`` / ``pop``
    / ``cancel`` / ``extract`` / ``adopt`` / ``detach`` / ``stats`` /
    ``close``) on an engine built from ``params`` / ``cfg`` / ``sec`` on
    ``device`` (CUDA unless the caller names another), with the stdio
    hardening contract: any torn, oversized, or junk frame is answered
    with a typed protocol-error frame (where the pipe still writes)
    followed by a clean audited shutdown — never an unhandled exception,
    never a zombie engine.  A clean EOF shuts down the same way.

    ``stdin`` / ``stdout`` must be BINARY streams; None uses this process's
    ``sys.std{in,out}.buffer`` (every byte on the pipe is a frame).  One
    process serves: a ``DSTPU_NUM_PROCESSES`` > 1 bootstrap is not ported
    yet (ROADMAP queue 1 item 7) and raises.  Returns the engine's
    zero-leak close audit once the stream ends."""
    import os
    import sys

    from .transport import FrameStream, WorkerServer

    if int(os.environ.get("DSTPU_NUM_PROCESSES", "1") or 1) > 1:
        raise NotImplementedError(
            "a multi-process DSTPU_* bootstrap (comm.init_distributed) is not "
            "ported yet (ROADMAP queue 1 item 7); a worker serves one process")
    stdin = stdin if stdin is not None else sys.stdin.buffer
    stdout = stdout if stdout is not None else sys.stdout.buffer
    engine = build_serve_engine(params, cfg, sec, serve=serve, device=device)
    server = WorkerServer(engine)
    server.serve_stream(FrameStream(rfile=stdin, wfile=stdout))
    return server.close_audit


__all__: List[Any] = [
    "MIXED_ROLE", "PREFILL_ROLE", "Worker", "WorkerPool", "serve_worker_main",
]
