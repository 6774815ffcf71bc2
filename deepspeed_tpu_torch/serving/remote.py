"""Out-of-process worker pool: subprocess spawn + socket-RPC worker facade —
the port of ``deepspeed_tpu/serving/remote.py``.

The deployment half of the transport layer (``serving/transport.py``):

* :func:`spawn_worker` launches one worker process (``python -m
  deepspeed_tpu_torch.serving.remote --spec ...``, a fresh interpreter
  through ``subprocess.Popen`` — never a fork of a process that touched
  CUDA) that builds its engine from a model-preset spec, binds a socket,
  announces the port on stdout, and serves the framed RPC protocol.  The
  spec's ``device`` is ``"cuda"`` unless the caller says ``"cpu"``; a child
  asked for CUDA with no card raises through ``ops.kernels.resolve_device``
  and the parent's ``wait_ready`` reports its stderr — a child never comes
  up quietly on the CPU.  Several children share one card, each with its
  own CUDA context, weights and KV pool; the kernels are built once in the
  parent before any spawn, so a child only loads the cached libraries.
  :func:`worker_launch_cmd` is the same argv for a multinode runner once
  the port has a launcher (ROADMAP queue 1 item 9); a child that finds
  ``DSTPU_NUM_PROCESSES`` > 1 raises, as the multi-process bootstrap is
  item 7.
* :class:`RemoteWorker` implements the router's worker interface
  (``serving/pool.py Worker``) over an :class:`~.transport.RpcClient` plus
  a dedicated heartbeat channel watched by the pool's
  :class:`~.transport.HeartbeatMonitor`.  Death is *discovered*: a lease
  expiry or an exhausted retry budget flips ``healthy()`` and the router
  replays the worker's in-flight requests from their prompts.  A kernel or
  CUDA error in the child comes back typed and is raised here as
  ``ops.kernels.KernelError`` from the op that met it (``finish_tick`` for
  a tick), so it propagates out of ``Router.tick`` — never a RETRY_LATER,
  a replay, a worker death or a FAILED request.
* :class:`RemotePool` spawns N workers (in parallel), dials both channels
  to each, and is a drop-in for ``WorkerPool`` under ``serving.Router``.

Teardown discipline (the no-zombies contract): every spawned child is
reaped — graceful ``close`` op first, then terminate/kill with waits —
and both ``kill()`` and ``close()`` are idempotent, so a worker that died
between health checks tears down cleanly no matter which path notices
first.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

from ..config.config import RouterConfig, _coerce
from ..inference.sampling import SamplingParams
from ..inference.scheduler import RETRY_LATER, SubmitResult
from ..ops.kernels import KernelError
from ..telemetry import Telemetry
from . import transport
from .handoff import KVHandoff
from .pool import MIXED_ROLE, PREFILL_ROLE
from .transport import (
    ChaosLink,
    HEARTBEAT_CHANNEL,
    HeartbeatMonitor,
    METRICS_CHANNEL,
    MetricsChannel,
    ProtocolError,
    RPC_CHANNEL,
    RpcClient,
    TransportError,
    WorkerDead,
)

READY_PREFIX = "DSTPU_WORKER_READY "


# -- spawn path ---------------------------------------------------------------
def worker_launch_cmd(spec: Dict[str, Any],
                      python: Optional[str] = None) -> List[str]:
    """The argv that runs one socket worker — locally via
    :func:`spawn_worker`; across hosts it is what a multinode runner would
    fan out once the port has a launcher (ROADMAP queue 1 item 9)."""
    return [python or sys.executable, "-m", "deepspeed_tpu_torch.serving.remote",
            "--spec", json.dumps(spec)]


@dataclass
class SpawnedWorker:
    """One live worker subprocess + its announced address."""

    proc: subprocess.Popen
    spec: Dict[str, Any]
    host: str = "127.0.0.1"
    port: Optional[int] = None
    pid: Optional[int] = None
    stderr_path: Optional[str] = None  # child stderr goes to a FILE — a
    # PIPE nobody drains would block the worker after ~64 KB of logging
    # and read as a (self-inflicted) death

    def stderr_tail(self, nbytes: int = 2000) -> str:
        if not self.stderr_path:
            return ""
        try:
            with open(self.stderr_path, errors="replace") as fh:
                return fh.read()[-nbytes:]
        except OSError:
            return ""

    def wait_ready(self, timeout_s: float = 180.0) -> "SpawnedWorker":
        """Block until the child announces its listening port (the
        ``DSTPU_WORKER_READY`` stdout line).  The deadline is REAL: stdout
        is polled via select + raw reads, so a child that wedges before
        announcing (and never exits) raises at the timeout instead of
        blocking in a readline forever."""
        import select

        deadline = time.monotonic() + timeout_s
        fd = self.proc.stdout.fileno()
        buf = b""
        while True:
            for raw in buf.split(b"\n"):
                line = raw.decode(errors="replace").strip()
                if line.startswith(READY_PREFIX):
                    info = json.loads(line[len(READY_PREFIX):])
                    self.port = int(info["port"])
                    self.pid = int(info.get("pid", self.proc.pid))
                    return self
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"worker process died before ready "
                    f"(rc={self.proc.returncode}):\n{self.stderr_tail()}")
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise RuntimeError(
                    f"worker never announced readiness within {timeout_s}s "
                    f"(stdout so far: {buf[-200:]!r})")
            ready, _, _ = select.select([fd], [], [], min(remaining, 0.2))
            if ready:
                chunk = os.read(fd, 65536)
                if not chunk and self.proc.poll() is None:
                    time.sleep(0.05)
                buf += chunk

    def kill_process(self) -> None:
        """Hard kill (the chaos 'real worker-process kill')."""
        if self.proc.poll() is None:
            self.proc.kill()

    def reap(self, timeout_s: float = 10.0) -> Optional[int]:
        """Ensure the child is dead AND waited on (no zombies).  Graceful
        first (terminate), then kill.  Idempotent."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                try:
                    self.proc.wait(timeout=timeout_s)
                except subprocess.TimeoutExpired:
                    return None
        else:
            # already exited: wait() reaps the zombie entry, idempotently
            self.proc.wait()
        for stream in (self.proc.stdout, self.proc.stderr, self.proc.stdin):
            if stream is not None:
                try:
                    stream.close()
                except OSError:
                    pass
        if self.stderr_path:
            try:
                os.unlink(self.stderr_path)
            except OSError:
                pass
            self.stderr_path = None
        return self.proc.returncode


def spawn_worker(spec: Dict[str, Any], *, python: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None,
                 wait_ready: bool = True,
                 ready_timeout_s: float = 180.0) -> SpawnedWorker:
    """Launch one worker subprocess.  ``spec`` (JSON-able) names the model
    preset/seed/dtype, the device and the engine config — the worker builds
    its own params (same seed + device type => bit-identical weights, so
    replays are token-identical).  With ``wait_ready=False`` the caller
    spawns a whole pool first and waits afterwards (parallel engine
    bring-up).  The child finds this package through ``PYTHONPATH``
    whatever its working directory."""
    import tempfile

    child_env = dict(os.environ)
    child_env.update(env or {})
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = child_env.get("PYTHONPATH", "")
    child_env["PYTHONPATH"] = root + (os.pathsep + path if path else "")
    err_fd, err_path = tempfile.mkstemp(prefix="dstpu_worker_",
                                        suffix=".stderr")
    try:
        proc = subprocess.Popen(
            worker_launch_cmd(spec, python=python), env=child_env,
            stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
            stderr=err_fd, text=True, bufsize=1,
        )
    finally:
        os.close(err_fd)  # the child holds its own copy
    sw = SpawnedWorker(proc=proc, spec=dict(spec),
                       host=spec.get("host", "127.0.0.1"),
                       stderr_path=err_path)
    if wait_ready:
        sw.wait_ready(ready_timeout_s)
    return sw


def _worker_main(spec: Dict[str, Any]) -> None:
    """Worker-process entry: engine from spec on its device -> bind ->
    announce -> serve the framed socket protocol until ``close``.  Spec
    keys: ``preset``, ``seed``, ``dtype``, ``max_seq_len``, ``sec`` (the
    ``ServeEngineConfig``), ``serve`` (the ``ServeConfig``), ``device``
    (``"cuda"`` unless ``"cpu"``), ``telemetry`` (record histograms and
    spans for the fleet collector), ``host`` / ``port`` / ``worker`` /
    ``max_frame_bytes``."""
    if int(os.environ.get("DSTPU_NUM_PROCESSES", "1") or 1) > 1:
        raise NotImplementedError(
            "a multi-process DSTPU_* bootstrap (comm.init_distributed) is not "
            "ported yet (ROADMAP queue 1 item 7); a worker serves one process")
    import torch

    from ..inference.engine_v2 import build_serve_engine
    from ..models.presets import get_preset
    from ..models.transformer import init_params
    from ..ops.kernels import resolve_device

    device = resolve_device(spec.get("device", "cuda"))
    name = spec.get("dtype", "float32")
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"spec dtype must be float32|bfloat16, got {name!r}")
    dtype = getattr(torch, name)
    cfg = get_preset(spec.get("preset", "tiny"), max_seq_len=spec.get("max_seq_len", 256),
                     dtype=dtype)
    params = init_params(cfg, seed=int(spec.get("seed", 0)), device=device, dtype=dtype)
    telemetry = Telemetry(True) if spec.get("telemetry") else None
    engine = build_serve_engine(params, cfg, dict(spec.get("sec") or {}),
                                telemetry=telemetry, serve=spec.get("serve"),
                                device=device)
    server = transport.WorkerServer(
        engine,
        max_frame_bytes=int(spec.get("max_frame_bytes",
                                     transport.DEFAULT_MAX_FRAME_BYTES)),
        identity={"worker": spec.get("worker", 0)},
    )
    server.bind(spec.get("host", "127.0.0.1"), int(spec.get("port", 0)))
    print(READY_PREFIX + json.dumps({"port": server.port,
                                     "pid": os.getpid()}), flush=True)
    server.serve_socket()


def main(argv: Optional[Sequence[str]] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    spec: Dict[str, Any] = {}
    it = iter(argv)
    for a in it:
        if a == "--spec":
            spec = json.loads(next(it))
        elif a == "--spec-file":
            with open(next(it), encoding="utf-8") as fh:
                spec = json.load(fh)
    _worker_main(spec)


# -- the remote worker facade -------------------------------------------------
@dataclass
class _ReqView:
    """Router-facing request state (the remote mirror of ``ServeRequest``
    fields the router reads)."""

    state: str
    error: Optional[str] = None
    generated: int = 0
    cancel_requested: bool = False


class RemoteWorker:
    """One out-of-process worker behind the socket RPC — implements the
    same surface the router drives on the in-process ``pool.Worker``.

    Liveness: ``healthy()`` consults the pool's heartbeat lease and the
    RPC client's retry verdict.  Any op that exhausts its retries marks
    the transport dead; the ROUTER then discovers the death on its next
    tick and replays — ops here degrade to typed RETRY_LATER results
    instead of raising mid-route."""

    def __init__(self, index: int, host: str, port: int,
                 monitor: HeartbeatMonitor, role: str = MIXED_ROLE,
                 handle: Optional[SpawnedWorker] = None,
                 config: Optional[RouterConfig] = None, faults=None,
                 hb_faults=None):
        if role not in (PREFILL_ROLE, MIXED_ROLE):
            raise ValueError(f"unknown worker role {role!r}")
        self.index = index
        self.host, self.port = host, port
        self.role = role
        self.handle = handle
        self.monitor = monitor
        self.config = config or RouterConfig()
        self.alive = True
        self.backoff_until = 0.0
        self.close_audit: Optional[Dict[str, int]] = None
        # one chaos link per THREAD (rpc = router thread, hb = monitor
        # thread: seeded injectors must never be raced across threads), with
        # a shared partition window so a partition blocks every channel
        self.chaos = ChaosLink(faults, endpoint=index)
        self._hb_chaos = ChaosLink(hb_faults, endpoint=index,
                                   partition_cell=self.chaos._partition)
        self._transport_dead = False
        # lazy third channel for the fleet collector THREAD (rpc = router
        # thread, hb = monitor thread): dialed on the first export_metrics
        # call so routers without a collector never pay the connection
        self._metrics_chan: Optional[MetricsChannel] = None
        self._load: Dict[str, Any] = {}
        self._views: Dict[int, _ReqView] = {}
        self._tick_rid: Optional[int] = None
        self.last_burst_ticks = 1  # worker ticks the last finish collected
        # ms of the last handoff this worker was the source / target of
        self.last_handoff_ms: Dict[str, float] = {}
        self.last_adopt_ms: Dict[str, float] = {}
        cfg = self.config
        self.client = RpcClient(
            self._dial_rpc,
            deadline_ms=cfg.rpc_deadline_ms,
            max_attempts=cfg.rpc_max_attempts,
            backoff_ms=cfg.rpc_backoff_ms,
            backoff_max_ms=cfg.rpc_backoff_max_ms,
            jitter_seed=index,
            max_frame_bytes=cfg.max_frame_bytes,
        )
        self.identity = self.client.connect()
        monitor.watch(index, self._dial_hb(), redial=self._dial_hb)

    def _dial_rpc(self):
        cfg = self.config
        return transport.dial(
            self.host, self.port, RPC_CHANNEL,
            connect_timeout=cfg.connect_timeout_ms / 1e3,
            max_frame_bytes=cfg.max_frame_bytes, chaos=self.chaos,
            hello_extra={"client_nonce": self.client.nonce})

    def _dial_hb(self):
        cfg = self.config
        # short dial budget: the shared monitor thread REDIALS through this
        # closure, and a partitioned peer's connect must not starve every
        # other worker's pings into a false lease expiry
        timeout_ms = min(cfg.connect_timeout_ms,
                         max(4 * cfg.heartbeat_interval_ms, 250.0))
        stream, _ = transport.dial(
            self.host, self.port, HEARTBEAT_CHANNEL,
            connect_timeout=timeout_ms / 1e3,
            max_frame_bytes=cfg.max_frame_bytes, chaos=self._hb_chaos)
        return stream

    def _dial_metrics(self):
        cfg = self.config
        # no chaos injector: the seeded links are per-thread (rpc/hb), and
        # a dropped pull already degrades to None — chaos coverage of the
        # collector rides the partition windows severing the whole address
        stream, _ = transport.dial(
            self.host, self.port, METRICS_CHANNEL,
            connect_timeout=cfg.connect_timeout_ms / 1e3,
            max_frame_bytes=cfg.max_frame_bytes)
        return stream

    # -- liveness ------------------------------------------------------------
    def healthy(self) -> bool:
        return (self.alive and not self._transport_dead
                and not self.monitor.lease_expired(self.index))

    def _abort(self):
        """RPC-wait abort hook: stop waiting on a worker whose lease
        already expired (the monitor is the death detector; the RPC
        deadline is only the backstop)."""
        if self._transport_dead:
            return "transport dead"
        if self.monitor.lease_expired(self.index):
            return "heartbeat lease expired"
        return None

    def _call(self, op: Dict[str, Any], blobs: Sequence[bytes] = (),
              deadline_ms: Optional[float] = None) -> Dict[str, Any]:
        """One exactly-once RPC.  Raises :class:`WorkerDead` after marking
        the transport dead (callers translate per-op).  A LOCAL send
        refusal (``post``'s oversized-payload ProtocolError — nothing was
        sent) propagates as-is: the request is impossible, the worker is
        fine, and condemning it would kill a healthy process."""
        try:
            reply, rblobs = self.client.call(
                op, blobs, deadline_ms=deadline_ms, abort=self._abort)
        except ProtocolError:
            raise
        except WorkerDead:
            self._transport_dead = True
            raise
        except TransportError as e:
            self._transport_dead = True
            raise WorkerDead(str(e))
        _raise_kernel_error(self.index, reply)
        reply["_blobs"] = rblobs
        if reply.get("load"):
            self._load = reply["load"]
        return reply

    @staticmethod
    def _submit_result(uid: int, reply: Dict[str, Any]) -> SubmitResult:
        if not reply.get("ok"):
            err = reply.get("error") or {}
            return SubmitResult(uid, RETRY_LATER,
                                f"worker op failed: {err.get('kind')}: "
                                f"{err.get('detail')}")
        r = reply["result"]
        return SubmitResult(int(r["uid"]), r["reason"], r.get("detail", ""),
                            retry_after_ms=r.get("retry_after_ms"))

    # -- the router-facing op surface ----------------------------------------
    def try_submit(self, uid: int, tokens: Sequence[int],
                   sampling: SamplingParams,
                   deadline_ms: Optional[float] = None,
                   ttft_deadline_ms: Optional[float] = None) -> SubmitResult:
        op = {"op": "submit", "uid": int(uid),
              "tokens": [int(t) for t in tokens],
              "sampling": _sampling_dict(sampling),
              "deadline_ms": deadline_ms, "ttft_deadline_ms": ttft_deadline_ms}
        try:
            return self._submit_result(uid, self._call(op))
        except WorkerDead as e:
            return SubmitResult(uid, RETRY_LATER, f"worker unreachable: {e}",
                                retry_after_ms=self.config.retry_backoff_ms)

    def begin_tick(self, n: int = 1) -> None:
        """Pipelined tick: post the op now, collect in ``finish_tick`` —
        N workers' forward passes overlap across processes.  ``n`` > 1
        posts ONE ``step_burst`` RPC covering up to n worker ticks (the
        wire half of megastep decode) instead of n tick round trips; the
        per-token results demux off the reply's cumulative counts in
        ``finish_tick``.  Exactly-once semantics and death replay are
        unchanged — the burst is a single rid, and a worker dying mid-burst
        surfaces exactly like one dying mid-tick (transport dead, the
        router replays its requests from the prompt)."""
        if self._tick_rid is None:
            op = {"op": "tick"} if n <= 1 \
                else {"op": "step_burst", "n": int(n)}
            self._tick_rid = self.client.post(op)

    def finish_tick(self) -> None:
        rid, self._tick_rid = self._tick_rid, None
        if rid is None:
            return
        try:
            reply, _ = self.client.wait(rid, abort=self._abort)
        except (WorkerDead, TransportError):
            self._transport_dead = True
            return
        _raise_kernel_error(self.index, reply)
        if reply.get("load"):
            self._load = reply["load"]
        views = {}
        for uid, r in (reply.get("requests") or {}).items():
            views[int(uid)] = _ReqView(
                state=r["state"], error=r.get("error"),
                generated=int(r.get("generated", 0)),
                cancel_requested=bool(r.get("cancel_requested")),
            )
        self._views = views
        self.last_burst_ticks = int(reply.get("ticks", 1))

    def tick(self, n: int = 1) -> None:
        self.begin_tick(n)
        self.finish_tick()

    def request_view(self, uid: int) -> Optional[_ReqView]:
        return self._views.get(uid)

    def pop_result(self, uid: int):
        popped = self.pop_state(uid)
        return popped[2] if popped else []

    def pop_state(self, uid: int):
        """(state, error, tokens) for a terminal request, popped."""
        try:
            reply = self._call({"op": "pop", "uid": int(uid)})
        except WorkerDead:
            return None
        self._views.pop(uid, None)
        res = reply.get("result")
        if not res:
            return None
        return res["state"], res.get("error"), list(res["tokens"])

    def cancel(self, uid: int) -> bool:
        try:
            return bool(self._call({"op": "cancel",
                                    "uid": int(uid)}).get("cancelled"))
        except WorkerDead:
            return False

    def detach_migrated(self, uid: int) -> bool:
        try:
            migrated = bool(self._call({"op": "detach",
                                        "uid": int(uid)}).get("migrated"))
        except WorkerDead:
            return False
        if migrated:
            self._views.pop(uid, None)
        return migrated

    def extract_handoff(self, uid: int, fmt: str) -> KVHandoff:
        t0 = time.perf_counter()
        reply = self._call({"op": "extract", "uid": int(uid), "fmt": fmt})
        if not reply.get("ok"):
            err = reply.get("error") or {}
            raise RuntimeError(f"extract failed on worker {self.index}: "
                               f"{err.get('detail')}")
        t1 = time.perf_counter()
        ho = transport.decode_handoff(reply["handoff"], reply["_blobs"])
        # where the migration's time went: the worker's extract / encode,
        # this side's decode, the round trip as a whole
        self.last_handoff_ms = {**(reply.get("ms") or {}), "rpc": 1e3 * (t1 - t0),
                                "decode": 1e3 * (time.perf_counter() - t1)}
        return ho

    def adopt_handoff(self, ho: KVHandoff, sampling: SamplingParams,
                      deadline_ms: Optional[float] = None,
                      ttft_deadline_ms: Optional[float] = None) -> SubmitResult:
        t0 = time.perf_counter()
        meta, blobs = transport.encode_handoff(ho)
        encode_ms = 1e3 * (time.perf_counter() - t0)
        op = {"op": "adopt", "handoff": meta,
              "sampling": _sampling_dict(sampling),
              "deadline_ms": deadline_ms, "ttft_deadline_ms": ttft_deadline_ms}
        try:
            t1 = time.perf_counter()
            reply = self._call(op, blobs)
            self.last_adopt_ms = {**(reply.get("ms") or {}), "encode": encode_ms,
                                  "rpc": 1e3 * (time.perf_counter() - t1)}
            return self._submit_result(ho.uid, reply)
        except ProtocolError as e:
            # local refusal (payload over max_frame_bytes): adoption is
            # impossible on THIS wire, the worker is healthy — the router
            # falls back to decoding on the source
            return SubmitResult(ho.uid, RETRY_LATER,
                                f"handoff payload refused: {e}")
        except WorkerDead as e:
            return SubmitResult(ho.uid, RETRY_LATER,
                                f"worker unreachable: {e}",
                                retry_after_ms=self.config.retry_backoff_ms)

    def export_metrics(self, spans: bool = False) -> Optional[Dict[str, Any]]:
        """Mergeable registry snapshot pulled over the dedicated metrics
        channel (same facade as the in-process ``pool.Worker``).  Called
        from the fleet collector thread ONLY — the channel is single-owner
        like rpc/heartbeat.  Degrades to None when the worker is dead or
        the pull fails (death discovery belongs to the heartbeat lease,
        not the collector)."""
        if not self.alive or self._transport_dead:
            return None
        if self._metrics_chan is None:
            self._metrics_chan = MetricsChannel(self._dial_metrics)
        reply = self._metrics_chan.pull(
            spans=spans, timeout=self.config.rpc_deadline_ms / 1e3)
        if reply is None:
            return None
        return {"metrics": reply.get("metrics") or {},
                "ts": reply.get("ts"),
                "events": reply.get("events") or []}

    def stats(self) -> Dict[str, Any]:
        try:
            reply = self._call({"op": "stats"})
        except WorkerDead:
            return {}
        return {k: reply.get(k, {}) for k in ("serve", "sched", "launches")} | {
            k: reply.get(k) for k in ("memory_allocated", "reply_cache_bytes")}

    def apply_knobs(self, knobs: Dict[str, Any]) -> Dict[str, Any]:
        """Push a live-retune batch to the worker process (staged on its
        scheduler, applied at its next tick).  A validation refusal comes
        back as the typed error reply and raises ``ValueError`` — the same
        contract as the in-process worker; a dead worker raises
        ``WorkerDead`` for the router's condemnation path."""
        reply = self._call({"op": "apply_knobs", "knobs": dict(knobs)})
        if not reply.get("ok"):
            err = reply.get("error") or {}
            raise ValueError(
                f"apply_knobs refused on worker {self.index}: "
                f"{err.get('detail')}")
        return dict(reply.get("staged") or {})

    # -- load signals (from the latest tick/op reply) ------------------------
    @property
    def ns(self) -> str:
        return f"worker{self.index}"

    @property
    def block_size(self) -> int:
        return int((self.identity or {}).get("block_size", 8))

    @property
    def disagg_default(self) -> int:
        return int((self.identity or {}).get("disagg_default", 512))

    @property
    def queue_depth(self) -> int:
        return int(self._load.get("queue_depth", 0))

    @property
    def running(self) -> int:
        return int(self._load.get("running", 0))

    @property
    def load(self) -> int:
        return self.queue_depth + self.running

    @property
    def headroom_blocks(self) -> int:
        return int(self._load.get("headroom_blocks", 0))

    @property
    def headroom_fraction(self) -> float:
        total = max(int(self._load.get("total_blocks", 1)), 1)
        return self.headroom_blocks / total

    @property
    def shedding(self) -> bool:
        return bool(self._load.get("shedding", False))

    def retry_after_ms(self) -> float:
        return float(self._load.get("retry_after_ms",
                                    self.config.retry_backoff_ms))

    def ttft_p50_ms(self) -> float:
        return float(self._load.get("ttft_p50_ms", 0.0))

    @property
    def prompt_tokens_total(self) -> int:
        return int(self._load.get("prompt_tokens_total", 0))

    @property
    def cached_prompt_tokens(self) -> int:
        return int(self._load.get("cached_prompt_tokens", 0))

    # -- lifecycle -----------------------------------------------------------
    def kill(self) -> None:
        """Tear down a DEAD (or condemned) worker: stop watching, sever the
        transport, and REAP the subprocess — no zombies, idempotent even
        when the process already exited between health checks."""
        self.alive = False
        self.monitor.unwatch(self.index)
        self.client.close()
        chan, self._metrics_chan = self._metrics_chan, None
        if chan is not None:
            chan.close()
        if self.handle is not None:
            self.handle.reap()

    def close(self) -> Optional[Dict[str, int]]:
        """Graceful teardown: ``close`` op (audited ``engine.close()`` in
        the worker) then reap.  Falls back to :meth:`kill` when the worker
        is already unreachable.  Idempotent."""
        if not self.alive:
            return self.close_audit
        if not self._transport_dead and not self.monitor.lease_expired(
                self.index):
            try:
                reply = self._call({"op": "close"})
                self.close_audit = reply.get("audit")
            except (WorkerDead, TransportError):
                self.close_audit = None
        self.kill()
        return self.close_audit


def _raise_kernel_error(index: int, reply: Dict[str, Any]) -> None:
    """A ``kernel`` error reply (a kernel or CUDA fault in the worker
    process) raises ``KernelError`` here: it is the caller's, never a
    retry, a replay or a failed request."""
    err = reply.get("error") or {}
    if not reply.get("ok") and err.get("kind") == "kernel":
        raise KernelError(f"worker {index}: {err.get('detail')}")


def _sampling_dict(s: SamplingParams) -> Dict[str, Any]:
    return {"temperature": s.temperature, "top_k": s.top_k, "top_p": s.top_p,
            "max_new_tokens": s.max_new_tokens, "stop_token": s.stop_token}


# -- the pool -----------------------------------------------------------------
class RemotePool:
    """N subprocess workers behind the socket transport — a drop-in for
    ``WorkerPool`` under ``serving.Router``.  Spawns every process first
    (parallel engine bring-up), then dials RPC + heartbeat channels and
    starts the shared :class:`HeartbeatMonitor`.  On the card the kernels
    are built in this process first (``ops.kernels.build``)."""

    def __init__(self, spec: Dict[str, Any], n_workers: int = 2,
                 prefill_workers: int = 0, telemetry=None,
                 config: Optional[RouterConfig] = None, faults=None,
                 hb_faults=None, python: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None,
                 ready_timeout_s: float = 300.0):
        if n_workers < 1:
            raise ValueError(f"need at least one worker, got {n_workers}")
        if not 0 <= prefill_workers < n_workers:
            raise ValueError(
                f"prefill_workers ({prefill_workers}) must leave at least "
                f"one decode-capable worker of {n_workers}")
        self.telemetry = Telemetry.ensure(telemetry)
        self.config = (config if isinstance(config, RouterConfig)
                       else _coerce(RouterConfig, config))
        if spec.get("device", "cuda") != "cpu":
            # build every kernel HERE, before any child starts: a child's
            # first nvcc must never land inside wait_ready or a lease
            from ..ops import kernels

            kernels.build()
        self.monitor = HeartbeatMonitor(
            interval_ms=self.config.heartbeat_interval_ms,
            lease_ms=self.config.lease_ms)
        handles = [
            spawn_worker({**spec, "worker": i}, python=python, env=env,
                         wait_ready=False)
            for i in range(n_workers)
        ]
        self.workers: List[RemoteWorker] = []
        try:
            for i, h in enumerate(handles):
                h.wait_ready(ready_timeout_s)
                role = PREFILL_ROLE if i < prefill_workers else MIXED_ROLE
                self.workers.append(RemoteWorker(
                    i, h.host, h.port, self.monitor, role=role, handle=h,
                    config=self.config, faults=faults, hb_faults=hb_faults))
        except Exception:
            for h in handles:
                h.reap()
            self.monitor.stop()
            raise
        self.monitor.start()

    def __len__(self) -> int:
        return len(self.workers)

    @property
    def alive(self) -> List[RemoteWorker]:
        return [w for w in self.workers if w.alive]

    @property
    def decode_workers(self) -> List[RemoteWorker]:
        return [w for w in self.alive if w.role == MIXED_ROLE]

    @property
    def prefill_workers(self) -> List[RemoteWorker]:
        return [w for w in self.alive if w.role == PREFILL_ROLE]

    def prefix_hit_rate(self) -> float:
        total = sum(w.prompt_tokens_total for w in self.workers)
        cached = sum(w.cached_prompt_tokens for w in self.workers)
        return cached / total if total else 0.0

    def close(self) -> List[Optional[Dict[str, int]]]:
        """Graceful close of every live worker (audited in-worker
        ``engine.close()``), reap everything, stop the monitor.  Killed
        workers report ``None`` (their audit died with the process);
        surviving workers report their zero-leak audit."""
        audits = [w.close() if w.alive else w.close_audit
                  for w in self.workers]
        self.monitor.stop()
        return audits


def build_remote_router(spec: Dict[str, Any], router=None, telemetry=None,
                        faults=None, hb_faults=None,
                        python: Optional[str] = None,
                        env: Optional[Dict[str, str]] = None):
    """One-call out-of-process front end: spawn ``router.n_workers``
    subprocess workers from ``spec`` and wrap them in the same ``Router``
    the in-process pool uses.  ``faults`` arms the NETWORK chaos points
    (``conn_drop``/``conn_delay``/``partial_write``/``partition``, per-
    worker uids) on the router-thread RPC channels; ``hb_faults`` arms the
    heartbeat-thread channels (``heartbeat_loss``/``partition``) — two
    injectors so the two threads never race one seeded RNG, with partition
    windows shared per worker either way."""
    from .router import Router

    rc = router if isinstance(router, RouterConfig) \
        else _coerce(RouterConfig, router)
    pool = RemotePool(spec, n_workers=rc.n_workers,
                      prefill_workers=rc.prefill_workers, telemetry=telemetry,
                      config=rc, faults=faults, hb_faults=hb_faults,
                      python=python, env=env)
    return Router(pool, rc, faults=faults)


__all__ = [
    "READY_PREFIX", "RemotePool", "RemoteWorker", "SpawnedWorker",
    "build_remote_router", "main", "spawn_worker", "worker_launch_cmd",
]


if __name__ == "__main__":
    main()
