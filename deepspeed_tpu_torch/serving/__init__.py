"""Serve front end: a disaggregated request router over N engine workers —
the port of ``deepspeed_tpu/serving``.

``pool.py`` stamps out in-process workers from one ``ServeEngineConfig``
(per-worker telemetry namespaces, leak-audited teardown, shared weights),
``router.py`` owns the client-facing lifecycle (prefix-affinity routing,
SLO-aware admission, worker-death replay), ``handoff.py`` is the paged-KV
wire of prefill/decode disaggregation (optionally int8 / fp8 through
``comm.qcomm``'s payload codec), ``transport.py`` is the fault-tolerant
socket RPC (framing, exactly-once retries, heartbeat health checks,
network chaos; the DSTP wire byte for byte), and ``remote.py`` spawns real
worker subprocesses behind it — on the card, each with its own CUDA
context.
"""
from .handoff import KVHandoff, extract_request, inject_request  # noqa: F401
from .pool import (  # noqa: F401
    MIXED_ROLE,
    PREFILL_ROLE,
    Worker,
    WorkerPool,
    serve_worker_main,
)
from .remote import (  # noqa: F401
    RemotePool,
    RemoteWorker,
    build_remote_router,
    spawn_worker,
    worker_launch_cmd,
)
from .router import Router, RouterRequest, build_router  # noqa: F401
from .transport import (  # noqa: F401
    ConnectionLost,
    FrameStream,
    HeartbeatMonitor,
    ProtocolError,
    RpcClient,
    RpcTimeout,
    TransportError,
    WorkerDead,
    WorkerServer,
)
