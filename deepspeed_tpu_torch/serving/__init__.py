"""Serve front end — the port of ``deepspeed_tpu/serving`` for workers in
one process on one card: ``pool.py`` stamps out workers from one
``ServeEngineConfig`` (per-worker telemetry namespaces, leak-audited
teardown, shared weights), ``router.py`` owns the client-facing lifecycle
(prefix-affinity routing, SLO-aware admission, worker-death replay), and
``handoff.py`` is the paged-KV wire of prefill/decode disaggregation
(optionally int8 / fp8 through ``comm.qcomm``'s payload codec).

The socket transport (JAX ``transport.py``), subprocess workers
(``remote.py``) and ``serve_worker_main`` are ROADMAP queue 1 item 6's
second half; ``WorkerDead`` already lives in ``errors.py``.
"""
from .errors import TransportError, WorkerDead  # noqa: F401
from .handoff import KVHandoff, extract_request, inject_request  # noqa: F401
from .pool import MIXED_ROLE, PREFILL_ROLE, Worker, WorkerPool  # noqa: F401
from .router import Router, RouterRequest, build_router  # noqa: F401
