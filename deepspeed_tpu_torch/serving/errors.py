"""The serve front end's typed transport failures, re-exported from
``serving/transport.py`` (JAX ``serving/transport.py:99-135``), where the
socket transport raises them: ``WorkerDead`` is what the router catches
when a worker cannot answer (lease expired, retries exhausted, process
exit).  A kernel or CUDA error is never a worker death
(``ops.kernels.surfaces``).
"""
from __future__ import annotations

from .transport import (  # noqa: F401
    ConnectionLost,
    ProtocolError,
    RpcTimeout,
    TransportError,
    WorkerDead,
)
