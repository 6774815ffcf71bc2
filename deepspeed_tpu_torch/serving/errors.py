"""The serve front end's typed transport failure.

``WorkerDead`` is what the router catches when a worker cannot answer
(JAX ``serving/transport.py``).  In-process pools die only through the
chaos ``worker_kill`` point, so nothing raises it yet; the socket transport
(ROADMAP queue 1 item 6) will raise and re-export it.  A kernel or CUDA
error is never a worker death (``ops.kernels.surfaces``).
"""
from __future__ import annotations


class TransportError(RuntimeError):
    """Base of the transport's typed failures."""


class WorkerDead(TransportError):
    """A worker is gone (lease expired, retries exhausted, process exit)."""
