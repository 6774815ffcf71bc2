"""Tensor swapping to NVMe / local SSD through the async I/O engine —
counterpart of ``deepspeed_tpu/nvme/swap.py`` (the reference's
``runtime/swap_tensor/partitioned_param_swapper.py:37`` and the optimizer
swapper): a swap-out writes a tensor to ``<dir>/<name>.swp`` as its raw
bytes, a prefetch starts its read, a swap-in waits for it.  The files are
the JAX package's: raw C-order bytes, no header.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from .aio import AsyncIOEngine


@dataclass
class _Record:
    path: str
    dtype: torch.dtype
    shape: tuple
    pending_op: Optional[int] = None  # the write or read in flight
    buffer: Optional[torch.Tensor] = None  # a read's landing buffer


class TensorSwapper:
    """A pool of named tensors over a directory of files."""

    def __init__(self, swap_dir: str, num_threads: int = 8, queue_depth: int = 32):
        self.dir = swap_dir
        os.makedirs(swap_dir, exist_ok=True)
        self.engine = AsyncIOEngine(num_threads=num_threads, queue_depth=queue_depth)
        self._records: Dict[str, _Record] = {}

    def swap_out(self, name: str, t: torch.Tensor, blocking: bool = False) -> None:
        """Write the CPU tensor ``t`` to disk, asynchronously unless
        ``blocking``; the engine keeps ``t`` alive until the write lands."""
        host = t.detach().contiguous()
        path = os.path.join(self.dir, f"{name}.swp")
        rec = _Record(path=path, dtype=host.dtype, shape=tuple(host.shape))
        rec.pending_op = self.engine.submit_write(path, host)
        self._records[name] = rec
        if blocking:
            self.engine.wait(rec.pending_op)
            rec.pending_op = None

    def prefetch(self, name: str) -> None:
        """Start an async read, so that a later ``swap_in`` does not block."""
        rec = self._require(name)
        self._finish_write(rec)
        if rec.buffer is None:
            rec.buffer = torch.empty(rec.shape, dtype=rec.dtype)
            rec.pending_op = self.engine.submit_read(rec.path, rec.buffer)

    def swap_in(self, name: str) -> torch.Tensor:
        rec = self._require(name)
        self._finish_write(rec)
        if rec.buffer is None:
            self.prefetch(name)
        if rec.pending_op is not None:
            self.engine.wait(rec.pending_op)
            rec.pending_op = None
        out, rec.buffer = rec.buffer, None
        return out

    def release(self, name: str) -> None:
        rec = self._records.pop(name, None)
        if rec is not None:
            if rec.pending_op is not None:
                self.engine.wait(rec.pending_op)
            if os.path.exists(rec.path):
                os.unlink(rec.path)

    def _require(self, name: str) -> _Record:
        if name not in self._records:
            raise KeyError(f"tensor '{name}' was never swapped out")
        return self._records[name]

    def _finish_write(self, rec: _Record) -> None:
        if rec.pending_op is not None and rec.buffer is None:
            self.engine.wait(rec.pending_op)
            rec.pending_op = None

    def flush(self) -> None:
        """Block until every write in flight has landed."""
        for rec in self._records.values():
            self._finish_write(rec)

    def close(self) -> None:
        self.engine.close()
