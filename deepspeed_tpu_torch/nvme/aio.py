"""Python facade over the C++ async I/O engine — counterpart of
``deepspeed_tpu/nvme/aio.py`` (the reference's ``csrc/aio/py_lib``
``DeepSpeedAIO`` binding).

Buffers are contiguous CPU tensors, pinned or not.  Each buffer of an
op in flight is kept alive by the engine until the op is waited on, and a
failed read or write raises ``IOError`` at its ``wait`` / ``wait_all``.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..ops.op_builder import AsyncIOBuilder


class AsyncIOEngine:
    """Thread-pooled async reads / writes of CPU tensors to files."""

    def __init__(self, num_threads: int = 8, queue_depth: int = 32):
        self._lib = AsyncIOBuilder().load()
        self._h = self._lib.aio_create(num_threads, queue_depth)
        self._inflight: Dict[int, torch.Tensor] = {}  # keeps each op's buffer alive

    def close(self) -> None:
        if self._h:
            try:
                self.wait_all()
            finally:
                self._lib.aio_destroy(self._h)
                self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 -- interpreter teardown; close() raised already if asked
            pass

    @staticmethod
    def _buffer(t: torch.Tensor) -> torch.Tensor:
        if t.device.type != "cpu":
            raise ValueError(f"aio buffers are host tensors, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("buffer must be C-contiguous")
        return t

    def submit_write(self, path: str, t: torch.Tensor, offset: int = 0) -> int:
        t = self._buffer(t)
        op = self._lib.aio_submit_write(self._h, path.encode(), offset,
                                        t.numel() * t.element_size(), t.data_ptr())
        self._inflight[op] = t
        return op

    def submit_read(self, path: str, t: torch.Tensor, offset: int = 0) -> int:
        t = self._buffer(t)
        op = self._lib.aio_submit_read(self._h, path.encode(), offset,
                                       t.numel() * t.element_size(), t.data_ptr())
        self._inflight[op] = t
        return op

    def poll(self, op: int) -> int:
        """1 done, -1 failed, 0 pending (-2 an id already waited on)."""
        return self._lib.aio_poll(self._h, op)

    def wait(self, op: int) -> None:
        rc = self._lib.aio_wait(self._h, op)
        self._inflight.pop(op, None)
        if rc != 1:
            raise IOError(f"aio op {op} failed (rc={rc})")

    def wait_all(self) -> None:
        rc = self._lib.aio_wait_all(self._h)
        self._inflight.clear()
        if rc != 1:
            raise IOError(f"aio wait_all failed (rc={rc})")

    # synchronous conveniences
    def read(self, path: str, dtype: torch.dtype, shape) -> torch.Tensor:
        t = torch.empty(tuple(shape), dtype=dtype)
        self.wait(self.submit_read(path, t))
        return t

    def write(self, path: str, t: torch.Tensor) -> None:
        self.wait(self.submit_write(path, t.contiguous()))
