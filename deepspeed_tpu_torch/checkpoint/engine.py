"""Pluggable checkpoint engines, sync and async — counterpart of
``deepspeed_tpu/checkpoint/engine.py`` (the reference's
``runtime/checkpoint_engine/checkpoint_engine.py:10`` create / save / load /
commit contract, ``TorchCheckpointEngine`` and ``NebulaCheckpointEngine``).

JAX hands its tree to orbax; the port writes its own files, one per
logical leaf of the training state, named by the leaf's tree path
(``params/layers/attn/wq``, ``opt_state/mu/...``, ``step``), as raw
little-endian bytes, with ``manifest.json`` giving each leaf's dtype and
shape.  Nothing is pickled.  A load reads every file into the engine's own
tensors in place (the flat master, gradient and moment buffers keep their
views), checking dtype and shape against the manifest.

``AsyncCheckpointEngine.save`` snapshots the state into pinned host
buffers on a side CUDA stream (the compute stream waits for that copy on
the device, never on the host) and writes the files on a background
thread, so the next ``train_batch`` does not wait for the disk.
``commit`` / ``wait`` block until the write is done and then run the
commit callback, which is where ``checkpoint/saving.py`` publishes the tag
and ``latest``: ``latest`` never names a partial checkpoint.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import weakref
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..utils.logging import log_dist

MANIFEST = "manifest.json"
# the async engines alive: a run's final save still commits its 'latest'
# at exit if nobody waited on it (weak, so an engine's pinned buffers go
# with it)
_ASYNC_ENGINES: "weakref.WeakSet[AsyncCheckpointEngine]" = weakref.WeakSet()


@atexit.register
def _commit_pending_at_exit() -> None:
    for ce in list(_ASYNC_ENGINES):
        ce.wait()

_DTYPES = {str(d).replace("torch.", ""): d for d in (
    torch.float32, torch.float16, torch.bfloat16, torch.float64, torch.int64, torch.int32,
    torch.int16, torch.int8, torch.uint8, torch.bool)}


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's bytes (little-endian, C order) as a uint8 array that
    shares its memory."""
    return t.reshape(-1).view(torch.uint8).numpy()


def write_leaves(host: Dict[str, torch.Tensor], path: str) -> int:
    """Write each CPU tensor of ``host`` to ``path/<name>`` and the
    manifest; returns the bytes written."""
    manifest = {}
    total = 0
    for name, t in host.items():
        p = os.path.join(path, name)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as fh:
            fh.write(memoryview(_host_bytes(t)))
        manifest[name] = {"dtype": str(t.dtype).replace("torch.", ""), "shape": list(t.shape)}
        total += t.numel() * t.element_size()
    with open(os.path.join(path, MANIFEST), "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
    return total


def read_leaves(path: str, targets: Dict[str, torch.Tensor]) -> None:
    """Copy every leaf of ``targets`` from ``path/<name>`` in place; raise on
    a leaf the checkpoint lacks or whose dtype or shape differs."""
    with open(os.path.join(path, MANIFEST)) as fh:
        manifest = json.load(fh)
    for name, dst in targets.items():
        entry = manifest.get(name)
        if entry is None:
            raise KeyError(f"checkpoint {path} has no leaf {name!r}")
        dtype = _DTYPES[entry["dtype"]]
        if dtype != dst.dtype or tuple(entry["shape"]) != tuple(dst.shape):
            raise ValueError(
                f"leaf {name!r}: checkpoint holds {entry['dtype']} {entry['shape']}, the "
                f"engine {str(dst.dtype).replace('torch.', '')} {list(dst.shape)}")
        raw = np.fromfile(os.path.join(path, name), dtype=np.uint8)
        src = torch.from_numpy(raw).view(dtype).reshape(dst.shape)
        with torch.no_grad():
            dst.copy_(src)


class CheckpointEngine:
    """The reference's interface (``checkpoint_engine.py:10``)."""

    def create(self, tag: str) -> None:
        pass

    def save(self, state: Dict[str, torch.Tensor], path: str) -> None:
        raise NotImplementedError

    def load(self, path: str, targets: Dict[str, torch.Tensor]) -> None:
        raise NotImplementedError

    def commit(self, tag: str) -> bool:
        return True

    def wait(self) -> None:
        pass


class SyncCheckpointEngine(CheckpointEngine):
    """Copies each leaf to the host and writes it before ``save`` returns
    (JAX's ``OrbaxCheckpointEngine``, the reference's
    ``TorchCheckpointEngine``)."""

    def save(self, state, path):
        write_leaves({k: v.detach().to("cpu") for k, v in state.items()}, path)

    def load(self, path, targets):
        read_leaves(path, targets)


class AsyncCheckpointEngine(CheckpointEngine):
    """Background checkpointing (JAX's ``AsyncCheckpointEngine``, the
    reference's ``NebulaCheckpointEngine``): ``save`` returns once the
    device-to-host copy is enqueued; a thread waits for it and writes the
    files.  ``commit`` / ``wait`` block until the write is durable, then run
    the commit callback.  One save is in flight at a time."""

    def __init__(self):
        self._pending: Optional[str] = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._on_commit: Optional[Callable[[], None]] = None
        self._pinned: Dict[str, torch.Tensor] = {}  # host buffers, kept across saves
        self._stream = None
        self.write_done_at: Optional[float] = None  # time.perf_counter() of the last write's end
        _ASYNC_ENGINES.add(self)

    def _host_buffer(self, name: str, t: torch.Tensor) -> torch.Tensor:
        buf = self._pinned.get(name)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
            self._pinned[name] = buf
        return buf

    def save(self, state, path):
        import time

        self.wait()
        host = {k: self._host_buffer(k, v) for k, v in state.items()}
        event = None
        on_cuda = any(v.is_cuda for v in state.values())
        if on_cuda:
            dev = next(v.device for v in state.values() if v.is_cuda)
            if self._stream is None:
                self._stream = torch.cuda.Stream(device=dev)
            cur = torch.cuda.current_stream(dev)
            self._stream.wait_stream(cur)  # the state as the step left it
            with torch.cuda.stream(self._stream):
                for k, v in state.items():
                    host[k].copy_(v.detach(), non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._stream)
            # the next step's in-place updates wait for the copy on the device
            cur.wait_event(event)
        else:
            for k, v in state.items():
                host[k].copy_(v.detach())

        def write():
            try:
                if event is not None:
                    event.synchronize()
                write_leaves(host, path)
            except BaseException as e:  # noqa: BLE001 -- re-raised by wait()
                self._error = e
            self.write_done_at = time.perf_counter()

        self._error = None
        self._pending = path
        self._thread = threading.Thread(target=write, name="dst-ckpt-writer", daemon=True)
        self._thread.start()

    def load(self, path, targets):
        self.wait()
        read_leaves(path, targets)

    def set_commit_callback(self, fn: Callable[[], None]) -> None:
        self._on_commit = fn

    def wait(self) -> None:
        """Block until the in-flight write is done, then publish it through
        the commit callback; a write error re-raises here and nothing is
        published."""
        if self._pending is None:
            return
        self._thread.join()
        path, self._pending, self._thread = self._pending, None, None
        cb, self._on_commit = self._on_commit, None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        log_dist(f"async checkpoint written: {path}")
        if cb is not None:
            cb()

    def commit(self, tag: str) -> bool:
        self.wait()
        return True

    @property
    def pending(self) -> Optional[str]:
        return self._pending


def get_checkpoint_engine(engine) -> CheckpointEngine:
    """The engine's checkpoint engine, made once: async under
    ``checkpoint.async_save`` (``nebula.enabled`` sets it, as in JAX)."""
    existing = getattr(engine, "_ckpt_engine", None)
    if existing is not None:
        return existing
    ce = (AsyncCheckpointEngine() if engine.config.checkpoint.async_save
          else SyncCheckpointEngine())
    engine._ckpt_engine = ce
    return ce
