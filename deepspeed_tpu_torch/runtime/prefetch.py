"""Latency-hiding input pipeline — counterpart of ``deepspeed_tpu/runtime/
prefetch.py``.

- ``DevicePrefetcher``: a background worker pulls batches from any iterator
  and stages each with ``place_fn`` (the engine's: fold the accumulation
  steps, copy into pinned host buffers, start the host-to-device copy on a
  side CUDA stream and record an event), at most ``depth`` batches ahead.
  The copy of batch k+1 overlaps step k; the consumer joins the compute
  stream to the copy with the event (``StagedBatch.wait``).
- ``MetricsBuffer``: step metrics stay device tensors until a flush at a
  ``steps_per_print`` boundary or an explicit read, so the loop issues no
  per-step host sync.
- ``host_scalar``: the one place a device scalar becomes a host float.

``state_fn`` (the loader's ``state_dict``) is snapshotted under the
prefetcher's lock just before each draw from the source, one snapshot per
batch drawn and not yet handed to the consumer, so ``resume_state`` gives
the position of the oldest undelivered batch: a checkpoint taken with
batches parked in the queue resumes without skipping or repeating one.
"""
from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

# every deferred-metrics host read lands here (tests/test_torch_training.py
# counts them over a train_on_loader run to show the loop stays asynchronous)
HOST_READS = {"count": 0}


def host_scalar(x) -> float:
    """THE device -> host sync point for deferred step metrics."""
    HOST_READS["count"] += 1
    return float(x.item()) if torch.is_tensor(x) else float(x)


class StagedBatch:
    """A batch on the device whose copy may still be running on a side
    stream; ``wait()`` joins the current stream to it."""

    def __init__(self, batch: Dict[str, torch.Tensor], event=None):
        self.batch = batch
        self.event = event

    def wait(self) -> Dict[str, torch.Tensor]:
        if self.event is not None:
            cur = torch.cuda.current_stream()
            cur.wait_event(self.event)
            for t in self.batch.values():
                t.record_stream(cur)  # the side stream allocated it
            self.event = None
        return self.batch


def stage(batch: Dict[str, Any], device: torch.device, stream=None) -> StagedBatch:
    """Host arrays / tensors -> a ``StagedBatch`` on ``device``.  On CUDA
    with a side ``stream``: pinned host copies, then asynchronous copies on
    that stream and an event after them."""
    host = {k: torch.as_tensor(v) for k, v in batch.items()}
    if device.type != "cuda" or stream is None:
        return StagedBatch({k: t.to(device) for k, t in host.items()})
    with torch.cuda.stream(stream):
        dev = {k: t.pin_memory().to(device, non_blocking=True) for k, t in host.items()}
        event = torch.cuda.Event()
        event.record(stream)
    return StagedBatch(dev, event)


_END, _ERR, _BATCH = "end", "err", "batch"


class DevicePrefetcher:
    """Bounded background prefetcher over a batch iterator.  ``place_fn``
    runs on the worker thread; worker exceptions re-raise in the consumer
    where they occurred in the stream.  ``state_fn`` (optional) gives the
    source's position for ``resume_state``."""

    def __init__(self, iterator: Iterable, place_fn: Callable[[Any], Any], depth: int = 2,
                 state_fn: Optional[Callable[[], Any]] = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._it = iter(iterator)
        self._place = place_fn
        self._state_fn = state_fn
        self._queue: "queue.Queue[Tuple[str, Any]]" = queue.Queue(maxsize=depth)
        # positions of the batches drawn and not yet delivered (the one being
        # drawn or staged included)
        self._pending_states: "deque[Any]" = deque()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._closed = False
        self._thread = threading.Thread(target=self._run, name="dst-input-prefetch",
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                # snapshot before the draw and append it at once: a
                # resume_state() during the draw rewinds to this batch (it
                # replays, never skips, it).  The lock covers the
                # bookkeeping, not the draw, so the consumer never waits
                # on a collate.
                with self._lock:
                    self._pending_states.append(
                        self._state_fn() if self._state_fn is not None else None)
                try:
                    batch = next(self._it)
                except StopIteration:
                    with self._lock:
                        self._pending_states.pop()  # nothing was drawn
                    self._offer((_END, None))
                    return
                if not self._offer((_BATCH, self._place(batch))):
                    return  # closed while blocked on a full queue
        except BaseException as e:  # noqa: BLE001 -- re-raised in the consumer
            # the failed batch's snapshot stays pending: resuming replays it
            self._offer((_ERR, e))

    def _offer(self, item) -> bool:
        """put() that stays responsive to close()."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise RuntimeError("prefetcher is closed")
        while True:
            try:
                kind, payload = self._queue.get(timeout=0.05)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    raise StopIteration
        if kind == _END:
            raise StopIteration
        if kind == _ERR:
            raise payload
        with self._lock:
            self._pending_states.popleft()
        return payload

    def qsize(self) -> int:
        """Batches parked in the queue."""
        return self._queue.qsize()

    def resume_state(self) -> Any:
        """The source's position as if no drawn-but-undelivered batch had
        been drawn: the oldest pending snapshot, else the live position;
        None without a ``state_fn``."""
        with self._lock:
            if self._pending_states:
                return self._pending_states[0]
            return self._state_fn() if self._state_fn is not None else None

    def close(self) -> bool:
        """Stop the worker and drop queued batches.  Idempotent; True when
        the worker has exited (a worker stuck in a slow draw could still
        move the source's position: restore it only after True)."""
        if not self._closed:
            self._closed = True
            self._stop.set()
            while True:
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    break
            self._thread.join(timeout=5.0)
        return not self._thread.is_alive()


class MetricsBuffer:
    """Deferred host accounting of step metrics: ``append`` keeps device
    tensors, ``flush`` reads them all at once and returns ``[(global_step,
    host_metrics)]`` in step order."""

    def __init__(self):
        self._items: List[Tuple[int, Any]] = []

    def append(self, global_step: int, metrics, keep_history: bool = True) -> None:
        """``keep_history=False`` keeps only the newest step (nothing reads
        per-step history: no fp16 skip accounting)."""
        if not keep_history:
            self._items.clear()
        self._items.append((global_step, metrics))

    def flush(self) -> List[Tuple[int, Any]]:
        items, self._items = self._items, []
        return [(step, type(m)(*[host_scalar(v) for v in m])) for step, m in items]
