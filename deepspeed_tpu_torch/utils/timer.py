"""Wall-clock and throughput timers — counterpart of ``deepspeed_tpu/utils/
timer.py`` (the reference's ``deepspeed/utils/timer.py``:
``SynchronizedWallClockTimer`` :44, ``ThroughputTimer`` :199).

JAX fences a timer on ``jax.block_until_ready``; here ``_block`` waits for
the current CUDA stream of the given tensor's device (every kernel of the
step runs on it), and does nothing for a CPU tensor, whose work is done
when the call returns.  A timer fences only when its caller passes a
``sync_obj``: the engine asks for one under ``wall_clock_breakdown``, at
the flops profiler's step and, for the throughput timer, at
``steps_per_print`` boundaries (every step without ``async_metrics``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from .logging import log_dist

FORWARD_MICRO_TIMER = "fwd_microstep"
FORWARD_GLOBAL_TIMER = "fwd"
BACKWARD_MICRO_TIMER = "bwd_microstep"
BACKWARD_GLOBAL_TIMER = "bwd"
STEP_MICRO_TIMER = "step_microstep"
STEP_GLOBAL_TIMER = "step"
TRAIN_BATCH_TIMER = "train_batch"

# every device fence a timer issues counts here (JAX's diagnostic: the
# async-metrics tests assert the loop stays fence-free between boundaries)
TIMER_SYNCS = {"count": 0}


def _block(obj) -> None:
    """Wait for the work that produced ``obj``: the current stream of its
    CUDA device; nothing for a CPU tensor or a non-tensor."""
    TIMER_SYNCS["count"] += 1
    if torch.is_tensor(obj) and obj.is_cuda:
        torch.cuda.current_stream(obj.device).synchronize()


class _Timer:
    def __init__(self, name: str):
        self.name = name
        self.started = False
        self._start = 0.0
        self._elapsed = 0.0  # seconds
        self._last = 0.0
        self._count = 0

    def start(self, sync_obj=None):
        if self.started:
            return
        if sync_obj is not None:
            _block(sync_obj)
        self._start = time.perf_counter()
        self.started = True

    def stop(self, sync_obj=None, record: bool = True):
        if not self.started:
            return
        if sync_obj is not None:
            _block(sync_obj)
        if record:
            duration = time.perf_counter() - self._start
            self._elapsed += duration
            self._last = duration
            self._count += 1
        self.started = False

    def last(self) -> float:
        """Most recent recorded duration in seconds (0 since last reset)."""
        return self._last

    def reset(self):
        self.started = False
        self._elapsed = 0.0
        self._last = 0.0
        self._count = 0

    def elapsed(self, reset: bool = True) -> float:
        """Elapsed milliseconds since last reset."""
        value = self._elapsed * 1000.0
        if reset:
            self.reset()
        return value

    def mean(self) -> float:
        return (self._elapsed / self._count * 1000.0) if self._count else 0.0


class SynchronizedWallClockTimer:
    """Named timer registry; ``log()`` prints one line with selected timers."""

    def __init__(self):
        self.timers: Dict[str, _Timer] = {}

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name)
        return self.timers[name]

    def has(self, name: str) -> bool:
        return name in self.timers

    def log(self, names: List[str], normalizer: float = 1.0, reset: bool = True, ranks=None):
        parts = []
        for name in names:
            if name in self.timers:
                elapsed = self.timers[name].elapsed(reset=reset) / normalizer
                parts.append(f"{name}: {elapsed:.2f}")
        if parts:
            log_dist("time (ms) | " + " | ".join(parts), ranks=ranks)

    def get_mean(self, names: List[str]) -> Dict[str, float]:
        return {n: self.timers[n].mean() for n in names if n in self.timers}


@dataclass
class ThroughputTimer:
    """Samples/s reporting (reference ``utils/timer.py:199``);
    ``batch_size`` is the global train batch size of a step."""

    batch_size: int = 1
    start_step: int = 2
    steps_per_output: int = 50
    monitor_memory: bool = False
    logging_fn = None
    global_steps: int = 0
    total_elapsed: float = 0.0
    step_elapsed: float = 0.0
    _start: float = 0.0
    started: bool = False
    flops_per_sample: Optional[float] = None
    history: List[float] = field(default_factory=list)

    def start(self):
        self.started = True
        self._start = time.perf_counter()

    def stop(self, global_step: bool = True, report_speed: bool = True, sync_obj=None):
        if not self.started:
            return
        self.started = False
        if sync_obj is not None:
            _block(sync_obj)
        duration = time.perf_counter() - self._start
        self.step_elapsed += duration
        if global_step:
            self.global_steps += 1
            if self.global_steps >= self.start_step:
                self.total_elapsed += self.step_elapsed
                self.history.append(self.step_elapsed)
            if report_speed and self.global_steps % self.steps_per_output == 0:
                # the window's mean: with async metrics only the boundary
                # stop fences, so its own reading holds the whole window
                window = self.history[-self.steps_per_output:]
                avg_ms = (sum(window) / len(window) * 1000.0 if window
                          else self.step_elapsed * 1000.0)
                log_dist(f"step={self.global_steps}, samples/sec="
                         f"{self.avg_samples_per_sec():.2f}, step time (window avg)="
                         f"{avg_ms:.1f} ms")
            self.step_elapsed = 0.0

    def avg_samples_per_sec(self) -> float:
        steps = max(self.global_steps - self.start_step + 1, 0)
        if steps <= 0 or self.total_elapsed == 0:
            return 0.0
        return self.batch_size / (self.total_elapsed / steps)
