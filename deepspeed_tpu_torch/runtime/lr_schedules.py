"""LR schedules: LRRangeTest, OneCycle, WarmupLR, WarmupDecayLR,
WarmupCosineLR — counterpart of ``deepspeed_tpu/runtime/lr_schedules.py``.

Each schedule is a plain function of the step.  The step may be a Python
number or a tensor (the engine passes its device step counter, so computing
the rate needs no host sync); the result is a fp32 tensor on the step's
device.  ``LRScheduler`` keeps the reference's object API.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

import torch

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"

VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR, WARMUP_COSINE_LR]


def _step(step) -> torch.Tensor:
    if torch.is_tensor(step):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def lr_range_test(lr_range_test_min_lr: float = 1e-3, lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0, lr_range_test_staircase: bool = False,
                  **_) -> Callable:
    def fn(step):
        interval = _step(step) / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = torch.floor(interval)
        return lr_range_test_min_lr * (1.0 + interval * lr_range_test_step_rate)

    return fn


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 1e-3,
              warmup_num_steps: int = 1000, warmup_type: str = "log", **_) -> Callable:
    def fn(step):
        frac = torch.clamp(_step(step) / max(warmup_num_steps, 1), 0.0, 1.0)
        # log(1 + frac (e - 1)) ramp, the reference's log warmup
        gamma = torch.log1p(frac * (math.e - 1.0)) if warmup_type == "log" else frac
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * gamma

    return fn


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 1e-3, warmup_num_steps: int = 1000,
                    warmup_type: str = "log", **_) -> Callable:
    wu = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)

    def fn(step):
        st = _step(step)
        decay = torch.clamp((total_num_steps - st) / max(total_num_steps - warmup_num_steps, 1),
                            0.0, 1.0)
        return torch.where(st < warmup_num_steps, wu(st), warmup_max_lr * decay)

    return fn


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000, cos_min_ratio: float = 1e-4,
                     lr: float = 1e-3, **_) -> Callable:
    def fn(step):
        st = _step(step)
        wu_frac = torch.clamp(st / max(warmup_num_steps, 1), 0.0, 1.0)
        warm = (warmup_min_ratio + (1 - warmup_min_ratio) * wu_frac) * lr
        progress = torch.clamp((st - warmup_num_steps) / max(total_num_steps - warmup_num_steps, 1),
                               0.0, 1.0)
        cos = cos_min_ratio + (1 - cos_min_ratio) * 0.5 * (1 + torch.cos(math.pi * progress))
        return torch.where(st < warmup_num_steps, warm, cos * lr)

    return fn


def one_cycle(cycle_min_lr: float = 1e-4, cycle_max_lr: float = 1e-3,
              cycle_first_step_size: int = 2000, cycle_second_step_size: Optional[int] = None,
              decay_step_size: int = 0, decay_lr_rate: float = 0.0, **_) -> Callable:
    second = cycle_second_step_size if cycle_second_step_size is not None else cycle_first_step_size
    cycle_len = cycle_first_step_size + second

    def fn(step):
        st = _step(step)
        up = torch.clamp(st / cycle_first_step_size, 0.0, 1.0)
        down = torch.clamp((st - cycle_first_step_size) / max(second, 1), 0.0, 1.0)
        in_cycle = torch.where(st < cycle_first_step_size,
                               cycle_min_lr + (cycle_max_lr - cycle_min_lr) * up,
                               cycle_max_lr - (cycle_max_lr - cycle_min_lr) * down)
        if decay_step_size > 0:
            decay = 1.0 / (1.0 + decay_lr_rate * torch.clamp(st - cycle_len, min=0.0)
                           / decay_step_size)
        else:
            decay = torch.ones_like(st)
        return torch.where(st < cycle_len, in_cycle, cycle_min_lr * decay)

    return fn


_FACTORIES = {
    LR_RANGE_TEST: lr_range_test,
    ONE_CYCLE: one_cycle,
    WARMUP_LR: warmup_lr,
    WARMUP_DECAY_LR: warmup_decay_lr,
    WARMUP_COSINE_LR: warmup_cosine_lr,
}


def get_lr_schedule_fn(type_name: Optional[str], params: Dict[str, Any]) -> Callable:
    """A step -> lr function from a config ``scheduler`` block; no type
    gives the constant ``params['lr']`` (default 1e-3)."""
    if type_name is None:
        base = float(params.get("lr", 1e-3)) if params else 1e-3
        return lambda step: torch.full((), base, dtype=torch.float32,
                                       device=step.device if torch.is_tensor(step) else None)
    if type_name not in _FACTORIES:
        raise ValueError(f"unknown scheduler {type_name}; valid: {VALID_LR_SCHEDULES}")
    return _FACTORIES[type_name](**params)


class LRScheduler:
    """The reference's ``step()`` / ``get_last_lr()`` API over a schedule
    function (a host step count)."""

    def __init__(self, schedule_fn: Callable, last_step: int = 0):
        self.schedule_fn = schedule_fn
        self.last_step = last_step

    def step(self, increment: int = 1) -> None:
        self.last_step += increment

    def get_last_lr(self) -> List[float]:
        return [float(self.schedule_fn(self.last_step))]

    def state_dict(self) -> Dict[str, Any]:
        return {"last_step": self.last_step}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.last_step = int(sd["last_step"])
