"""Curriculum-learning difficulty scheduler — counterpart of
``deepspeed_tpu/data/curriculum_scheduler.py`` (the reference's
``runtime/data_pipeline/curriculum_scheduler.py:11 CurriculumScheduler``),
with the same config schema and schedule math (``fixed_discrete`` /
``fixed_root`` / ``fixed_linear`` / ``custom``):

    {"curriculum_type": "seqlen", "min_difficulty": 8, "max_difficulty": 1024,
     "schedule_type": "fixed_linear",
     "schedule_config": {"total_curriculum_step": 10000, "difficulty_step": 8}}

With the ``seqlen`` metric each difficulty is the sequence length the
engine truncates the batch to (``truncate_to_seqlen``).  The flash kernels
take any length; ``difficulty_step`` keeps the number of distinct shapes
(and cuBLAS's plans) small, and a multiple of 8 keeps the matmuls on the
tensor cores' granule.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..config.config import ConfigError
from ..utils.logging import warning_once

MIN_DIFFICULTY = "min_difficulty"
MAX_DIFFICULTY = "max_difficulty"
CURRENT_DIFFICULTY = "current_difficulty"
SCHEDULE_TYPE = "schedule_type"
SCHEDULE_CONFIG = "schedule_config"
FIXED_DISCRETE = "fixed_discrete"
FIXED_ROOT = "fixed_root"
FIXED_LINEAR = "fixed_linear"
CUSTOM = "custom"


class CurriculumScheduler:
    """Difficulty as a function of the global step (reference semantics)."""

    def __init__(self, config: Dict[str, Any]):
        for key in (MIN_DIFFICULTY, MAX_DIFFICULTY, SCHEDULE_TYPE):
            if key not in config:
                raise ConfigError(f"curriculum learning requires the config '{key}'")
        self.state: Dict[str, Any] = {
            MIN_DIFFICULTY: config[MIN_DIFFICULTY],
            MAX_DIFFICULTY: config[MAX_DIFFICULTY],
            CURRENT_DIFFICULTY: config[MIN_DIFFICULTY],
            SCHEDULE_TYPE: config[SCHEDULE_TYPE],
        }
        self.custom_get_difficulty: Optional[Callable[[int], int]] = None
        stype = config[SCHEDULE_TYPE]
        sconf = config.get(SCHEDULE_CONFIG, {})
        if stype == FIXED_DISCRETE:
            # {"difficulty": [1, 2, 3], "max_step": [5, 10]}: one max_step
            # fewer, the last difficulty holds forever
            if "difficulty" not in sconf or "max_step" not in sconf:
                raise ConfigError("fixed_discrete schedule requires schedule_config "
                                  "'difficulty' and 'max_step'")
            if len(sconf["difficulty"]) != len(sconf["max_step"]) + 1:
                raise ConfigError("fixed_discrete: len(difficulty) must be len(max_step)+1")
            self.state[SCHEDULE_CONFIG] = sconf
        elif stype in (FIXED_ROOT, FIXED_LINEAR):
            need = ["total_curriculum_step", "difficulty_step"]
            if stype == FIXED_ROOT:
                need.append("root_degree")
            for key in need:
                if key not in sconf:
                    raise ConfigError(f"{stype} schedule requires schedule_config '{key}'")
            if sconf["difficulty_step"] % 8 != 0:
                warning_once("curriculum difficulty_step not a multiple of 8: each new "
                             "difficulty is a new shape for every kernel and matmul — keep "
                             "the step a multiple of 8 and large")
            self.state[SCHEDULE_CONFIG] = sconf
        elif stype == CUSTOM:
            pass  # set_custom_get_difficulty must be called before use
        else:
            raise ConfigError(f"unsupported curriculum schedule type '{stype}'")

    # -- reference API -------------------------------------------------------
    def get_current_difficulty(self) -> int:
        return self.state[CURRENT_DIFFICULTY]

    def set_current_difficulty(self, difficulty: int) -> None:
        self.state[CURRENT_DIFFICULTY] = difficulty

    def set_custom_get_difficulty(self, fn: Callable[[int], int]) -> None:
        self.custom_get_difficulty = fn

    def get_state(self) -> Dict[str, Any]:
        return self.state

    def set_state(self, state: Dict[str, Any]) -> None:
        self.state = state

    def _fixed_discrete(self, global_steps: int) -> int:
        sconf = self.state[SCHEDULE_CONFIG]
        if global_steps > sconf["max_step"][-1]:
            return sconf["difficulty"][-1]
        for i, max_step in enumerate(sconf["max_step"]):
            if global_steps <= max_step:
                return sconf["difficulty"][i]
        return sconf["difficulty"][-1]

    def _fixed_root(self, global_steps: int, root_degree: Optional[int] = None) -> int:
        sconf = self.state[SCHEDULE_CONFIG]
        if root_degree is None:
            root_degree = sconf["root_degree"]
        frac = (float(global_steps) / sconf["total_curriculum_step"]) ** (1.0 / root_degree)
        next_difficulty = math.floor(
            frac * (self.state[MAX_DIFFICULTY] - self.state[MIN_DIFFICULTY])
            + self.state[MIN_DIFFICULTY])
        next_difficulty -= next_difficulty % sconf["difficulty_step"]
        return min(next_difficulty, self.state[MAX_DIFFICULTY])

    def get_difficulty(self, global_steps: int) -> int:
        stype = self.state[SCHEDULE_TYPE]
        if stype == FIXED_DISCRETE:
            return self._fixed_discrete(global_steps)
        if stype == FIXED_LINEAR:
            return self._fixed_root(global_steps, 1)
        if stype == FIXED_ROOT:
            return self._fixed_root(global_steps)
        if stype == CUSTOM:
            if self.custom_get_difficulty is None:
                raise ConfigError(
                    "custom curriculum schedule: call set_custom_get_difficulty first")
            return self.custom_get_difficulty(global_steps)
        raise ConfigError(f"unsupported curriculum schedule type '{stype}'")

    def update_difficulty(self, global_steps: int) -> int:
        if self.state[CURRENT_DIFFICULTY] < self.state[MAX_DIFFICULTY]:
            self.state[CURRENT_DIFFICULTY] = self.get_difficulty(global_steps)
        return self.state[CURRENT_DIFFICULTY]


def _is_token_leaf(x) -> bool:
    """An integer array or tensor (not bool) of rank >= 2."""
    if torch.is_tensor(x):
        return (x.ndim >= 2 and not x.dtype.is_floating_point and not x.dtype.is_complex
                and x.dtype != torch.bool)
    return getattr(x, "ndim", 0) >= 2 and np.issubdtype(x.dtype, np.integer)


def truncate_to_seqlen(batch, seqlen: int):
    """A ``seqlen`` difficulty applied to a token batch (a dict, list or
    tuple tree of tensors or numpy arrays): every integer leaf of rank >= 2
    longer than ``seqlen + 1`` is cut to ``seqlen + 1`` on its last axis (the
    +1 keeps the causal label shift of ``[.., seq + 1]`` inputs).  Float
    leaves (per-sample weights) keep their shape."""
    if isinstance(batch, dict):
        return {k: truncate_to_seqlen(v, seqlen) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(truncate_to_seqlen(v, seqlen) for v in batch)
    if _is_token_leaf(batch) and batch.shape[-1] > seqlen + 1:
        return batch[..., :seqlen + 1]
    return batch
