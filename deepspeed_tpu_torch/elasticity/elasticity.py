"""Elastic training: batch-size math compatible with many world sizes —
the port's own copy of ``deepspeed_tpu/elasticity/elasticity.py``.

The reference's elasticity subsystem (``elasticity/elasticity.py``:
``compute_elastic_config:233``, v0.1 ``_get_compatible_gpus_v01:83``, v0.2
``_get_compatible_gpus_v02:126``; config ``elasticity/config.py``): pick one
global train batch size divisible into ``micro_batch x gas x world`` for as
many GPU counts as possible, so a preempted job can restart at a different
scale with identical optimization behavior.  v0.1 counts GPUs; v0.2 counts
nodes of ``num_gpus_per_node`` GPUs and lets only ``gpus /
model_parallel_size`` count toward data parallelism.

The math is the JAX package's, line for line (pure host code), so a config
gives both packages the same batch, micro-batch and valid world sizes;
``initialize`` adopts them (``deepspeed_tpu_torch.initialize``), and
``elastic_agent.ElasticAgent`` relaunches workers at a valid world.
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional

import numpy as np

from ..utils.logging import log_dist, logger

# Thirty-eight smallest highly composite numbers — enough to cover batch
# sizes up to 720K (reference elasticity.py:21).
HCN_LIST = [
    1, 2, 4, 6, 12, 24, 36, 48, 60, 120, 180, 240, 360, 720, 840, 1260, 1680,
    2520, 5040, 7560, 10080, 15120, 20160, 25200, 27720, 45360, 50400, 55440,
    83160, 110880, 166320, 221760, 277200, 332640, 498960, 554400, 665280,
    720720,
]

LATEST_ELASTICITY_VERSION = 0.2
ELASTICITY_CONFIG_ENV = "DEEPSPEED_ELASTICITY_CONFIG"


class ElasticityError(Exception):
    """Generic elasticity failure."""


class ElasticityConfigError(ElasticityError):
    """Malformed/missing elasticity config."""


class ElasticityIncompatibleWorldSize(ElasticityError):
    """Current world size is not in the valid set for the elastic config."""


class ElasticityConfig:
    """Validated elasticity block (reference elasticity/config.py).

    {"enabled": true, "max_train_batch_size": 2000,
     "micro_batch_sizes": [2,4,6], "min_gpus": 1, "max_gpus": 10000,
     "min_time": 20, "version": 0.2, "prefer_larger_batch": true,
     "ignore_non_elastic_batch_info": false, "num_gpus_per_node": 1,
     "model_parallel_size": 1}
    """

    def __init__(self, param_dict: Dict):
        self.enabled = param_dict.get("enabled", False)
        if "max_train_batch_size" in param_dict:
            self.max_acceptable_batch_size = int(param_dict["max_train_batch_size"])
        else:
            raise ElasticityConfigError("'max_train_batch_size' is missing from elasticity config")
        if "micro_batch_sizes" in param_dict:
            self.micro_batches = [int(m) for m in param_dict["micro_batch_sizes"]]
        else:
            raise ElasticityConfigError("'micro_batch_sizes' is missing from elasticity config")
        if not self.micro_batches:
            raise ElasticityConfigError("micro_batch_sizes must be non-empty")
        if any(m <= 0 for m in self.micro_batches):
            raise ElasticityConfigError(f"micro_batch_sizes must be positive: {self.micro_batches}")
        self.min_gpus = int(param_dict.get("min_gpus", 1))
        self.max_gpus = int(param_dict.get("max_gpus", -1))
        if self.min_gpus < 1 or self.max_gpus == 0 or (self.max_gpus > 0 and self.max_gpus < self.min_gpus):
            raise ElasticityConfigError(
                f"invalid gpu range min={self.min_gpus} max={self.max_gpus}"
            )
        self.model_parallel_size = int(param_dict.get("model_parallel_size", 1))
        self.num_gpus_per_node = int(param_dict.get("num_gpus_per_node", 1))
        self.min_time = int(param_dict.get("min_time", 0))
        self.version = float(param_dict.get("version", 0.2))
        self.prefer_larger_batch_size = param_dict.get("prefer_larger_batch", True)
        self.ignore_non_elastic_batch_info = param_dict.get(
            "ignore_non_elastic_batch_info", False
        )

    def repr_dict(self) -> Dict:
        return {
            "max_train_batch_size": self.max_acceptable_batch_size,
            "micro_batch_sizes": self.micro_batches,
            "version": self.version,
        }


def get_candidate_batch_sizes(base_list: List[int], max_acceptable_batch_size: int) -> List[int]:
    """Scale each base by the largest HCN keeping the product under the cap
    (reference elasticity.py:28)."""
    candidates = set()
    for base in base_list:
        if base >= max_acceptable_batch_size:
            candidates.add(base)
        else:
            value = max_acceptable_batch_size // base
            index = int(np.argmax(np.asarray(HCN_LIST) > value))
            candidates.add(HCN_LIST[index - 1] * base)
    out = sorted(candidates)
    log_dist(f"elasticity candidate batch sizes: {out}")
    return out


def get_valid_gpus(batch_size: int, micro_batches: List[int], min_valid_gpus: int,
                   max_valid_gpus: int) -> List[int]:
    """All world sizes w with batch_size % (micro * w) == 0 for some micro
    (reference elasticity.py:42)."""
    valid = set()
    for micro_batch in micro_batches:
        if batch_size % micro_batch:
            continue
        max_gpus = batch_size // micro_batch
        if min_valid_gpus <= max_gpus <= max_valid_gpus:
            valid.add(max_gpus)
        for i in range(1, max_gpus // 2 + 1):
            if i > max_valid_gpus:
                break
            if i < min_valid_gpus:
                continue
            if max_gpus % i == 0:
                valid.add(i)
    return sorted(valid)


def get_best_candidates(candidate_batch_sizes: List[int], micro_batches: List[int],
                        min_gpus: int, max_gpus: int, prefer_larger: bool):
    """Pick the candidate with the most compatible world sizes
    (reference elasticity.py:64)."""
    max_valid_gpus = 0
    valid_gpus: Optional[List[int]] = None
    final_batch_size = int(min(micro_batches))
    for batch_size in candidate_batch_sizes:
        current = get_valid_gpus(batch_size, micro_batches, min_gpus, max_gpus)
        better_count = len(current) > max_valid_gpus
        tie_break = len(current) == max_valid_gpus and (
            (prefer_larger and batch_size > final_batch_size)
            or (not prefer_larger and batch_size < final_batch_size)
        )
        if better_count or tie_break:
            max_valid_gpus = len(current)
            valid_gpus = current
            final_batch_size = batch_size
    return final_batch_size, valid_gpus


def _get_compatible_gpus_v01(micro_batches, max_acceptable_batch_size,
                             min_gpus=None, max_gpus=None, prefer_larger=True):
    """v0.1 heuristic (reference elasticity.py:83): bases = micro batches +
    their LCM, each scaled by an HCN; count compatible world sizes."""
    min_gpus = min_gpus or 1
    max_gpus = max_gpus or max_acceptable_batch_size // min(micro_batches)
    if not all(mb <= max_acceptable_batch_size for mb in micro_batches):
        raise ValueError(
            "all micro batches must be <= max_acceptable_batch_size "
            f"{max_acceptable_batch_size}"
        )
    lcm = int(np.lcm.reduce(micro_batches))
    base_list = list(micro_batches) + [lcm]
    candidates = get_candidate_batch_sizes(base_list, max_acceptable_batch_size)
    return get_best_candidates(candidates, micro_batches, min_gpus, max_gpus, prefer_larger)


def _get_compatible_gpus_v02(micro_batches, max_acceptable_batch_size, current_num_gpus,
                             min_gpus=None, max_gpus=None, prefer_larger=True,
                             num_gpus_per_node=1, model_parallel_size=1):
    """v0.2 (reference elasticity.py:126): node-granular + model-parallel
    aware.  Returns (batch, valid_dp_world_sizes, micro_batch)."""
    if num_gpus_per_node % model_parallel_size != 0:
        raise ElasticityError(
            f"num_gpus_per_node {num_gpus_per_node} must be divisible by "
            f"model_parallel_size {model_parallel_size}"
        )

    def get_microbatch(final_batch_size):
        candidate = None
        for micro_batch in micro_batches:
            if final_batch_size // current_num_gpus % micro_batch == 0:
                if candidate is None or (prefer_larger and candidate < micro_batch):
                    candidate = micro_batch
        return candidate

    dp_size_per_node = num_gpus_per_node // model_parallel_size
    final_batch_size, valid_world_size = _get_compatible_gpus_v01(
        micro_batches,
        int(max_acceptable_batch_size / dp_size_per_node),
        int(min_gpus / num_gpus_per_node),
        int(max_gpus / num_gpus_per_node),  # node-level search
        prefer_larger=prefer_larger,
    )
    final_batch_size = int(final_batch_size) * dp_size_per_node
    valid_dp_world_size = [i * dp_size_per_node for i in valid_world_size]
    if current_num_gpus // model_parallel_size in valid_dp_world_size:
        return final_batch_size, valid_dp_world_size, get_microbatch(final_batch_size)

    # current world size not in the valid set: build the largest batch this
    # exact dp size supports
    current_dp_size = (current_num_gpus / num_gpus_per_node) * dp_size_per_node
    candidate_batch_sizes = []
    for micro_batch in micro_batches:
        min_batch_size = micro_batch * current_dp_size
        factor = math.floor(max_acceptable_batch_size / float(min_batch_size))
        candidate_batch_sizes.append(factor * min_batch_size)
    candidate_batch_size = max(candidate_batch_sizes) if prefer_larger else min(candidate_batch_sizes)
    return int(candidate_batch_size), [int(current_dp_size)], get_microbatch(int(candidate_batch_size))


def elasticity_enabled(ds_config: Dict) -> bool:
    return bool(ds_config.get("elasticity", {}).get("enabled", False))


def ensure_immutable_elastic_config(runtime_elastic_config_dict: Dict) -> None:
    """Cross-check the scheduler's view of the elastic config against the
    runtime's (reference elasticity.py:208)."""
    if ELASTICITY_CONFIG_ENV in os.environ:
        scheduler = ElasticityConfig(json.loads(os.environ[ELASTICITY_CONFIG_ENV]))
        runtime = ElasticityConfig(runtime_elastic_config_dict)
        for attr in ("max_acceptable_batch_size", "micro_batches", "version"):
            if getattr(runtime, attr) != getattr(scheduler, attr):
                raise ElasticityConfigError(
                    f"elastic config '{attr}' seen by the scheduler "
                    f"({getattr(scheduler, attr)}) does not match the runtime "
                    f"({getattr(runtime, attr)})"
                )
    else:
        logger.warning(
            f"{ELASTICITY_CONFIG_ENV} not set; cannot guarantee the resource "
            "scheduler will scale this job with compatible GPU counts"
        )


def compute_elastic_config(ds_config: Dict, target_deepspeed_version: str = "0.0",
                           world_size: int = 0, return_microbatch: bool = False):
    """Core elasticity API (reference elasticity.py:233).

    Returns (final_batch_size, valid_gpus[, micro_batch]); with
    ``world_size`` given, raises ``ElasticityIncompatibleWorldSize`` if that
    world size cannot consume the chosen batch size.
    """
    if not isinstance(ds_config, dict):
        raise ValueError(f"expected a config dict, got {type(ds_config)}")
    if "elasticity" not in ds_config:
        raise ElasticityConfigError("'elasticity' is missing from the config")
    elastic_config_dict = ds_config["elasticity"]
    if not elastic_config_dict.get("enabled", False):
        raise ElasticityConfigError("elasticity is disabled ('enabled': true to use)")
    elastic_config = ElasticityConfig(elastic_config_dict)

    if elastic_config.model_parallel_size > 1 and elastic_config.version != 0.2:
        raise ElasticityConfigError(
            f"elasticity v{elastic_config.version} does not support model "
            f"parallelism (size {elastic_config.model_parallel_size}); use v0.2"
        )
    if elastic_config.version > LATEST_ELASTICITY_VERSION:
        raise ElasticityConfigError(
            f"elasticity version {elastic_config.version} > latest supported "
            f"{LATEST_ELASTICITY_VERSION}"
        )

    micro_batch = None
    if elastic_config.version == 0.1:
        final_batch_size, valid_gpus = _get_compatible_gpus_v01(
            micro_batches=elastic_config.micro_batches,
            max_acceptable_batch_size=elastic_config.max_acceptable_batch_size,
            min_gpus=elastic_config.min_gpus,
            max_gpus=elastic_config.max_gpus,
            prefer_larger=elastic_config.prefer_larger_batch_size,
        )
        final_batch_size = int(final_batch_size)
    elif elastic_config.version == 0.2:
        current = world_size
        if current == 0:
            env = os.environ.get("WORLD_SIZE", "")
            if env.isnumeric():
                current = int(env)
            else:
                raise ElasticityConfigError(
                    "elasticity v0.2 needs world_size (argument or WORLD_SIZE env)"
                )
        final_batch_size, valid_gpus, micro_batch = _get_compatible_gpus_v02(
            micro_batches=elastic_config.micro_batches,
            max_acceptable_batch_size=elastic_config.max_acceptable_batch_size,
            current_num_gpus=current,
            min_gpus=elastic_config.min_gpus,
            max_gpus=(elastic_config.max_gpus if elastic_config.max_gpus > 0
                      else elastic_config.max_acceptable_batch_size // min(elastic_config.micro_batches)),
            prefer_larger=elastic_config.prefer_larger_batch_size,
            num_gpus_per_node=elastic_config.num_gpus_per_node,
            model_parallel_size=elastic_config.model_parallel_size,
        )
        final_batch_size = int(final_batch_size)
    else:
        raise ElasticityConfigError(f"unknown elasticity version {elastic_config.version}")

    # v0.1: a world size outside the valid set is an error; v0.2 already
    # fell back to pinning the current dp size (reference semantics)
    if (elastic_config.version == 0.1 and world_size > 0 and valid_gpus
            and world_size not in valid_gpus):
        raise ElasticityIncompatibleWorldSize(
            f"world size {world_size} is not valid for this elastic config; "
            f"valid world sizes: {valid_gpus}"
        )
    if world_size > 0 and micro_batch is None:
        # v0.1 with explicit world size: derive the largest fitting micro batch
        for mb in sorted(elastic_config.micro_batches, reverse=True):
            if final_batch_size // world_size % mb == 0:
                micro_batch = mb
                break

    if return_microbatch:
        return final_batch_size, valid_gpus, micro_batch
    return final_batch_size, valid_gpus
