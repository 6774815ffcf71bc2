"""Device grid — counterpart of the serving subset of
``deepspeed_tpu/parallel/topology.py`` (``MeshSpec``, ``infer_spec``,
``initialize_mesh``, ``Grid``).

JAX expresses every parallel dimension as a named axis of one device mesh.
The port's serving engine reads three of them: ``data`` (alias ``batch``,
serving replicas), ``seq`` (seq shards of the KV pool) and ``model``
(tensor parallelism).  This module builds a host-only grid: the axis sizes
and the device list, no process group.

What it takes today: ``seq = S`` over ONE device repeated ``S`` times
(``initialize_mesh(devices=["cuda:0"] * 2, seq=2)``), the counterpart of
the JAX tests' virtual CPU devices.  The serving engine then runs the ``S``
seq shards of its pool in one process on that device.  Distinct devices,
``model > 1``, ``batch > 1`` and the training axes raise
``NotImplementedError``: they come with the distributed layers (ROADMAP
queue 1 item 7).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import torch

DATA_AXIS = "data"  # serving calls it ``batch``: one coordinate per replica
FSDP_AXIS = "fsdp"
SUB_AXIS = "sub"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
STAGE_AXIS = "stage"

_ITEM7 = "(ROADMAP queue 1 item 7, the distributed layers)"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape; every axis exists, at size 1 when unused."""

    data: int = 1
    fsdp: int = 1
    sub: int = 1
    model: int = 1
    seq: int = 1
    expert: int = 1
    stage: int = 1

    @property
    def sizes(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, FSDP_AXIS: self.fsdp, SUB_AXIS: self.sub,
                MODEL_AXIS: self.model, SEQ_AXIS: self.seq, EXPERT_AXIS: self.expert,
                STAGE_AXIS: self.stage}

    @property
    def world_size(self) -> int:
        return math.prod(self.sizes.values())


def infer_spec(world_size: int, **fixed: int) -> MeshSpec:
    """Fill the leftover world size into the ``data`` axis (JAX
    ``infer_spec``): ``infer_spec(2, seq=2)`` -> data 1, seq 2."""
    spec = MeshSpec(**fixed)
    fixed_prod = math.prod(spec.sizes.values())
    if world_size % fixed_prod:
        raise ValueError(
            f"world_size {world_size} not divisible by fixed axes product {fixed_prod}")
    if "data" in fixed:
        if spec.world_size != world_size:
            raise ValueError(
                f"mesh spec {spec.sizes} covers {spec.world_size} devices, "
                f"expected {world_size}")
        return spec
    return dataclasses.replace(spec, data=world_size // fixed_prod)


@dataclasses.dataclass
class Grid:
    """Axis sizes and the device of each grid position (row-major over the
    axes, seq fastest): what the serving engine reads."""

    spec: MeshSpec
    devices: List[torch.device]


def normalize_device(device) -> torch.device:
    """``cuda`` with no index is the current CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def initialize_mesh(spec: Optional[MeshSpec] = None, devices: Optional[Sequence] = None,
                    **axes: int) -> Grid:
    """``initialize_mesh(devices=[dev] * S, seq=S)``.  ``batch=`` is the
    serving alias of ``data=``; ``devices`` defaults to every visible CUDA
    device, as JAX's defaults to ``jax.devices()``."""
    if "batch" in axes:
        if "data" in axes:
            raise ValueError("pass either batch= or data=, not both "
                             "(batch is the serving alias of the data axis)")
        axes["data"] = axes.pop("batch")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices= (e.g. ['cpu'] * S)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [normalize_device(d) for d in devices]
    if spec is None:
        spec = infer_spec(len(devices), **axes)
    if spec.world_size != len(devices):
        raise ValueError(
            f"MeshSpec covers {spec.world_size} devices but {len(devices)} are given")
    others = {a: n for a, n in spec.sizes.items() if a != SEQ_AXIS and n > 1}
    if others:
        raise NotImplementedError(
            f"grid axes {others} are not ported yet {_ITEM7}; the port's grid takes "
            "seq only")
    if len(set(devices)) > 1:
        raise NotImplementedError(
            f"seq shards on distinct devices {sorted(map(str, set(devices)))} are not "
            f"ported yet {_ITEM7}; give one device repeated seq times")
    return Grid(spec=spec, devices=devices)
