"""Device grids — counterpart of ``deepspeed_tpu/parallel/topology.py``
(``MeshSpec``, ``infer_spec``, ``initialize_mesh``, ``Grid``).

JAX expresses every parallel dimension as a named axis of one device mesh.
The port has two kinds of grid:

- ``ProcessGrid``, the grid over the processes of a ``torch.distributed``
  world, one rank a device (``initialize_mesh()`` once the world is up,
  ``comm.init_distributed``).  Its axes are ``data``, ``fsdp``, ``sub``
  and ``model``, ranks row-major over them with ``model`` fastest, as
  JAX's mesh orders its devices (topology.py:142: ``stage, data, fsdp,
  sub, expert, seq, model``), so consecutive ranks form a tensor-parallel
  group, as Megatron's do.  It holds one process group for every set of
  those axes and every coordinate of the others, in the backend of its
  device (NCCL for CUDA, gloo for the CPU), so a collective names axes
  (``comm/comm.py``).  ``seq``, ``expert`` and ``stage`` above 1 across
  ranks raise ``NotImplementedError`` (ROADMAP queue 1 item 7: sequence,
  expert and pipeline parallelism);
- ``Grid``, the serving subset: ``seq = S`` over ONE device repeated ``S``
  times (``initialize_mesh(devices=["cuda:0"] * 2, seq=2)``), the
  counterpart of the JAX tests' virtual CPU devices; the serving engine runs
  the ``S`` seq shards of its pool in one process on that device.  Distinct
  devices, ``model > 1`` and ``batch > 1`` raise ``NotImplementedError``
  (item 7).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

DATA_AXIS = "data"  # serving calls it ``batch``: one coordinate per replica
FSDP_AXIS = "fsdp"
SUB_AXIS = "sub"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
STAGE_AXIS = "stage"

_ITEM7 = "(ROADMAP queue 1 item 7, the distributed layers)"
# the axes over which the gradients are averaged (JAX ``BATCH_AXES``)
BATCH_AXES = (DATA_AXIS, FSDP_AXIS, SUB_AXIS)
# the axes a process grid spans, slowest first (``model`` fastest)
GRID_AXES = BATCH_AXES + (EXPERT_AXIS, SEQ_AXIS, MODEL_AXIS)


@dataclasses.dataclass(frozen=True)
class GroupAxis:
    """A grouped set along one axis (JAX's ``axis_index_groups`` entry this
    rank is in): the axis ``name`` (what the comms logger records),
    ``members`` (indices along the axis, in group order), this rank's
    ``index`` in them, and the process group (None outside a world: the
    caller makes the collective itself)."""

    name: str
    members: Tuple[int, ...]
    index: int
    group: object = None

    @property
    def size(self) -> int:
        return len(self.members)


def seq_group_sets(p: int, g: int):
    """The two families of Ulysses' uneven-heads path over an axis of
    ``p`` (JAX ``sequence/layer.py:96-97``), index ``i = h * g + j``:
    ``inner`` the ``p / g`` sets of ``g`` consecutive indices (one kv head
    each), ``cross`` the ``g`` sets of stride ``g``."""
    inner = [tuple(h * g + j for j in range(g)) for h in range(p // g)]
    cross = [tuple(h * g + j for h in range(p // g)) for j in range(g)]
    return inner, cross


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

    @property
    def dp_world_size(self) -> int:
        return self.data * self.fsdp * self.sub


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


Axes = Union[str, Sequence[str]]


def _axes(axis_name: Axes) -> Tuple[str, ...]:
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    bad = [a for a in names if a not in GRID_AXES]
    if bad:
        raise NotImplementedError(f"axis {bad} across ranks is not ported yet {_ITEM7}; a "
                                  f"process grid spans {GRID_AXES}")
    return tuple(a for a in GRID_AXES if a in names)  # grid order


class ProcessGrid:
    """The grid over a ``torch.distributed`` world: this rank's
    coordinates, its device, the process group of every set of the
    ``GRID_AXES`` (``group``) and the grouped sets along ``seq``
    (``subgroup``), made at construction by every rank in one order
    (``new_group`` is collective).  JAX's ``Grid`` answers the same size
    and rank questions from its mesh."""

    def __init__(self, spec: MeshSpec, device: torch.device, backend: str):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("a process grid needs torch.distributed: call "
                               "comm.init_distributed() first")
        others = {a: n for a, n in spec.sizes.items() if a not in GRID_AXES and n > 1}
        if others:
            raise NotImplementedError(f"grid axes {others} across ranks are not ported yet "
                                      f"{_ITEM7}; a process grid spans {GRID_AXES}")
        world = dist.get_world_size()
        if spec.world_size != world:
            raise ValueError(f"MeshSpec {spec.sizes} covers {spec.world_size} ranks but the "
                             f"world has {world}")
        self.spec, self.device, self.backend = spec, torch.device(device), backend
        self.comms_logger = None  # comm.configure's CommsLogger for this grid
        self.rank = dist.get_rank()
        self.sizes = {a: spec.sizes[a] for a in GRID_AXES}
        shape = tuple(self.sizes.values())
        self.coords = dict(zip(GRID_AXES, _unravel(self.rank, shape)))
        self._groups: Dict[Tuple[str, ...], object] = {}
        coords = [dict(zip(GRID_AXES, _unravel(r, shape))) for r in range(world)]
        # every subset of the axes, every coordinate of the rest, in one
        # order on every rank; a rank keeps the groups it is in.  Subsets
        # whose rank sets coincide (axes of size 1) share one group
        made: Dict[Tuple[int, ...], object] = {}

        def group_of(ranks):
            g = made.get(tuple(ranks))
            if g is None:
                g = made[tuple(ranks)] = dist.new_group(list(ranks), backend=backend)
            return g

        for k in range(1, len(GRID_AXES) + 1):
            for sub in itertools.combinations(GRID_AXES, k):
                rest = [a for a in GRID_AXES if a not in sub]
                for fixed in itertools.product(*(range(self.sizes[a]) for a in rest)):
                    at = dict(zip(rest, fixed))
                    ranks = [r for r in range(world)
                             if all(coords[r][a] == v for a, v in at.items())]
                    g = group_of(ranks)
                    if self.rank in ranks:
                        self._groups[sub] = g
        # the grouped sets along seq, for every coordinate of the other axes
        self._subgroups: Dict[Tuple[str, Tuple[int, ...]], object] = {}
        p = self.sizes[SEQ_AXIS]
        others = [a for a in GRID_AXES if a != SEQ_AXIS]
        for g in range(2, p):
            if p % g:
                continue
            for members in itertools.chain(*seq_group_sets(p, g)):
                for fixed in itertools.product(*(range(self.sizes[a]) for a in others)):
                    at = dict(zip(others, fixed))
                    ranks = [r for r in range(world)
                             if coords[r][SEQ_AXIS] in members
                             and all(coords[r][a] == v for a, v in at.items())]
                    ranks.sort(key=lambda r: members.index(coords[r][SEQ_AXIS]))
                    grp = group_of(ranks)
                    if self.rank in ranks:
                        self._subgroups[(SEQ_AXIS, members)] = grp

    @property
    def world_size(self) -> int:
        return self.spec.world_size

    @property
    def dp_world_size(self) -> int:
        return self.spec.dp_world_size

    @property
    def tp_size(self) -> int:
        return self.sizes[MODEL_AXIS]

    @property
    def tp_rank(self) -> int:
        """This rank's index in its tensor-parallel (``model``) group."""
        return self.coords[MODEL_AXIS]

    @property
    def dp_rank(self) -> int:
        """This rank's index over ``data`` x ``fsdp`` x ``sub`` (the
        loader's shard; JAX ``Grid.local_dp_rank``)."""
        return self.axis_rank(BATCH_AXES)

    def group(self, axis_name: Axes):
        return self._groups[_axes(axis_name)]

    def subgroup(self, axis: str, members: Sequence[int]) -> GroupAxis:
        """The grouped set ``members`` (indices along ``axis``, group order)
        this rank is in, made at construction."""
        members = tuple(members)
        me = self.coords[axis]
        if me not in members or (axis, members) not in self._subgroups:
            raise ValueError(f"no grouped set {members} of {axis!r} holds this rank "
                             f"({axis} index {me})")
        return GroupAxis(axis, members, members.index(me), self._subgroups[(axis, members)])

    def axis_size(self, axis_name: Axes) -> int:
        return math.prod(self.sizes[a] for a in _axes(axis_name))

    def axis_rank(self, axis_name: Axes) -> int:
        """This rank's index in the group of ``axis_name`` (row-major over
        the named axes in grid order)."""
        idx = 0
        for a in _axes(axis_name):
            idx = idx * self.sizes[a] + self.coords[a]
        return idx


def _unravel(rank: int, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def initialize_mesh(spec: Optional[MeshSpec] = None, devices: Optional[Sequence] = None,
                    **axes: int):
    """``initialize_mesh(fsdp=2)`` over the processes of a
    ``torch.distributed`` world (a ``ProcessGrid``; each rank on its
    device, ``device=`` or CUDA ``LOCAL_RANK``), or, with ``devices``, the
    serving grid ``initialize_mesh(devices=[dev] * S, seq=S)``.  ``batch=``
    is the serving alias of ``data=``; ``devices`` defaults to every visible
    CUDA device, as JAX's defaults to ``jax.devices()``."""
    if "batch" in axes:
        if "data" in axes:
            raise ValueError("pass either batch= or data=, not both "
                             "(batch is the serving alias of the data axis)")
        axes["data"] = axes.pop("batch")
    device = axes.pop("device", None)
    import torch.distributed as dist

    if devices is None and dist.is_available() and dist.is_initialized():
        if spec is None:
            spec = infer_spec(dist.get_world_size(), **axes)
        if device is None:
            from ..comm.comm import get_local_rank

            device = torch.device("cuda", get_local_rank())
        device = torch.device(device)
        return ProcessGrid(spec, device, "nccl" if device.type == "cuda" else "gloo")
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
