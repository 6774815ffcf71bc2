"""ZeRO across the ranks of a process grid — counterpart of
``deepspeed_tpu/runtime/zero.py`` (:92-309).

JAX expresses ZeRO as sharding plans over its mesh and lets XLA insert the
collectives.  The plan is the same here (``plan_sharding`` answers as
JAX's, leaf by leaf: ``P`` specs of the compute parameters and of the
masters), and ``ZeroShard`` carries it out with explicit collectives
(``comm/comm.py``) over contiguous slices of flat buffers, as the
reference's ``stage_1_and_2.py`` partitions its flat fp32 buffer:

- the leaves fall into groups (``Group``): at stages 1 and 2 one group of
  every leaf; at stage 3 one group for each layer of the stacked ``[L,
  ...]`` leaves the plan shards, one (``rest``) for the other sharded
  leaves, and one (``persist``) for the leaves the plan keeps replicated
  (under ``param_persistence_threshold``).  Each group is padded to a
  multiple of its shard count, and this rank owns one slice of it;
- the fp32 masters, their gradients and the optimizer's moments are the
  rank's slices of every group, back to back in one flat buffer each, so
  one K8 launch updates them (an elementwise rule; Lamb and Muon read whole
  leaves and are refused);
- a replicated group (stages 1 / 2, and ``persist``) keeps a compute-type
  copy of the whole group, all-gathered from the slices after each update.
  Its gradient reduce-scatters onto the slice: once at the accumulation
  boundary from a full fp32 accumulator at stage 1, in the backward of
  every micro-batch at stage 2 (the gradient is partitioned);
- a sharded group (stage 3) is all-gathered just before its use and freed
  after it (``_GatherFn``): the ``rest`` group at the start of the loss,
  each layer's group when the model's forward reaches the layer
  (``LayerSource``, ``models.transformer.fetch_layer``).  Its backward
  reduce-scatters the gradient onto the slice.  A layer's weights that the
  backward needs are not kept: the saved-tensor hooks (``saved_hooks``)
  record where they sat and gather the layer again when the backward
  reaches it.  Under remat the recomputed forward gathers again;
- a ``data`` axis (or, under MiCS, ``data`` x ``fsdp``), and a ``seq`` axis
  above 1, replicates the slices: their gradient is all-reduced over it
  after the reduce-scatter.

hpZ (``zero_hpz_partition_size``) keeps a secondary partition of each
stage-3 group over ``sub`` (refreshed from the masters by an all-gather
over ``fsdp`` after each update): the per-use gathers stay within ``sub``,
the gradient reduce-scatters over ``sub`` and then ``fsdp``.  MiCS
(``mics_shard_size``) shards everything within ``sub`` and replicates
across ``data`` x ``fsdp``.  qwZ / qgZ / LoCo (``runtime/zeropp.py``)
replace the stage-3 gather and reduce-scatter by their int8 forms.

The masters' slice index of a rank follows its gather order
(``Group.levels``), so ``full = gather(levels[-1], ..., gather(levels[0],
slice))``; a checkpoint holds the logical (unsharded) tensors, gathered
from the slices (``gather_flat``, the engine's ``master_tree`` /
``logical_opt_state``), and a load takes each rank's slices of them
(``scatter_flat``, the engine's ``load_logical_state``), so a save at one
world size loads at another.

A model drawn from its seed in a world (``initialize`` without
``params``, ``Init.materialize``) is a ``DeferredParams``: the shapes
first, then the leaves one at a time, each rank copying its own slices of
each leaf and dropping the rest (``ZeroShard.load_leaf``).  A rank holds
one whole leaf on the host at a time, never the tree.
"""
from __future__ import annotations

import inspect
import math
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..comm import comm
from ..parallel.sharding import P
from ..parallel.topology import DATA_AXIS, FSDP_AXIS, SEQ_AXIS, SUB_AXIS, MeshSpec

PathRules = List[Tuple[str, Any]]  # (regex over 'a/b/c' param path, base spec)


# ---------------------------------------------------------------------------
# the plan (JAX :45-250): host-side, no collective
# ---------------------------------------------------------------------------
def path_str(path) -> str:
    return "/".join(str(p) for p in path)


def match_rules(path: str, shape: Tuple[int, ...], rules: Optional[PathRules]) -> P:
    """First-match regex rules -> the base (tensor-parallel) spec."""
    if rules:
        for pattern, spec in rules:
            if re.search(pattern, path):
                spec_t = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
                return P(*spec_t[:len(shape)])
    return P(*([None] * len(shape)))


def _add_axis(spec: P, shape: Tuple[int, ...], axis_name, axis_size: int) -> P:
    """Shard the largest free dimension of ``shape`` that ``axis_size``
    divides on ``axis_name``; the spec unchanged when none does."""
    entries = list(tuple(spec) + (None,) * (len(shape) - len(tuple(spec))))
    best, best_dim = -1, -1
    for i, d in enumerate(shape):
        if entries[i] is None and d % axis_size == 0 and d > best:
            best, best_dim = d, i
    if best_dim >= 0:
        entries[best_dim] = axis_name
    return P(*entries)


def _tree_map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _leaf_shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _size(shape) -> int:
    return int(math.prod(shape)) if shape else 1


def _on_fsdp(spec) -> bool:
    """Whether ``spec`` shards a dimension over ``fsdp`` / ``sub`` (a
    ``model`` entry is the tensor-parallel shard, not ZeRO's)."""
    def axes(e):
        return e if isinstance(e, tuple) else (e,)

    return any(a in (FSDP_AXIS, SUB_AXIS) for e in tuple(spec) if e is not None
               for a in axes(e))


@dataclass
class ShardingPlan:
    """Per-leaf decisions (JAX :92): ``param_specs`` for the compute
    parameters, ``master_specs`` for the fp32 masters and the optimizer's
    state, trees of ``P`` shaped like the parameters."""

    param_specs: Any
    master_specs: Any
    zero: Any
    shape_tree: Any = None

    @property
    def wants_cpu_offload(self) -> bool:
        return "cpu" in (self.zero.offload_optimizer, self.zero.offload_param)


def plan_sharding(params_shapes: Any, zero, spec: MeshSpec,
                  tp_rules: Optional[PathRules] = None) -> ShardingPlan:
    """JAX's ``plan_sharding`` (:182-250) over a tree of tensors or shapes:
    stage 0 replicated; stages 1 / 2 the masters sharded on ``fsdp`` (on
    ``(fsdp, sub)`` when ``sub`` > 1, on ``sub`` under MiCS); stage 3 the
    compute parameters too (on ``sub`` under hpZ / MiCS), except those under
    ``param_persistence_threshold``."""
    fsdp, sub = spec.fsdp, spec.sub
    fsdp_total = fsdp * sub
    hpz = zero.zero_hpz_partition_size > 1
    mics = zero.mics_shard_size > 1
    if hpz and mics:
        raise ValueError("zero_hpz_partition_size and mics_shard_size are exclusive")
    if (hpz or mics) and sub == 1:
        raise ValueError(
            "zero_hpz_partition_size/mics_shard_size require a mesh with a "
            "'sub' axis of that size — pass initialize_mesh(..., sub=G) or "
            "omit mesh= and let initialize() factor the fsdp axis")
    full_extent = (FSDP_AXIS, SUB_AXIS) if sub > 1 else FSDP_AXIS

    def param_spec(path, leaf):
        shape = _leaf_shape(leaf)
        base = match_rules(path_str(path), shape, tp_rules)
        if zero.stage >= 3 and fsdp_total > 1 and _size(shape) >= zero.param_persistence_threshold:
            if hpz or mics:
                return _add_axis(base, shape, SUB_AXIS, sub)
            return _add_axis(base, shape, full_extent, fsdp_total)
        return base

    def master_spec(path, leaf):
        shape = _leaf_shape(leaf)
        base = match_rules(path_str(path), shape, tp_rules)
        if zero.stage >= 1 and fsdp_total > 1:
            if mics:
                return _add_axis(base, shape, SUB_AXIS, sub)
            return _add_axis(base, shape, full_extent, fsdp_total)
        return base

    return ShardingPlan(param_specs=_tree_map_with_path(param_spec, params_shapes),
                        master_specs=_tree_map_with_path(master_spec, params_shapes),
                        zero=zero, shape_tree=params_shapes)


# ---------------------------------------------------------------------------
# the flat slices
# ---------------------------------------------------------------------------
@dataclass
class Piece:
    """One leaf's part of a group: the whole leaf (``layer`` None) or its
    ``[layer]`` slice of a stacked ``[L, ...]`` leaf."""

    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    layer: Optional[int] = None

    @property
    def numel(self) -> int:
        return _size(self.shape)


@dataclass
class Group:
    """Leaves partitioned together: ``pieces`` back to back, padded to
    ``padded`` (a multiple of the shard count); this rank's slice is
    ``shard`` elements at ``off`` in the flat slice buffers.  ``kind``:
    ``replicated`` (a compute copy of the whole group lives on every rank)
    or ``gathered`` (stage 3: gathered at each use).  ``levels``: the axes
    the slices gather over, inner first."""

    name: str
    pieces: List[Piece]
    kind: str
    levels: List[Tuple[str, ...]]
    numel: int = 0
    padded: int = 0
    shard: int = 0
    off: int = 0
    layer: Optional[int] = None

    def piece_offsets(self):
        o = 0
        for pc in self.pieces:
            yield pc, o
            o += pc.numel


class _GatherFn(torch.autograd.Function):
    """A stage-3 group: this rank's fp32 master slice in, the whole group
    in the compute type out (all-gathered; the qwZ form ships int8).  The
    backward reduce-scatters the gradient onto the slice (qgZ: int8
    all-to-all) and the slices' replicas all-reduce it at the boundary."""

    @staticmethod
    def forward(ctx, mslice, zs, g):
        ctx.zs, ctx.g = zs, g
        return zs.gather_group(g)

    @staticmethod
    def backward(ctx, grad_full):
        return ctx.zs.reduce_group_grad(ctx.g, grad_full), None, None


class _ReplicatedFn(torch.autograd.Function):
    """A replicated group: the slice in, the group's persistent compute copy
    out; the backward reduce-scatters (stage >= 2) or accumulates the full
    fp32 gradient for the boundary's reduce-scatter (stage 1)."""

    @staticmethod
    def forward(ctx, mslice, zs, g):
        ctx.zs, ctx.g = zs, g
        return zs.compute[g.name].view_as(zs.compute[g.name])

    @staticmethod
    def backward(ctx, grad_full):
        return ctx.zs.replicated_grad(ctx.g, grad_full), None, None


class LayerHandle:
    """Layer ``l`` of a stage-3 engine: ``fetch()`` gathers its group and
    returns the layer's parameter dict, with the ``[l]`` slices of the
    persistent ``[L, ...]`` leaves (the model calls it where the layer
    starts; ``models.transformer.fetch_layer``)."""

    def __init__(self, zs: "ZeroShard", layer: int, persistent):
        self.zs, self.layer, self.persistent = zs, layer, persistent

    def fetch(self) -> Dict[str, Any]:
        return self.zs.fetch_layer(self.layer, self.persistent)


class LayerSource:
    """``params["layers"]`` of a stage-3 engine: one ``LayerHandle`` a layer
    (``models.transformer._unstack`` reads ``layer_handles``)."""

    def __init__(self, zs: "ZeroShard", num_layers: int, persistent):
        self.handles = [LayerHandle(zs, l, persistent) for l in range(num_layers)]

    def layer_handles(self) -> List[LayerHandle]:
        return list(self.handles)


class _LayerParams(dict):
    """A gathered layer's parameter dict; it holds the gathered buffer's
    tensor object while the layer runs, so its views' ``_base`` is that
    object and carries the saved-tensor hooks' mark."""

    __slots__ = ("full",)


@dataclass
class _Saved:
    """A gathered weight the backward needs, recorded instead of kept."""

    group: str
    offset: int
    size: Tuple[int, ...]
    stride: Tuple[int, ...]


def _set(tree: Dict[str, Any], path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _leaf_paths(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, path + (k,))
        else:
            yield path + (k,), v


class ZeroShard:
    """The sharded state of one engine across a ``ProcessGrid`` (stages
    1-3): the layout, the flat fp32 slices (``masters`` with its leaf
    ``mleaves`` a group, ``grad``), the compute copies of the replicated
    groups, and the collectives of the step.  See the module docstring."""

    def __init__(self, params, config, grid, device: torch.device, compute_dtype,
                 num_layers: Optional[int], quant=None, param_specs=None):
        zcfg = config.zero_optimization
        self.stage = zcfg.stage
        self.grid, self.device, self.dtype = grid, device, compute_dtype
        deferred = params if isinstance(params, DeferredParams) else None
        if deferred is not None:
            params = deferred.shapes
        shapes = _tree_map_with_path(lambda p, x: tuple(x.shape), params)
        self.plan = plan_sharding(shapes, zcfg, grid.spec)
        # which leaves stage 3 gathers: the plan's, or under a model axis
        # the plan of the whole tree with the TP rules (``param_specs``,
        # JAX's composition), whose fsdp entries say it
        specs = param_specs if param_specs is not None else self.plan.param_specs
        self.hpz = zcfg.zero_hpz_partition_size > 1
        self.mics = zcfg.mics_shard_size > 1
        self.quant = quant  # runtime/zeropp.py's ZeroPP (qwZ / qgZ / LoCo) or None
        sub = grid.spec.sub
        if self.mics:
            shard_levels, self.replica_axes = [(SUB_AXIS,)], (DATA_AXIS, FSDP_AXIS)
        elif sub > 1:
            shard_levels, self.replica_axes = [(FSDP_AXIS, SUB_AXIS)], (DATA_AXIS,)
        else:
            shard_levels, self.replica_axes = [(FSDP_AXIS,)], (DATA_AXIS,)
        if grid.spec.seq > 1:  # the seq ranks hold the same slices, their own tokens' sums
            self.replica_axes += (SEQ_AXIS,)
        self.shard_axes = tuple(a for lv in shard_levels for a in lv)
        gathered_levels = [(FSDP_AXIS,), (SUB_AXIS,)] if self.hpz else shard_levels
        layer_leaves = ("layers",) if num_layers else None
        groups: List[Group] = []
        if self.stage < 3:
            groups.append(Group("all", [Piece(p, _leaf_shape(x)) for p, x in _leaf_paths(params)],
                                "replicated", shard_levels))
        else:
            persist, rest = [], []
            per_layer: List[List[Piece]] = [[] for _ in range(num_layers or 0)]
            # the plan's sharded leaves; over a shard group of one (JAX's
            # plan replicates everything there) the leaves the threshold
            # lets through, so a world of one gathers as a larger world does
            alone = math.prod(grid.axis_size(lv) for lv in gathered_levels) == 1
            for p, x in _leaf_paths(params):
                shape = _leaf_shape(x)
                big = _size(shape) >= zcfg.param_persistence_threshold
                if not (_on_fsdp(_get(specs, p)) or (alone and big)):
                    persist.append(Piece(p, shape))
                elif layer_leaves and p[0] == layer_leaves[0]:
                    for l in range(num_layers):
                        per_layer[l].append(Piece(p, shape[1:], l))
                else:
                    rest.append(Piece(p, shape))
            if persist:
                groups.append(Group("persist", persist, "replicated", shard_levels))
            if rest:
                groups.append(Group("rest", rest, "gathered", gathered_levels))
            for l, pcs in enumerate(per_layer):
                if pcs:
                    groups.append(Group(f"layer{l}", pcs, "gathered", gathered_levels, layer=l))
        off = 0
        for g in groups:
            w = math.prod(grid.axis_size(lv) for lv in g.levels)
            g.numel = sum(pc.numel for pc in g.pieces)
            g.padded = -(-g.numel // w) * w
            g.shard, g.off = g.padded // w, off
            off += g.shard
        self.groups = groups
        self.by_name = {g.name: g for g in groups}
        self.num_layers = num_layers if any(g.layer is not None for g in groups) else None
        self.masters = torch.zeros(off, dtype=torch.float32, device=device)
        self.grad = torch.zeros(off, dtype=torch.float32, device=device)
        self.mleaves: Dict[str, torch.Tensor] = {}
        for g in groups:
            leaf = self.masters[g.off:g.off + g.shard]
            leaf.requires_grad_(True)
            leaf.grad = self.grad[g.off:g.off + g.shard]
            self.mleaves[g.name] = leaf
        self.compute: Dict[str, torch.Tensor] = {}  # replicated groups' compute copies
        self.secondary: Dict[str, torch.Tensor] = {}  # hpZ: gathered groups over sub
        self.accum: Dict[str, torch.Tensor] = {}  # stage 1: full fp32 gradients
        for g in groups:
            if g.kind == "replicated":
                self.compute[g.name] = torch.empty(g.padded, dtype=compute_dtype, device=device)
                if self.stage == 1:
                    self.accum[g.name] = torch.zeros(g.padded, dtype=torch.float32,
                                                     device=device)
            elif self.hpz:
                self.secondary[g.name] = torch.empty(g.padded // grid.axis_size(SUB_AXIS),
                                                     dtype=compute_dtype, device=device)
        self._gathered_layers: Dict[str, torch.Tensor] = {}  # the saved hooks' cache
        # each leaf's pieces: (group, the piece's offset in the group, piece)
        self._pieces_of: Dict[Tuple[str, ...], List[Tuple[Group, int, Piece]]] = {}
        for g in groups:
            start = 0
            for pc in g.pieces:
                self._pieces_of.setdefault(pc.path, []).append((g, start, pc))
                start += pc.numel
        if deferred is not None:
            deferred.fill(self)
        else:
            self.load_params(params)

    # ------------------------------------------------------------------
    # layout helpers
    # ------------------------------------------------------------------
    def slice_index(self, g: Group) -> int:
        """This rank's slice of ``g`` in the gather order of its levels."""
        idx, stride = 0, 1
        for lv in g.levels:
            idx += self.grid.axis_rank(lv) * stride
            stride *= self.grid.axis_size(lv)
        return idx

    def _group_flat(self, g: Group, tree) -> torch.Tensor:
        """The group's logical elements from a tree of whole leaves, padded,
        fp32, on the CPU or the tree's device."""
        parts = []
        for pc in g.pieces:
            x = torch.as_tensor(_get(tree, pc.path))
            x = x[pc.layer] if pc.layer is not None else x
            parts.append(x.detach().reshape(-1).float())
        flat = torch.cat(parts) if parts else torch.zeros(0)
        return torch.nn.functional.pad(flat, (0, g.padded - g.numel))

    @torch.no_grad()
    def load_leaf(self, path, x) -> None:
        """Copy this rank's parts of the whole leaf ``x`` at ``path`` into
        its slices (fp32, on the device); nothing else of it is kept."""
        x = torch.as_tensor(x).detach()
        for g, start, pc in self._pieces_of.get(tuple(path), ()):
            lo = self.slice_index(g) * g.shard  # this rank's range in the padded group
            a, b = max(lo, start), min(lo + g.shard, start + pc.numel)
            if a < b:
                src = x[pc.layer] if pc.layer is not None else x
                self.masters[g.off + a - lo:g.off + b - lo].copy_(
                    src.reshape(-1)[a - start:b - start])

    @torch.no_grad()
    def load_params(self, tree) -> None:
        """Take this rank's slices of a tree of whole fp32 leaves (each rank
        keeps only its own on the device; a leaf on the ``meta`` device was
        loaded as it was drawn), then refresh the compute copies."""
        for p, x in _leaf_paths(tree):
            if not (torch.is_tensor(x) and x.is_meta):
                self.load_leaf(p, x)
        self.refresh_compute()

    # ------------------------------------------------------------------
    # collectives of a group
    # ------------------------------------------------------------------
    def _gather_levels(self, x: torch.Tensor, levels) -> torch.Tensor:
        for lv in levels:
            x = comm.all_gather(x, lv, mesh=self.grid)
        return x

    def _scatter_levels(self, x: torch.Tensor, levels) -> torch.Tensor:
        for lv in reversed(levels):
            x = comm.reduce_scatter(x, lv, mesh=self.grid)
        return x

    @torch.no_grad()
    def refresh_compute(self) -> None:
        """After an update: every replicated group's compute copy, and under
        hpZ every gathered group's secondary partition, from the slices."""
        for g in self.groups:
            src = self.mleaves[g.name].detach().to(self.dtype)
            if g.kind == "replicated":
                self._gather_into(src, g.levels, self.compute[g.name])
            elif self.hpz:
                self._gather_into(src, g.levels[:1], self.secondary[g.name])

    def _gather_into(self, src, levels, out) -> None:
        if len(levels) == 1:
            comm.all_gather(src, levels[0], out=out, mesh=self.grid)
        else:
            out.copy_(self._gather_levels(src, levels))

    def gather_group(self, g: Group) -> torch.Tensor:
        """A stage-3 group whole, in the compute type: from the slice over
        every level, or under hpZ from the secondary partition over
        ``sub``; qwZ ships int8 (``zeropp.ZeroPP.gather``)."""
        with torch.no_grad():
            if self.hpz:
                src, levels = self.secondary[g.name], g.levels[1:]
            else:
                src, levels = self.mleaves[g.name].detach(), g.levels
            if self.quant is not None and self.quant.weights:
                return self.quant.gather(src, levels, self.dtype)
            return self._gather_levels(src.to(self.dtype), levels)

    def reduce_group_grad(self, g: Group, grad_full: torch.Tensor) -> torch.Tensor:
        """The whole group's gradient of this micro-batch -> this rank's
        slice of its sum over the shard group (fp32; qgZ in int8)."""
        with torch.no_grad():
            gf = grad_full.float()
            if self.quant is not None and self.quant.grads:
                return self.quant.reduce(g, gf, g.levels)
            return self._scatter_levels(gf, g.levels)

    def replicated_grad(self, g: Group, grad_full: torch.Tensor) -> Optional[torch.Tensor]:
        with torch.no_grad():
            if self.stage == 1:
                self.accum[g.name].add_(grad_full)
                return None
            return self._scatter_levels(grad_full.float(), g.levels)

    # ------------------------------------------------------------------
    # the loss's parameter tree
    # ------------------------------------------------------------------
    def _views(self, g: Group, full: torch.Tensor, tree) -> None:
        for pc, o in g.piece_offsets():
            if pc.layer is None:
                _set(tree, pc.path, full[o:o + pc.numel].view(pc.shape))

    def compute_tree(self) -> Dict[str, Any]:
        """The compute-type parameters the loss runs on, linked to the
        master slices through autograd: the replicated groups' copies, the
        ``rest`` group gathered now, the layers as a ``LayerSource``."""
        tree: Dict[str, Any] = {}
        for g in self.groups:
            if g.layer is not None:
                continue
            fn = _ReplicatedFn if g.kind == "replicated" else _GatherFn
            self._views(g, fn.apply(self.mleaves[g.name], self, g), tree)
        if self.num_layers:  # the persistent [L, ...] leaves ride the handles
            tree["layers"] = LayerSource(self, self.num_layers, tree.get("layers", {}))
        return tree

    def fetch_layer(self, l: int, persistent) -> Dict[str, Any]:
        """Layer ``l``'s parameters: its group gathered now (its buffer
        marked for the saved-tensor hooks), and the persistent leaves'
        ``[l]`` slices."""
        g = self.by_name[f"layer{l}"]
        full = _GatherFn.apply(self.mleaves[g.name], self, g)
        root = full if full._base is None else full._base  # what the views' _base is
        root._dst_gathered = g.name
        out = _LayerParams()
        out.full = root  # the hooks read the mark through the views' base
        for pc, o in g.piece_offsets():
            _set(out, pc.path[1:], full[o:o + pc.numel].view(pc.shape))
        for p, x in _leaf_paths(persistent):
            _set(out, p, x[l])
        return out

    # saved-tensor hooks: a layer's gathered weights are not kept for the
    # backward; it gathers the layer again when it needs them
    def _pack(self, t: torch.Tensor):
        base = t._base
        name = getattr(base, "_dst_gathered", None) if base is not None else None
        if name is None:
            return t
        return _Saved(name, t.storage_offset(), tuple(t.shape), tuple(t.stride()))

    def _unpack(self, s):
        if not isinstance(s, _Saved):
            return s
        full = self._gathered_layers.get(s.group)
        if full is None:
            self._gathered_layers.clear()  # one layer's weights at a time
            full = self.gather_group(self.by_name[s.group])
            self._gathered_layers[s.group] = full
        return full.as_strided(s.size, s.stride, s.offset)

    def saved_hooks(self):
        """The saved-tensor hooks of a stage-3 loss (a no-op context below
        stage 3)."""
        from contextlib import nullcontext

        if self.num_layers is None:
            return nullcontext()
        return torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack)

    def end_backward(self) -> None:
        """Free the backward's last re-gathered layer."""
        self._gathered_layers.clear()

    # ------------------------------------------------------------------
    # the boundary
    # ------------------------------------------------------------------
    @torch.no_grad()
    def reduce_boundary(self) -> None:
        """Stage 1's reduce-scatter of the accumulated gradients, then the
        replicas' all-reduce of the slices (over ``data``, or ``data`` x
        ``fsdp`` under MiCS; only when that group is larger than one)."""
        for name, acc in self.accum.items():
            g = self.by_name[name]
            self.grad[g.off:g.off + g.shard].add_(self._scatter_levels(acc, g.levels))
            acc.zero_()
        if self.grid.axis_size(self.replica_axes) > 1:
            comm.all_reduce(self.grad, self.replica_axes, mesh=self.grid)

    def path_runs(self, paths, index=None) -> List[Tuple[Any, int, int]]:
        """``(leaf in paths, start, end)`` runs over this rank's slices (the
        padding counts as outside); with ``index`` (path -> category) the
        leaf's category in place of the membership."""
        runs = []
        for g in self.groups:
            lo = self.slice_index(g) * g.shard
            for pc, o in g.piece_offsets():
                a, b = max(lo, o), min(lo + g.shard, o + pc.numel)
                if a < b:
                    tag = index[pc.path] if index is not None else pc.path in paths
                    runs.append((tag, g.off + a - lo, g.off + b - lo))
        return runs

    def grad_norm(self) -> torch.Tensor:
        """The global gradient norm: the slices' squares summed once over
        the shard group (the replicas hold the same slices)."""
        sq = self.grad.float().square().sum().reshape(1)
        comm.all_reduce(sq, self.shard_axes, mesh=self.grid)
        return sq[0].sqrt()

    # ------------------------------------------------------------------
    # checkpoints: logical tensors
    # ------------------------------------------------------------------
    @torch.no_grad()
    def gather_flat(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Every group's whole (unpadded) fp32 buffer from the slices of
        ``buf`` (the masters or a moment laid out like them)."""
        out = {}
        for g in self.groups:
            x = buf[g.off:g.off + g.shard].detach().float().contiguous()
            out[g.name] = self._gather_levels(x, g.levels)[:g.numel]
        return out

    def unflatten(self, flats: Dict[str, torch.Tensor], like) -> Dict[str, Any]:
        """A tree of whole leaves shaped like ``like`` from group buffers."""
        tree: Dict[str, Any] = {}
        for p, x in _leaf_paths(like):
            _set(tree, p, torch.empty(_leaf_shape(x), dtype=torch.float32,
                                      device=flats[self.groups[0].name].device))
        for g in self.groups:
            for pc, o in g.piece_offsets():
                leaf = _get(tree, pc.path)
                part = flats[g.name][o:o + pc.numel].view(pc.shape)
                if pc.layer is None:
                    leaf.copy_(part)
                else:
                    leaf[pc.layer].copy_(part)
        return tree

    @torch.no_grad()
    def scatter_flat(self, tree, buf: torch.Tensor) -> None:
        """This rank's slices of a tree of whole leaves into ``buf``."""
        for g in self.groups:
            i = self.slice_index(g)
            flat = self._group_flat(g, tree).to(buf.device)
            buf[g.off:g.off + g.shard].copy_(flat[i * g.shard:(i + 1) * g.shard])

    def resident_param_bytes(self) -> int:
        """Bytes of parameters this rank keeps between steps: its fp32
        slices, the replicated groups' compute copies and hpZ's secondary
        partitions."""
        n = self.masters.numel() * 4
        n += sum(t.numel() * t.element_size() for t in self.compute.values())
        n += sum(t.numel() * t.element_size() for t in self.secondary.values())
        return n


class DeferredParams:
    """A model's parameters before they are drawn: ``shapes``, the tree on
    the ``meta`` device (the plan and the layout read it), and the seeded
    draw.  ``fill(zs)`` draws the leaves one at a time and keeps this
    rank's slices of each (``ZeroShard.load_leaf``); ``draw(device)``
    gives the whole tree, for an engine that keeps every leaf (stage 0,
    the 1-bit optimizers, one process).  ``init_fn(seed=, device=,
    keep=)``: ``models.transformer.init_params``'s contract."""

    def __init__(self, init_fn: Callable, seed: int = 0):
        self.init_fn, self.seed = init_fn, seed
        self.shapes = init_fn(seed=seed, device="meta")

    @staticmethod
    def supports(init_fn: Callable) -> bool:
        """Whether ``init_fn`` hands its leaves out as it draws them."""
        return "keep" in inspect.signature(init_fn).parameters

    def draw(self, device):
        return self.init_fn(seed=self.seed, device=device)

    def fill(self, zs: "ZeroShard") -> None:
        def keep(path, w):
            zs.load_leaf(path, w)
            return torch.empty(w.shape, dtype=w.dtype, device="meta")

        # the constant leaves (norms, biases) come back whole; load_params
        # takes them and refreshes the compute copies
        zs.load_params(self.init_fn(seed=self.seed, device="cpu", keep=keep))


def _params_and_shapes(init_fn: Callable, seed: int):
    """``DeferredParams`` when ``init_fn`` takes ``keep``, else the tree
    drawn on the host; with the tree of shapes."""
    if DeferredParams.supports(init_fn):
        params = DeferredParams(init_fn, seed)
        tree = params.shapes
    else:
        params = tree = init_fn(seed=seed, device="cpu")
    return params, _tree_map_with_path(lambda p, x: tuple(x.shape), tree)


class Init:
    """The reference-shaped ``zero.Init`` context (JAX :277):
    ``materialize(init_fn, seed)`` records the plan and returns the
    parameters for ``initialize(params=...)``: a ``DeferredParams`` when
    ``init_fn`` takes ``keep`` (each rank then draws the leaves one at a
    time and keeps only its slices), else the tree drawn on the host::

        with Init(config, grid) as zi:
            params = zi.materialize(model.init_params, seed)
    """

    def __init__(self, config, grid, tp_rules=None):
        from ..config.config import parse_config

        cfg = parse_config(config) if not hasattr(config, "zero_optimization") else config
        self.grid, self.zero, self.tp_rules = grid, cfg.zero_optimization, tp_rules
        self.plan: Optional[ShardingPlan] = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def materialize(self, init_fn: Callable, seed: int = 0):
        params, shapes = _params_and_shapes(init_fn, seed)
        self.plan = plan_sharding(shapes, self.zero, self.grid.spec, self.tp_rules)
        return params


def init_sharded_params(init_fn: Callable, seed: int, plan: ShardingPlan, grid):
    """JAX's ``init_sharded_params`` (:260): the parameters for
    ``ZeroShard`` (as ``Init.materialize`` returns them), checked against
    ``plan``'s shapes."""
    params, shapes = _params_and_shapes(init_fn, seed)
    if plan.shape_tree is not None and shapes != plan.shape_tree:
        raise ValueError("init_fn's tree does not match the plan's shapes")
    return params


def predicted_comm_counts(engine, steps: int = 1) -> Dict[str, int]:
    """The collectives ``steps`` calls of ``engine.train_batch`` issue, by
    the comms logger's ``"<op>@<axes>"`` keys, from the engine's layout
    and config alone (what a run's logger must read, engine construction
    excluded).  Per micro-batch: the token count's all-reduce (when the
    ranks are weighted by their tokens); stage 3's gathers of each gathered
    group in the forward (a layer under selective / offload remat twice,
    once a checkpointed half) and in the backward (the recomputed halves,
    or the saved-tensor hooks' one gather a layer without remat) and one
    reduce-scatter a forward gather; stage 2's reduce-scatter of each
    replicated group.  Per step: the loss's all-reduce, stage 0's gradient
    all-reduce, stage 1's reduce-scatters, the replicas' all-reduce, the
    norm's, an fp16 overflow flag's, the replicated groups' (and hpZ's
    secondary) refresh, and the 1-bit step's exchanges.  qwZ gathers and
    qgZ all-to-alls move a payload and its scales: two ops each."""
    from ..comm.comm import axis_key

    cfg = engine.config
    z = cfg.zero_optimization
    gas = cfg.gradient_accumulation_steps
    out: Dict[str, int] = {}

    def add(op, axes, n):
        if n:
            key = f"{op}@{axis_key(axes)}"
            out[key] = out.get(key, 0) + n

    dp = engine.token_axes
    weighted = (getattr(engine.model, "valid_tokens", None) is not None
                and engine.loss_fn == getattr(engine.model, "loss_fn", None)
                and engine._onebit is None
                and not (z.zero_quantized_weights or z.zero_quantized_gradients))
    add("all_reduce", dp, steps * gas if weighted else 0)
    add("all_reduce", dp, steps)  # the loss
    ob = engine._onebit
    if ob is not None:
        warm = max(0, min(steps, ob.freeze_step - engine.global_steps))
        add("all_reduce", ob.axes, warm)
        add("all_to_all", ob.axes, 2 * (steps - warm))
        add("all_gather", ob.axes, 2 * (steps - warm))
        return out
    zs = engine._zero
    if zs is None:
        add("all_reduce", dp, steps)
        return out
    if cfg.fp16.enabled:
        add("all_reduce", dp, steps)
    add("all_reduce", zs.shard_axes, steps)  # the norm
    if engine.grid.axis_size(zs.replica_axes) > 1:
        add("all_reduce", zs.replica_axes, steps)
    remat = getattr(getattr(engine.model, "cfg", None), "remat", "none")
    regions = 2 if remat in ("selective", "offload") else 1
    qw = zs.quant is not None and zs.quant.weights
    qg = zs.quant is not None and zs.quant.grads
    for g in zs.groups:
        if g.kind == "replicated":
            add("reduce_scatter", g.levels[0], steps * (1 if zs.stage == 1 else gas))
            add("all_gather", g.levels[0], steps)  # the refresh
            continue
        if zs.hpz:
            add("all_gather", g.levels[0], steps)  # the secondary partition's refresh
        fwd = regions if g.layer is not None else 1
        bwd = (regions if remat in ("full", "selective", "offload") else 1) \
            if g.layer is not None else 0
        gather_axes = g.levels[-1] if zs.hpz else g.levels[0]
        add("all_gather", gather_axes, steps * gas * (fwd + bwd) * (2 if qw else 1))
        for lv in g.levels:
            add("all_to_all" if qg else "reduce_scatter", lv,
                steps * gas * fwd * (2 if qg else 1))
    return out
