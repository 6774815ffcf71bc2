"""One rank's view of the process grid for the model's forward: the
``seq`` and ``expert`` axes, the axes whose ranks hold different tokens,
and the differentiable collectives the model's parallel layers make: the
tensor-parallel regions over ``model`` (``models/transformer.py``), the
sequence- and expert-parallel layers (``sequence/layer.py``,
``sequence/ring.py``, ``moe/layer.py``).

JAX's layers name mesh axes inside ``shard_map`` regions (or leave the
collectives to GSPMD); the port's name them through a ``ParallelContext``,
which ``initialize`` attaches to a ``CausalLM`` in a process world
(``CausalLM.par``) beside its ``TensorParallel`` (``tp``) and the expert
layout (``ep``, ``parallel/expert_parallel.py``).

Every collective of those layers goes through the context's raw
primitives (``_all_to_all``, ``_all_gather``, ``_reduce_scatter``,
``_all_reduce``, ``_ppermute``), each over an axis name or a
``topology.GroupAxis``; the autograd Functions below give them their
transposes:

- ``all_to_all``: the reverse all-to-all;
- ``ppermute``: the inverse permutation;
- ``all_gather``: this rank's slice (``backward="slice"``: every member's
  consumers of the gathered tensor are the same, so each holds the whole
  cotangent) or a reduce-scatter (``"sum"``: they differ);
- ``copy`` (Megatron's ``f``): the identity, the cotangent all-reduced;
- ``reduce`` (``g``): the sum, the cotangent passed through;
- ``scatter_rows`` / ``gather_rows``: a rank's block of rows and back
  (the expert-parallel region's token split);
- ``mean_over``: the mean over some axes whose cotangent sums over others.

A subclass that replaces the raw primitives runs ranks in one process
(the card's shard checks, ``chip_smoke.py``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from .topology import BATCH_AXES, EXPERT_AXIS, GRID_AXES, MODEL_AXIS, SEQ_AXIS, GroupAxis


def _names(axis) -> Tuple[str, ...]:
    if isinstance(axis, GroupAxis):
        return (axis.name,)
    return (axis,) if isinstance(axis, str) else tuple(axis)


class ParallelContext:
    """The grid's sizes and this rank's coordinates (``grid``, or ``sizes``
    / ``coords`` given), its ``TensorParallel`` (``tp``) and expert layout
    (``ep``), and the collectives over them."""

    def __init__(self, grid=None, tp=None, ep=None, sizes: Optional[Dict[str, int]] = None,
                 coords: Optional[Dict[str, int]] = None):
        self.grid, self.tp, self.ep = grid, tp, ep
        self.sizes = dict(grid.sizes if grid is not None else sizes)
        self.coords = dict(grid.coords if grid is not None else coords)
        for a in GRID_AXES:
            self.sizes.setdefault(a, 1)
            self.coords.setdefault(a, 0)
        self.seq, self.seq_rank = self.sizes[SEQ_AXIS], self.coords[SEQ_AXIS]
        self.expert, self.expert_rank = self.sizes[EXPERT_AXIS], self.coords[EXPERT_AXIS]
        # the axes whose ranks hold different tokens (JAX's BATCH and seq);
        # ranks along expert and model hold the same ones
        self.token_axes = tuple(a for a in BATCH_AXES + (SEQ_AXIS,) if self.sizes[a] > 1)
        self.batch_axes = tuple(a for a in BATCH_AXES if self.sizes[a] > 1)

    # ------------------------------------------------------------------
    # sizes and ranks
    # ------------------------------------------------------------------
    def axis_size(self, axis) -> int:
        if isinstance(axis, GroupAxis):
            return axis.size
        return math.prod(self.sizes[a] for a in _names(axis))

    def axis_rank(self, axis) -> int:
        if isinstance(axis, GroupAxis):
            return axis.index
        idx = 0
        for a in GRID_AXES:
            if a in _names(axis):
                idx = idx * self.sizes[a] + self.coords[a]
        return idx

    def subgroup(self, axis: str, members: Sequence[int]) -> GroupAxis:
        """The grouped set ``members`` along ``axis`` that holds this rank."""
        if self.grid is not None:
            return self.grid.subgroup(axis, members)
        members = tuple(members)
        return GroupAxis(axis, members, members.index(self.coords[axis]), None)

    @property
    def moe_region_axes(self) -> Tuple[str, ...]:
        """The axes over which a routed layer's output is a partial sum: the
        experts' (``ep``) and the expert FFNs' columns (``tp``)."""
        return ((EXPERT_AXIS,) if self.ep is not None else ()) + \
            ((MODEL_AXIS,) if self.tp is not None else ())

    # ------------------------------------------------------------------
    # raw collectives (no gradient); a one-process subclass replaces them
    # ------------------------------------------------------------------
    def _all_to_all(self, x, axis, split_axis, concat_axis):
        from ..comm import comm

        return comm.all_to_all(x, axis, split_axis, concat_axis, mesh=self.grid)

    def _all_gather(self, x, axis, dim):
        from ..comm import comm

        return comm.all_gather(x, axis, axis=dim, mesh=self.grid)

    def _reduce_scatter(self, x, axis, dim):
        from ..comm import comm

        return comm.reduce_scatter(x, axis, scatter_dimension=dim, mesh=self.grid)

    def _all_reduce(self, x, axis, op: str = "sum"):
        from ..comm import comm

        return comm.all_reduce(x.clone(memory_format=torch.contiguous_format), axis, op=op,
                               mesh=self.grid)

    def _ppermute(self, x, axis, perm):
        from ..comm import comm

        return comm.ppermute(x, axis, perm, mesh=self.grid)

    # ------------------------------------------------------------------
    # differentiable collectives
    # ------------------------------------------------------------------
    def all_to_all(self, x, axis, split_axis: int, concat_axis: int):
        return _AllToAll.apply(x, self, axis, split_axis, concat_axis)

    def ppermute(self, x, axis, perm):
        return _PPermute.apply(x, self, axis, tuple(tuple(p) for p in perm))

    def all_gather(self, x, axis, dim: int, backward: str = "sum"):
        return _AllGather.apply(x, self, axis, dim, backward)

    def copy(self, x, axes):
        """``f``: the identity; the cotangent all-reduced over ``axes``."""
        return _Copy.apply(x, self, axes) if axes else x

    def reduce(self, x, axes):
        """``g``: the sum over ``axes``; the cotangent passed through."""
        return _Reduce.apply(x, self, axes) if axes else x

    def scatter_rows(self, x, axis):
        """This rank's block of ``x``'s rows (dim 0); the cotangent's blocks
        gathered back from every member."""
        return _ScatterRows.apply(x, self, axis)

    def gather_rows(self, x, axis):
        """Every member's rows concatenated (dim 0); the cotangent's block of
        this rank (every member's consumers are the same)."""
        return _AllGather.apply(x, self, axis, 0, "slice")

    def q_all_to_all(self, x, axis, fmt: str, split_axis: int, concat_axis: int, out_dtype):
        """``comm.qcomm.q_all_to_all`` through this context's all-to-all:
        ``'none'`` the exact slabs, int8 / fp8 the quantized payload and its
        scales (K6a / K6c and K6b on CUDA tensors)."""
        from ..comm import qcomm

        return qcomm.q_all_to_all(
            x, axis, fmt, split_axis=split_axis, concat_axis=concat_axis, out_dtype=out_dtype,
            world=self.axis_size(axis), mesh=self.grid,
            a2a=lambda t, ax: self._all_to_all(t, ax, 0, 0))

    def mean_over(self, x, axes, grad_axes):
        """The mean of ``x`` over ``axes``; the cotangent summed over
        ``grad_axes`` (the members that hold different cotangents) and
        divided as the forward divides."""
        n = self.axis_size(axes) if axes else 1
        if not axes:
            return x
        return _MeanOver.apply(x, self, axes, grad_axes, n)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, par, axis, split_axis, concat_axis):
        ctx.args = (par, axis, concat_axis, split_axis)
        return par._all_to_all(x, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        par, axis, split_axis, concat_axis = ctx.args
        return par._all_to_all(g.contiguous(), axis, split_axis, concat_axis), None, None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, par, axis, perm):
        ctx.args = (par, axis, tuple((d, s) for s, d in perm))
        return par._ppermute(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        par, axis, inverse = ctx.args
        return par._ppermute(g.contiguous(), axis, inverse), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, par, axis, dim, backward):
        ctx.args = (par, axis, dim, backward)
        return par._all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        par, axis, dim, backward = ctx.args
        if backward == "slice":
            w = par.axis_size(axis)
            n = g.shape[dim] // w
            out = g.narrow(dim, par.axis_rank(axis) * n, n)
        else:
            out = par._reduce_scatter(g.contiguous(), axis, dim)
        return out, None, None, None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, par, axes):
        ctx.args = (par, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        par, axes = ctx.args
        return par._all_reduce(g, axes), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, par, axes):
        return par._all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, par, axis):
        w, r = par.axis_size(axis), par.axis_rank(axis)
        n = x.shape[0] // w
        ctx.args = (par, axis)
        return x[r * n:(r + 1) * n].clone()

    @staticmethod
    def backward(ctx, g):
        par, axis = ctx.args
        return par._all_gather(g.contiguous(), axis, 0), None, None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, par, axes, grad_axes, n):
        ctx.args = (par, grad_axes, n)
        return par._all_reduce(x, axes) / n

    @staticmethod
    def backward(ctx, g):
        par, grad_axes, n = ctx.args
        if grad_axes:
            g = par._all_reduce(g, grad_axes)
        return g / n, None, None, None, None
