"""The ``expert`` axis of a process grid: the layout of a rank's experts,
and the composite layout a training engine keeps (``ShardLayout``: the
model axis's cut, ``parallel/tensor_parallel.py``, and the expert axis's).

JAX shards the stacked expert weights on their expert dim over
``expert`` (``models/transformer.py:1166-1169``: ``w_gate`` / ``w_up``
``P(None, "expert", None, "model")``, ``w_down`` ``P(None, "expert",
"model", None)``) and lets GSPMD place the dispatch.  Here a rank holds
its ``E / W`` experts (``ExpertParallel``): ``layers/moe/w_gate``,
``w_up`` and ``w_down`` ``[L, E, ...]`` cut on dim 1 in ``W`` contiguous
blocks; the router and every dense leaf stay whole.  The model's routed
layer computes those experts' contributions (``moe/layer.py``).

``ShardLayout`` cuts a tree of whole leaves to a rank's shard over both
axes (``shard_tree``), gathers it back (``gather_tree``, collectives over
``expert`` and ``model``), gives the ZeRO plan its rules (``rules``) and
the gradient norm the axes each leaf is cut over (``axes_of``): what
checkpoints hold is the logical tree, so a save at one ``expert`` size
loads at another.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from .sharding import P
from .tensor_parallel import Placement, _leaf_paths, _set
from .topology import EXPERT_AXIS, MODEL_AXIS

EXPERT_LEAVES = ("w_gate", "w_up", "w_down")  # stacked [L, E, ...]: E is dim 1


def is_expert_leaf(path: Tuple[str, ...]) -> bool:
    return len(path) == 3 and path[:2] == ("layers", "moe") and path[2] in EXPERT_LEAVES


class ExpertParallel:
    """One rank's experts over the ``expert`` axis (``rank`` of ``size``;
    from ``grid`` unless given): ``local`` experts from ``e0``."""

    def __init__(self, grid, cfg, rank: Optional[int] = None, size: Optional[int] = None):
        self.grid = grid
        self.size = int(size if size is not None else grid.axis_size(EXPERT_AXIS))
        self.rank = int(rank if rank is not None else grid.axis_rank(EXPERT_AXIS))
        e = cfg.moe_num_experts
        if e <= 0:
            raise ValueError("an expert layout needs a MoE model (moe_num_experts > 0)")
        if e % self.size:
            raise ValueError(f"num_experts {e} must be divisible by the expert axis "
                             f"({self.size})")
        self.local = e // self.size
        self.e0 = self.rank * self.local

    def placement(self, path: Tuple[str, ...], shape: Tuple[int, ...]) -> Placement:
        if is_expert_leaf(path):
            return Placement("shard", 1, self.e0, self.e0 + self.local)
        return Placement("rep")

    def shard_tree(self, tree):
        out: Dict[str, Any] = {}
        for p, x in _leaf_paths(tree):
            if is_expert_leaf(p):
                x = torch.as_tensor(x).narrow(1, self.e0, self.local).detach().clone().contiguous()
            _set(out, p, x)
        return out

    @torch.no_grad()
    def gather_tree(self, local):
        """Every rank's experts concatenated (an all-gather over ``expert``
        per expert leaf; every rank calls it)."""
        from ..comm import comm

        out: Dict[str, Any] = {}
        for p, x in _leaf_paths(local):
            if is_expert_leaf(p):
                x = comm.all_gather(x.detach().contiguous(), EXPERT_AXIS, axis=1, mesh=self.grid)
            _set(out, p, x)
        return out


class ShardLayout:
    """A rank's shard of the whole tree over ``model`` (``tp``) and
    ``expert`` (``ep``); either may be None."""

    def __init__(self, tp=None, ep=None):
        self.tp, self.ep = tp, ep

    def shard_tree(self, tree):
        if self.tp is not None:
            tree = self.tp.shard_tree(tree)
        if self.ep is not None:
            tree = self.ep.shard_tree(tree)
        return tree

    def gather_tree(self, local, whole_shapes):
        if self.ep is not None:
            local = self.ep.gather_tree(local)
        if self.tp is not None:
            local = self.tp.gather_tree(local, whole_shapes)
        return local

    def axes_of(self, whole) -> Dict[Tuple[str, ...], Tuple[str, ...]]:
        """Each leaf's axes of cut (grid order), from the whole tree."""
        out = {}
        for p, x in _leaf_paths(whole):
            shape = tuple(getattr(x, "shape", x))
            axes = ()
            if self.ep is not None and self.ep.placement(p, shape).kind == "shard":
                axes += (EXPERT_AXIS,)
            if self.tp is not None and self.tp.placement(p, shape).kind == "shard":
                axes += (MODEL_AXIS,)
            out[p] = axes
        return out

    def rules(self, whole) -> List[Tuple[str, P]]:
        """The layout as ``(regex, P)`` rules over the whole tree's paths
        (the ZeRO plan composes its ``fsdp`` entries with them)."""
        out = []
        for p, x in _leaf_paths(whole):
            shape = tuple(getattr(x, "shape", x))
            entries = [None] * len(shape)
            if self.ep is not None:
                pl = self.ep.placement(p, shape)
                if pl.kind == "shard":
                    entries[pl.dim] = EXPERT_AXIS
            if self.tp is not None:
                pl = self.tp.placement(p, shape)
                if pl.kind == "shard":
                    entries[pl.dim] = MODEL_AXIS
            if any(e is not None for e in entries):
                out.append((f"^{re.escape('/'.join(p))}$", P(*entries)))
        return out
