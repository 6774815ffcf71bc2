"""Sparse embedding gradients — counterpart of
``deepspeed_tpu/ops/sparse_grads.py`` (the reference's ``sparse_gradients``:
``runtime/sparse_tensor.py`` and ``engine.py:2627
sparse_allreduce_no_retain``).

``embedding_lookup(table, ids)`` is ``table[ids]`` whose backward is the
local scatter-add of the ``[tokens, dim]`` gradient rows into a dense fp32
``[vocab, dim]`` table gradient (``index_add_``), cast to the table's type,
as JAX's custom VJP computes it outside any data-parallel axis.  With
``axis_name`` (a data-parallel axis of the current process grid,
``parallel.sharding.set_current_mesh``) the backward all-gathers every
rank's gradient rows and ids over the axis group and scatter-adds them all,
divided by the group's size: each rank gets the mean table gradient while
only ``O(tokens x dim)`` bytes cross the wire, never the dense table
(the reference's ``sparse_allreduce_no_retain``).
"""
from __future__ import annotations

from typing import Optional

import torch


class _EmbeddingLookup(torch.autograd.Function):
    """``table[ids]`` with the scatter-add backward (JAX ``_make_lookup``)."""

    @staticmethod
    def forward(ctx, table, ids, axis_name):
        ctx.save_for_backward(ids)
        ctx.vocab, ctx.dim, ctx.dtype = table.shape[0], table.shape[1], table.dtype
        ctx.axis_name = axis_name
        return table.index_select(0, ids.reshape(-1)).reshape(*ids.shape, table.shape[1])

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        rows = g.reshape(-1, ctx.dim).float()
        flat_ids = ids.reshape(-1)
        n = 1
        if ctx.axis_name is not None:  # the sparse all-reduce: rows and ids travel
            from ..comm import comm

            rows = comm.all_gather(rows, ctx.axis_name)
            flat_ids = comm.all_gather(flat_ids, ctx.axis_name)
            n = comm._grid(None).axis_size(ctx.axis_name)
        grad = torch.zeros(ctx.vocab, ctx.dim, dtype=torch.float32, device=g.device)
        grad.index_add_(0, flat_ids, rows)
        return (grad / n).to(ctx.dtype), None, None


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     axis_name: Optional[str] = None) -> torch.Tensor:
    """``table[ids]`` (``table`` [vocab, dim], ``ids`` integer of any shape)
    whose gradient is a local scatter-add, or with ``axis_name`` (an axis
    of the current process grid) the scatter-add of every rank's rows,
    averaged over the axis.  An axis outside a process grid raises: there
    is no group to gather over."""
    if axis_name is not None:
        from ..parallel.sharding import get_current_mesh

        grid = get_current_mesh()
        if grid is None or not hasattr(grid, "group"):
            raise RuntimeError(f"embedding_lookup(axis_name={axis_name!r}) needs a process "
                               "grid: set_current_mesh(initialize_mesh(...)) in a world")
        grid.axis_size(axis_name)  # an axis the grid does not span raises now
    return _EmbeddingLookup.apply(table, ids.long(), axis_name)
