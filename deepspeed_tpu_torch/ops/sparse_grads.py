"""Sparse embedding gradients — counterpart of
``deepspeed_tpu/ops/sparse_grads.py`` (the reference's ``sparse_gradients``:
``runtime/sparse_tensor.py`` and ``engine.py:2627
sparse_allreduce_no_retain``).

``embedding_lookup(table, ids)`` is ``table[ids]`` whose backward is the
local scatter-add of the ``[tokens, dim]`` gradient rows into a dense fp32
``[vocab, dim]`` table gradient (``index_add_``), cast to the table's type,
as JAX's custom VJP computes it outside any data-parallel axis.  The
all-gathered backward over a data-parallel axis (``axis_name``: rows and
ids gathered, the table gradient never reduced densely) comes with the
distributed layers, ROADMAP queue 1 item 7.
"""
from __future__ import annotations

from typing import Optional

import torch


class _EmbeddingLookup(torch.autograd.Function):
    """``table[ids]`` with the scatter-add backward (JAX ``_make_lookup``)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.vocab, ctx.dim, ctx.dtype = table.shape[0], table.shape[1], table.dtype
        return table.index_select(0, ids.reshape(-1)).reshape(*ids.shape, table.shape[1])

    @staticmethod
    def backward(ctx, g):
        ids, = ctx.saved_tensors
        rows = g.reshape(-1, ctx.dim).float()
        grad = torch.zeros(ctx.vocab, ctx.dim, dtype=torch.float32, device=g.device)
        grad.index_add_(0, ids.reshape(-1), rows)
        return grad.to(ctx.dtype), None


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     axis_name: Optional[str] = None) -> torch.Tensor:
    """``table[ids]`` (``table`` [vocab, dim], ``ids`` integer of any shape)
    whose gradient is a local scatter-add.  ``axis_name`` (JAX's
    data-parallel axis for the all-gathered sparse backward) raises
    ``NotImplementedError``: the port runs on one device."""
    if axis_name is not None:
        raise NotImplementedError(
            f"embedding_lookup(axis_name={axis_name!r}): the all-gathered sparse backward "
            "over a data-parallel axis is not ported yet (ROADMAP queue 1 item 7)")
    return _EmbeddingLookup.apply(table, ids.long())
