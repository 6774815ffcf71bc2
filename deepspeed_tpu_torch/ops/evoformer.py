"""Evoformer attention (DeepSpeed4Science): biased MSA attention —
counterpart of ``deepspeed_tpu/ops/evoformer.py``.

Reference: ``deepspeed/ops/deepspeed4science/evoformer_attn.py``
``DS4Sci_EvoformerAttention(Q, K, V, [bias1, bias2])`` over the CUTLASS
kernels in ``csrc/deepspeed4science/evoformer_attn/``.  Shapes follow
AlphaFold2's Evoformer:

- Q/K/V: ``[b, n, s, h, d]``  (batch, MSA rows, sequence, heads, head dim)
- bias1: ``[b, n, 1, 1, s]``  — per-row mask bias (broadcast over heads+query)
- bias2: ``[b, 1, h, s, s]``  — pair-representation bias (broadcast over rows)

One einsum-softmax-einsum with the two additive broadcasts, logits in
fp32, as JAX writes it; ``chunk_rows`` walks the MSA rows in chunks, each
under ``torch.utils.checkpoint`` (JAX's ``lax.scan`` of ``jax.checkpoint``
bodies), so no more than one chunk's ``[b, chunk, h, s, s]`` logits is
live in the forward or the backward.  Gradients, the biases' included (the
reference's backward kernel computes them), come from autograd.  JAX has no
Pallas kernel here, so the port owes no CUDA kernel: this PyTorch body is
the port.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch.utils.checkpoint import checkpoint


def _attn_block(q, k, v, bias1, bias2, scale: float) -> torch.Tensor:
    # q/k/v [b, nc, s, h, d]; bias1 [b, nc, 1, 1, s]; bias2 [b, 1, h, s, s]
    logits = torch.einsum("bnqhd,bnkhd->bnhqk", q.float(), k.float()) * scale
    if bias1 is not None:  # keys masked per MSA row
        logits = logits + bias1.float()
    if bias2 is not None:  # the pair bias, shared across rows
        logits = logits + bias2.float()
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bnhqk,bnkhd->bnqhd", probs.to(v.dtype), v)


def evoformer_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        biases: Optional[List[Optional[torch.Tensor]]] = None,
                        chunk_rows: Optional[int] = None) -> torch.Tensor:
    """``DS4Sci_EvoformerAttention`` semantics (evoformer_attn.py:87).

    ``chunk_rows`` bounds live logits to ``[b, chunk, h, s, s]`` by walking
    the MSA-row dim in recomputed chunks (the memory role of the
    reference's fused kernel); it must divide the rows."""
    biases = list(biases or [])
    while len(biases) < 2:
        biases.append(None)
    bias1, bias2 = biases
    b, n, s, h, d = q.shape
    if bias1 is not None and tuple(bias1.shape) != (b, n, 1, 1, s):
        raise ValueError(f"bias1 shape {tuple(bias1.shape)} != {(b, n, 1, 1, s)}")
    if bias2 is not None and tuple(bias2.shape) != (b, 1, h, s, s):
        raise ValueError(f"bias2 shape {tuple(bias2.shape)} != {(b, 1, h, s, s)}")
    scale = 1.0 / float(d) ** 0.5
    if not chunk_rows or chunk_rows >= n:
        return _attn_block(q, k, v, bias1, bias2, scale)
    if n % chunk_rows:
        raise ValueError(f"chunk_rows {chunk_rows} must divide MSA rows {n}")
    outs = []
    for r0 in range(0, n, chunk_rows):
        rows = slice(r0, r0 + chunk_rows)
        b1 = bias1[:, rows] if bias1 is not None else None
        outs.append(checkpoint(_attn_block, q[:, rows], k[:, rows], v[:, rows], b1, bias2,
                               scale, use_reentrant=False))
    return torch.cat(outs, dim=1)


def DS4Sci_EvoformerAttention(Q, K, V, biases):  # noqa: N802 — reference name
    """Drop-in-named alias of the reference entry point."""
    return evoformer_attention(Q, K, V, biases)
