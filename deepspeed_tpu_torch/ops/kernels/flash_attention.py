"""Flash-attention forward — counterpart of ``deepspeed_tpu/ops/pallas/
flash_attention.py`` (the dispatcher) and the forward half of
``flash_kernel.py``.

``flash_attention`` keeps the JAX entry's signature and ``[b, s, h, d]``
layout.  A CPU tensor runs the plain body (``ops.attention.
dot_product_attention``); a CUDA tensor runs the hand-written kernel
``csrc/flash_fwd.cu`` (causal, GQA, packed ``segment_ids``, soft cap; bf16,
head_dim 64 or 128, any sequence length — no minimum as on the TPU).
Training's backward kernel comes with the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..attention import dot_product_attention
from . import check_cuda, launch, ptr, scalars


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    logits_soft_cap: Optional[float] = None,
) -> torch.Tensor:
    """q [b, s, hq, d], k/v [b, s, hkv, d], segment_ids [b, s] -> [b, s, hq, d]."""
    if q.device.type == "cpu":
        return dot_product_attention(
            q, k, v, causal=causal, segment_ids=segment_ids, scale=scale,
            logits_soft_cap=logits_soft_cap,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if not causal:
        raise NotImplementedError("flash_attention kernel is causal-only")
    return flash_attention_kernel(q, k, v, segment_ids, scale, logits_soft_cap)


def flash_attention_kernel(q, k, v, segment_ids=None, scale=None,
                           logits_soft_cap=None) -> torch.Tensor:
    """The CUDA kernel wrapper: checks, allocates, launches."""
    b, s, hq, d = q.shape
    if k.shape != (b, s, k.shape[2], d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    hkv = k.shape[2]
    if hq % hkv or d not in (64, 128):
        raise ValueError(f"flash_attention: hq {hq} / hkv {hkv} / head_dim {d} "
                         "not supported (head_dim 64 or 128, hkv | hq)")
    check_cuda("flash_attention", torch.bfloat16, q, k, v)
    seg_ptr = None
    if segment_ids is not None:
        if segment_ids.shape != (b, s):
            raise ValueError(f"segment_ids {tuple(segment_ids.shape)} != {(b, s)}")
        check_cuda("flash_attention", torch.int32, segment_ids)
        if segment_ids.device != q.device:
            raise ValueError("segment_ids on another device than q")
        seg_ptr = ptr(segment_ids)
    out = torch.empty_like(q)
    sc, cap = scalars(scale if scale is not None else d ** -0.5, logits_soft_cap)
    launch("flash_fwd", ptr(q), ptr(k), ptr(v), seg_ptr, ptr(out),
           b, s, hq, hkv, d, sc, cap)
    return out
