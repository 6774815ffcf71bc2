"""Attention reference body and dispatch — counterpart of
``deepspeed_tpu/ops/attention.py``.

``dot_product_attention`` is the plain PyTorch scaled-dot-product attention
with GQA, causal and packed-segment masking, an additive bias (ALiBi) and
the tanh soft cap, in the ``[batch, seq, heads, head_dim]`` layout.  It is
the plain body of the flash kernels (``ops/kernels/flash_attention.py``) and
the ground truth of their tests; the serving and training paths on a CUDA
device never call it.  ``get_attention_impl`` picks a body by name.
"""
from __future__ import annotations

from typing import Optional

import torch


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[b, s, h_kv, d] -> [b, s, h_kv * n_rep, d] by head-group broadcast."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def make_causal_mask(q_len: int, kv_len: int, q_offset: int = 0,
                     device=None) -> torch.Tensor:
    """Additive fp32 mask allowing query i to attend key j <= i + offset."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    neg = torch.finfo(torch.float32).min
    return torch.where(q_pos >= kv_pos, torch.tensor(0.0, device=device),
                       torch.tensor(neg, device=device))


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    q_offset: int = 0,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    logits_soft_cap: Optional[float] = None,
    attn_mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q [b, sq, hq, d]; k/v [b, skv, hkv, d] (hkv divides hq).  Softmax in
    fp32 whatever the input type; the probabilities are cast back to the
    input type before the value product, as the JAX body does.
    ``attn_mask`` [sq, skv] bool composes with the causal and segment masks
    (block-sparse layouts, ``ops/sparse_attention.py``); a masked logit is
    ``finfo(float32).min``, not -inf, so a fully masked row softmaxes as in
    JAX.  ``bias`` [hq, sq, skv] or per batch row [b, hq, sq, skv] adds to
    the scaled logits before the soft cap."""
    in_dtype = q.dtype
    hq, hkv = q.shape[2], k.shape[2]
    k = repeat_kv(k, hq // hkv)
    v = repeat_kv(v, hq // hkv)
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        bias = bias.float()
        logits = logits + (bias if bias.dim() == 4 else bias[None])
    if logits_soft_cap is not None:
        logits = logits_soft_cap * torch.tanh(logits / logits_soft_cap)
    if causal:
        logits = logits + make_causal_mask(q.shape[1], k.shape[1], q_offset,
                                           device=q.device)[None, None]
    if segment_ids is not None:
        kv_seg = kv_segment_ids if kv_segment_ids is not None else segment_ids
        allowed = segment_ids[:, None, :, None] == kv_seg[:, None, None, :]
        logits = torch.where(allowed, logits, torch.finfo(torch.float32).min)
    if attn_mask is not None:
        logits = torch.where(attn_mask[None, None], logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(in_dtype), v)


def get_attention_impl(name: str = "auto", device=None):
    """An attention body by name: ``reference`` / ``math`` -> the plain body;
    ``flash`` -> the flash kernels' entry (``ops/kernels/flash_attention``:
    the kernels on a CUDA tensor, their plain versions on a CPU one);
    ``auto`` -> flash when ``device`` is CUDA, the plain body otherwise."""
    if name in ("reference", "math"):
        return dot_product_attention
    if name not in ("flash", "auto"):
        raise ValueError(f"unknown attention impl '{name}' (reference|math|flash|auto)")
    from .kernels.flash_attention import flash_attention

    if name == "flash" or (device is not None and torch.device(device).type == "cuda"):
        return flash_attention
    return dot_product_attention
