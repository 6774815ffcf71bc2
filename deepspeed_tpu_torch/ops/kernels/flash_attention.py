"""Flash attention, forward and backward — counterpart of ``deepspeed_tpu/
ops/pallas/flash_kernel.py`` (``_fwd``, ``_bwd`` and the ``_flash`` custom
VJP) and of its dispatcher ``ops/pallas/flash_attention.py``.

``flash_attention`` keeps the JAX entry's ``[b, s, h, d]`` layout.  Without
grad, a CPU tensor runs the plain body (``ops.attention.
dot_product_attention``) and a CUDA tensor the forward kernel
``csrc/flash_fwd.cu`` with no lse (serving).  With grad it goes through
``FlashAttentionFn``, which saves ``(q, k, v, seg, o, lse)`` and whose
backward is ``csrc/flash_bwd.cu`` (dq kernel, dk/dv kernel).  The Function
is the same on both devices; only its two inner calls dispatch on the
tensor's device: the plain versions on the CPU (the tests), the kernels on
CUDA.  The backward is ``once_differentiable`` (``ops.kernels``'s, which
links its error node to the inputs): its outputs carry no graph (on the
card they come from a kernel; the plain version treats the saved o and lse
as constants), so a double backward through the Function raises instead
of returning a wrong second derivative, as JAX cannot take ``jvp``
through its custom VJP either.  The kernels (wgmma on the tensor cores) take causal attention with
GQA, packed ``segment_ids`` and the soft cap, bf16, head_dim 64, 128 or 256
(the head dims JAX's gate admits, ``flash_kernel.py:108``), any query group
(a CTA per query head) and any sequence length (there is no TPU minimum).
The entry pads a head dim below 256 that the kernels do not take (80 for
``phi_2``, 96 for ``gpt_neox_20b``) with zeros to the next one they do,
passes the scale of the real head dim and slices the output back: the
zeros add nothing to q k^T, the padded columns of o are 0, and autograd
slices dq / dk / dv back through the pad, so the kernels run at 128 and the
result is the unpadded one.  The kernel wrappers themselves keep taking
only ``HEAD_DIMS``; a head dim above 256 raises.  A non-causal call or
``q_offset != 0`` runs the plain body on a CPU tensor and raises on a CUDA
one.

Shapes: q/o/dO ``[b, s, hq, d]``, k/v ``[b, s, hkv, d]`` (hkv divides hq),
segment_ids ``[b, s]`` int32, lse ``[b, hq, s]`` fp32 in capped scaled-score
units (``flash_kernel.py:170``), delta ``[b, s, hq]`` fp32.

Inside ``ops.kernels.count_kernel_flops`` a launch adds its operations to
``KERNEL_FLOPS``: 4 hd a causal (query, key) pair and query head forward
(``flash_fwd``), 10 hd backward (``flash_bwd``, the dq and dk/dv kernels
as one pair), the counts ``PERF.md``'s bounds use.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..attention import dot_product_attention, repeat_kv
from . import (HEAD_DIMS, add_flops, check_cuda, check_heads, launch,
                once_differentiable, ptr, scalars)


# ---------------------------------------------------------------------------
# plain versions (the tests, and the card's reference in chip_smoke.py)
# ---------------------------------------------------------------------------
def _scores(q, k, seg, scale, cap, kv_seg=None, mask=None):
    """(capped scaled scores [b, hq, s, s] fp32, the mask of allowed
    entries: causal, same segment (``kv_seg`` for the keys when given) and
    ``mask`` [s, s] bool when given — the block-sparse kernels' layout)."""
    hq, hkv = q.shape[2], k.shape[2]
    s_raw = torch.einsum("bqhd,bkhd->bhqk", q.float(), repeat_kv(k, hq // hkv).float()) * scale
    s_cap = cap * torch.tanh(s_raw / cap) if cap is not None else s_raw
    n = q.shape[1]
    allowed = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    if mask is not None:
        allowed = allowed & mask.to(q.device)
    allowed = allowed[None, None]
    if seg is not None:
        ks = kv_seg if kv_seg is not None else seg
        allowed = allowed & (seg[:, None, :, None] == ks[:, None, None, :])
    return s_cap, allowed


def flash_attention_fwd_plain(q, k, v, seg, scale, cap, kv_seg=None,
                              mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [b, s, hq, d] in q's type, lse [b, hq, s] fp32): the forward
    kernel's function, computed in fp32 (``kv_seg`` and ``mask`` as in
    ``_scores``)."""
    s_cap, allowed = _scores(q, k, seg, scale, cap, kv_seg, mask)
    s = s_cap.masked_fill(~allowed, torch.finfo(torch.float32).min)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    hq, hkv = q.shape[2], k.shape[2]
    o = torch.einsum("bhqk,bkhd->bqhd", p, repeat_kv(v, hq // hkv).float())
    return o.to(q.dtype), lse


def flash_attention_bwd_plain(q, k, v, seg, o, lse, do, scale, cap, kv_seg=None, mask=None):
    """(dq, dk, dv) in the inputs' types, by the FA2 formulas in fp32: p
    rebuilt from lse, D = rowsum(dO * o), ds = p (dp - D) cap' scale; dk / dv
    summed over each kv head's group of query heads."""
    b, n, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    s_cap, allowed = _scores(q, k, seg, scale, cap, kv_seg, mask)
    p = torch.where(allowed, torch.exp(s_cap - lse[..., None]), 0.0)
    dof = do.float()
    delta = (o.float() * dof).sum(-1).transpose(1, 2)  # [b, hq, s]
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, repeat_kv(v, g).float())
    ds = p * (dp - delta[..., None]) * scale
    if cap is not None:
        ds = ds * (1.0 - (s_cap / cap) ** 2)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, repeat_kv(k, g).float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()).reshape(b, n, hkv, g, d).sum(3)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof).reshape(b, n, hkv, g, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_pairs(q, segment_ids=None, kv_segment_ids=None, mask=None) -> int:
    """The (query, key) pairs one query head of ``q`` [b, s, ...] attends
    over: b s (s + 1) / 2 causal pairs, or, with segment ids (``kv_segment_ids``
    for the keys) or an [s, s] bool ``mask``, the allowed pairs counted on
    the device (a host read)."""
    b, s = q.shape[:2]
    if segment_ids is None and mask is None:
        return b * s * (s + 1) // 2
    allowed = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    if mask is not None:
        allowed &= mask.to(q.device)
    if segment_ids is None:
        return b * int(allowed.sum())
    ks = kv_segment_ids if kv_segment_ids is not None else segment_ids
    return int((allowed[None] & (segment_ids[:, :, None] == ks[:, None, :])).sum())


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------
def _check(name, q, k, v, segment_ids):
    b, s, hq, d = q.shape
    if k.shape != (b, s, k.shape[2], d) or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    check_heads(name, hq, k.shape[2], d)
    check_cuda(name, torch.bfloat16, q, k, v)
    if segment_ids is None:
        return None
    if segment_ids.shape != (b, s):
        raise ValueError(f"{name}: segment_ids {tuple(segment_ids.shape)} != {(b, s)}")
    check_cuda(name, torch.int32, segment_ids)
    if segment_ids.device != q.device:
        raise ValueError(f"{name}: segment_ids on another device than q")
    return ptr(segment_ids)


def flash_attention_kernel(q, k, v, segment_ids=None, scale=None, logits_soft_cap=None,
                           return_lse: bool = False):
    """The forward kernel: o, or (o, lse) with ``return_lse``."""
    seg_ptr = _check("flash_attention", q, k, v, segment_ids)
    b, s, hq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device) if return_lse else None
    sc, cap = scalars(scale if scale is not None else d ** -0.5, logits_soft_cap)
    launch("flash_fwd", ptr(q), ptr(k), ptr(v), seg_ptr, ptr(out),
           ptr(lse) if return_lse else None, b, s, hq, k.shape[2], d, sc, cap)
    add_flops("flash_fwd", lambda: 4 * d * hq * attention_pairs(q, segment_ids))
    return (out, lse) if return_lse else out


def flash_attention_bwd_kernel(q, k, v, segment_ids, o, lse, do, scale=None,
                               logits_soft_cap=None):
    """The backward kernels: (dq, dk, dv) in bf16.  delta = rowsum(dO * o)
    is one PyTorch reduction (JAX too computes it outside Pallas)."""
    seg_ptr = _check("flash_attention_bwd", q, k, v, segment_ids)
    check_cuda("flash_attention_bwd", torch.bfloat16, o, do)
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, hq, s):
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} dO {tuple(do.shape)} "
                         f"lse {tuple(lse.shape)} for q {tuple(q.shape)}")
    check_cuda("flash_attention_bwd", torch.float32, lse)
    delta = (o.float() * do.float()).sum(-1)  # [b, s, hq]
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    sc, cap = scalars(scale if scale is not None else d ** -0.5, logits_soft_cap)
    common = (ptr(q), ptr(k), ptr(v), seg_ptr, ptr(do), ptr(lse), ptr(delta))
    launch("flash_bwd_dq", *common, ptr(dq), b, s, hq, hkv, d, sc, cap)
    launch("flash_bwd_dkv", *common, ptr(dk), ptr(dv), b, s, hq, hkv, d, sc, cap)
    add_flops("flash_bwd", lambda: 10 * d * hq * attention_pairs(q, segment_ids))
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the autograd Function (the ``_flash`` custom VJP)
# ---------------------------------------------------------------------------
def _fwd_with_lse(q, k, v, seg, scale, cap):
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, seg, scale, cap)
    return flash_attention_kernel(q, k, v, seg, scale, cap, return_lse=True)


def _bwd(q, k, v, seg, o, lse, do, scale, cap):
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, seg, o, lse, do, scale, cap)
    return flash_attention_bwd_kernel(q, k, v, seg, o, lse, do.contiguous(), scale, cap)


class FlashAttentionFn(torch.autograd.Function):
    """Causal flash attention whose backward rebuilds the probabilities from
    the saved lse (``flash_kernel.py:450-471``)."""

    @staticmethod
    def forward(ctx, q, k, v, seg, scale, cap):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = _fwd_with_lse(q, k, v, seg, scale, cap)
        ctx.save_for_backward(q, k, v, seg, o, lse)
        ctx.scale, ctx.cap = scale, cap
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, seg, o, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, seg, o, lse, do, ctx.scale, ctx.cap)
        return dq, dk, dv, None, None, None


def padded_head_dim(d: int) -> int:
    """The head dim the kernels run a head dim ``d`` at: the least of
    ``HEAD_DIMS`` that holds it."""
    for wide in HEAD_DIMS:
        if d <= wide:
            return wide
    raise NotImplementedError(
        f"flash_attention: head_dim {d} is above the kernels' largest, {HEAD_DIMS[-1]}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    logits_soft_cap: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """q [b, s, hq, d], k/v [b, s, hkv, d], segment_ids [b, s] -> [b, s, hq, d]."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if not causal or q_offset != 0:
        if q.device.type == "cuda":
            raise NotImplementedError(
                "flash_attention kernel is causal-only with q_offset 0 "
                f"(causal={causal}, q_offset={q_offset})")
        return dot_product_attention(q, k, v, causal=causal, q_offset=q_offset,
                                     segment_ids=segment_ids, scale=scale,
                                     logits_soft_cap=logits_soft_cap)
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    if q.device.type == "cpu" and not grad:
        return dot_product_attention(q, k, v, causal=True, segment_ids=segment_ids,
                                     scale=scale, logits_soft_cap=logits_soft_cap)
    d = q.shape[-1]
    if d not in HEAD_DIMS:
        wide = padded_head_dim(d)
        q, k, v = (torch.nn.functional.pad(t, (0, wide - d)) for t in (q, k, v))
        scale = scale if scale is not None else d ** -0.5
        return flash_attention(q, k, v, True, segment_ids, scale, logits_soft_cap)[..., :d]
    if grad:
        sc = float(scale) if scale is not None else d ** -0.5
        cap = float(logits_soft_cap) if logits_soft_cap is not None else None
        return FlashAttentionFn.apply(q, k, v, segment_ids, sc, cap)
    return flash_attention_kernel(q, k, v, segment_ids, scale, logits_soft_cap)
