"""Packed-suffix context attention — counterpart of ``deepspeed_tpu/ops/
pallas/ctx_attention.py`` (``partial=False``).

``paged_attention_packed_ctx`` dispatches on the device: a CPU tensor runs
``paged_attention_packed_ctx_plain`` (the JAX dense body,
``inference/paged.py:328``, in PyTorch, with the kernel's rules: table ids
outside ``[0, nb)`` are skipped and pad rows come back exactly 0); a CUDA
tensor runs ``csrc/ctx_attention.cu`` (bf16, head_dim 64 or 128, soft cap
fused, mid-page ``ctx_lens``).

Segment contract (the engine's pack builder guarantees it): segment ids are
1-based ctx-table rows (slot + 1), 0 = padding, ids above N are padding too,
and each segment is one contiguous run of pack rows in position order.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import check_cuda, launch, ptr, scalars


def paged_attention_packed_ctx_plain(q, k, v, segment_ids, cache_k, cache_v,
                                     ctx_tables, ctx_lens, scale=None,
                                     logits_soft_cap=None):
    """q [T, hq, hd], k/v [T, hkv, hd], segment_ids [T], pools
    [nb, bs, hkv, hd], ctx_tables [N, P], ctx_lens [N] -> [T, hq, hd].
    One fp32 softmax over [cached context | causal in-pack segment]."""
    t, hq, hd = q.shape
    nb, bs, hkv, _ = cache_k.shape
    n, p = ctx_tables.shape
    g = hq // hkv
    if p > 1:  # gather only the live pages (the JAX body's eager clamp)
        p_live = -(-int(ctx_lens.max()) // bs)
        p = max(min(p, p_live), 1)
        ctx_tables = ctx_tables[:, :p]
    scale = scale if scale is not None else hd ** -0.5
    seg = segment_ids.long()
    live = (seg >= 1) & (seg <= n)
    seg_row = (seg - 1).clamp(0, n - 1)
    owned = (ctx_tables >= 0) & (ctx_tables < nb)  # [N, P]
    safe = torch.where(owned, ctx_tables, 0).long()
    ck = cache_k[safe].reshape(n, p * bs, hkv, hd)[seg_row].float()  # [T, Lc, hkv, hd]
    cv = cache_v[safe].reshape(n, p * bs, hkv, hd)[seg_row].float()

    qf = q.float().reshape(t, hkv, g, hd)
    logits_ctx = torch.einsum("thgd,tlhd->thgl", qf, ck) * scale
    logits_pack = torch.einsum("thgd,shd->thgs", qf, k.float()) * scale
    if logits_soft_cap is not None:
        logits_ctx = logits_soft_cap * torch.tanh(logits_ctx / logits_soft_cap)
        logits_pack = logits_soft_cap * torch.tanh(logits_pack / logits_soft_cap)
    neg = torch.finfo(torch.float32).min
    pos = torch.arange(p * bs, device=q.device)
    ctx_ok = (pos[None, :] < ctx_lens.long()[seg_row][:, None]) \
        & owned.repeat_interleave(bs, dim=1)[seg_row] & live[:, None]  # [T, Lc]
    idx = torch.arange(t, device=q.device)
    # packed order == position order within a segment: causality by pack
    # index + segment equality is exact
    pack_ok = (idx[:, None] >= idx[None, :]) & (seg[:, None] == seg[None, :])
    logits_ctx = torch.where(ctx_ok[:, None, None, :], logits_ctx, neg)
    logits_pack = torch.where(pack_ok[:, None, None, :], logits_pack, neg)
    probs = torch.softmax(torch.cat([logits_ctx, logits_pack], dim=-1), dim=-1)
    pc, pp = probs[..., : p * bs], probs[..., p * bs:]
    out = torch.einsum("thgl,tlhd->thgd", pc, cv) \
        + torch.einsum("thgs,shd->thgd", pp, v.float())
    out = torch.where(live[:, None, None, None], out, 0.0)
    return out.reshape(t, hq, hd).to(q.dtype)


def paged_attention_packed_ctx(q, k, v, segment_ids, cache_k, cache_v,
                               ctx_tables, ctx_lens, scale: Optional[float] = None,
                               logits_soft_cap: Optional[float] = None):
    if q.device.type == "cpu":
        return paged_attention_packed_ctx_plain(
            q, k, v, segment_ids, cache_k, cache_v, ctx_tables, ctx_lens,
            scale, logits_soft_cap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_packed_ctx: unsupported device {q.device}")
    return paged_attention_packed_ctx_kernel(
        q, k, v, segment_ids, cache_k, cache_v, ctx_tables, ctx_lens, scale,
        logits_soft_cap)


def paged_attention_packed_ctx_kernel(q, k, v, segment_ids, cache_k, cache_v,
                                      ctx_tables, ctx_lens, scale=None,
                                      logits_soft_cap=None):
    """The CUDA kernel wrapper: checks, allocates, launches."""
    t, hq, hd = q.shape
    nb, bs, hkv, hd_k = cache_k.shape
    n, p = ctx_tables.shape
    if (k.shape != (t, hkv, hd) or v.shape != k.shape or cache_v.shape != cache_k.shape
            or hd_k != hd or hq % hkv or hd not in (64, 128)):
        raise ValueError(
            f"paged_attention_packed_ctx: q {tuple(q.shape)} k {tuple(k.shape)} "
            f"pool {tuple(cache_k.shape)} not supported (head_dim 64 or 128, hkv | hq)")
    if segment_ids.shape != (t,) or ctx_lens.shape != (n,):
        raise ValueError(f"segment_ids {tuple(segment_ids.shape)} / ctx_lens "
                         f"{tuple(ctx_lens.shape)} do not match T {t} / N {n}")
    check_cuda("paged_attention_packed_ctx", torch.bfloat16, q, k, v, cache_k, cache_v)
    check_cuda("paged_attention_packed_ctx", torch.int32, segment_ids, ctx_tables, ctx_lens)
    if segment_ids.device != q.device:
        raise ValueError("segment_ids/ctx_tables/ctx_lens on another device than q")
    out = torch.empty_like(q)
    sc, cap = scalars(scale if scale is not None else hd ** -0.5, logits_soft_cap)
    launch("ctx_attention", ptr(q), ptr(k), ptr(v), ptr(segment_ids), ptr(cache_k),
           ptr(cache_v), ptr(ctx_tables), ptr(ctx_lens), ptr(out),
           t, hq, hkv, hd, nb, bs, n, p, sc, cap)
    return out
