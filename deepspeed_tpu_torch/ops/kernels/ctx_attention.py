"""Packed-suffix context attention — counterpart of ``deepspeed_tpu/ops/
pallas/ctx_attention.py``, both modes.

``paged_attention_packed_ctx`` dispatches on the device: a CPU tensor runs
``paged_attention_packed_ctx_plain`` (the JAX dense body,
``inference/paged.py:328``, in PyTorch, with the kernel's rules: table ids
outside ``[0, nb)`` are skipped and pad rows come back exactly 0); a CUDA
tensor runs ``csrc/ctx_attention.cu`` (bf16, head_dim 64, 128 or 256, any
group of query heads a kv head, soft cap fused, mid-page ``ctx_lens``; other
head dims raise ``NotImplementedError``, ROADMAP queue 2).

``paged_attention_packed_ctx_partial`` is the TPU kernel's ``partial=True``
mode, the per-shard body of seq-sharded serving: over one shard's slice of
the pool (table ids translated to it; the others skipped) it returns the
unnormalized fp32 ``(acc, m, l)``, with the pack's own keys only where
``include_pack`` (shard 0), for the log-sum-exp merge
(``inference/paged.py``).  Plain version: ``_packed_ctx_partial`` of the
JAX ``inference/paged.py:384``; launches count as ``ctx_attention_partial``.

Segment contract (the engine's pack builder guarantees it): segment ids are
1-based ctx-table rows (slot + 1), 0 = padding, ids above N are padding too,
and each segment is one contiguous run of pack rows in position order.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import check_cuda, check_heads, launch, ptr, scalars

NEG_INF = -1e30
MAX_SEGMENTS = 4096  # ctx_tables rows the kernel's segment scan holds


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


def paged_attention_packed_ctx_partial_plain(q, k, v, segment_ids, cache_k, cache_v,
                                             ctx_tables, ctx_lens, include_pack=True,
                                             scale=None, logits_soft_cap=None):
    """The partial mode's plain version (JAX ``inference/paged.py:384
    _packed_ctx_partial``, the jnp body JAX itself falls back to), with the
    kernel's rules: the context keys are those of table pages in
    ``[0, nb)`` (this shard's; the others are skipped), the pack's own
    causal keys join only with ``include_pack``, and a pad row or a row with
    no key here gives ``(0, -1e30, 0)``.  Returns fp32 ``(acc [T, hq, hd],
    m [T, hq], l [T, hq])``, unnormalized."""
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
    pos = torch.arange(p * bs, device=q.device)
    ctx_ok = (pos[None, :] < ctx_lens.long()[seg_row][:, None]) \
        & owned.repeat_interleave(bs, dim=1)[seg_row] & live[:, None]  # [T, Lc]
    idx = torch.arange(t, device=q.device)
    pack_ok = (idx[:, None] >= idx[None, :]) & (seg[:, None] == seg[None, :]) \
        & live[:, None] & bool(include_pack)  # [T, T]
    ctx_ok, pack_ok = ctx_ok[:, None, None, :], pack_ok[:, None, None, :]
    logits_ctx = torch.where(ctx_ok, logits_ctx, NEG_INF)
    logits_pack = torch.where(pack_ok, logits_pack, NEG_INF)
    m = torch.maximum(logits_ctx.max(dim=-1).values, logits_pack.max(dim=-1).values)
    # keyless rows' exp(NEG_INF - NEG_INF) = 1 must not reach l or acc
    wc = torch.where(ctx_ok, torch.exp(logits_ctx - m[..., None]), 0.0)
    wp = torch.where(pack_ok, torch.exp(logits_pack - m[..., None]), 0.0)
    l = wc.sum(dim=-1) + wp.sum(dim=-1)
    acc = torch.einsum("thgl,tlhd->thgd", wc, cv) + torch.einsum("thgs,shd->thgd", wp, v.float())
    return acc.reshape(t, hq, hd), m.reshape(t, hq), l.reshape(t, hq)


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


def paged_attention_packed_ctx_partial(q, k, v, segment_ids, cache_k, cache_v, ctx_tables,
                                       ctx_lens, include_pack=True,
                                       scale: Optional[float] = None,
                                       logits_soft_cap: Optional[float] = None):
    """The partial mode on ``q``'s device: the plain body on the CPU, the
    kernel on CUDA."""
    if q.device.type == "cpu":
        return paged_attention_packed_ctx_partial_plain(
            q, k, v, segment_ids, cache_k, cache_v, ctx_tables, ctx_lens, include_pack,
            scale, logits_soft_cap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_packed_ctx_partial: unsupported device {q.device}")
    return paged_attention_packed_ctx_partial_kernel(
        q, k, v, segment_ids, cache_k, cache_v, ctx_tables, ctx_lens, include_pack, scale,
        logits_soft_cap)


def _check(name, q, k, v, segment_ids, cache_k, cache_v, ctx_tables, ctx_lens):
    """Shapes first (a CPU tensor reaches these checks too), then the
    device, type and layout checks of a CUDA launch."""
    t, hq, hd = q.shape
    nb, bs, hkv, hd_k = cache_k.shape
    n, p = ctx_tables.shape
    if k.shape != (t, hkv, hd) or v.shape != k.shape or cache_v.shape != cache_k.shape \
            or hd_k != hd:
        raise ValueError(f"{name}: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"pool {tuple(cache_k.shape)} do not match")
    check_heads(name, hq, hkv, hd)
    if segment_ids.shape != (t,) or ctx_lens.shape != (n,):
        raise ValueError(f"{name}: segment_ids {tuple(segment_ids.shape)} / ctx_lens "
                         f"{tuple(ctx_lens.shape)} do not match T {t} / N {n}")
    if t < 1 or not 1 <= n <= MAX_SEGMENTS:
        raise ValueError(f"{name}: T {t} and N {n} must be >= 1, N at most {MAX_SEGMENTS}")
    check_cuda(name, torch.bfloat16, q, k, v, cache_k, cache_v)
    check_cuda(name, torch.int32, segment_ids, ctx_tables, ctx_lens)
    if segment_ids.device != q.device:
        raise ValueError(f"{name}: segment_ids/ctx_tables/ctx_lens on another device than q")


def paged_attention_packed_ctx_kernel(q, k, v, segment_ids, cache_k, cache_v,
                                      ctx_tables, ctx_lens, scale=None,
                                      logits_soft_cap=None):
    """The CUDA kernel wrapper: checks, allocates, launches."""
    _check("paged_attention_packed_ctx", q, k, v, segment_ids, cache_k, cache_v, ctx_tables,
           ctx_lens)
    t, hq, hd = q.shape
    nb, bs, hkv, _ = cache_k.shape
    n, p = ctx_tables.shape
    out = torch.empty_like(q)
    sc, cap = scalars(scale if scale is not None else hd ** -0.5, logits_soft_cap)
    launch("ctx_attention", ptr(q), ptr(k), ptr(v), ptr(segment_ids), ptr(cache_k),
           ptr(cache_v), ptr(ctx_tables), ptr(ctx_lens), ptr(out),
           t, hq, hkv, hd, nb, bs, n, p, sc, cap)
    return out


def paged_attention_packed_ctx_partial_kernel(q, k, v, segment_ids, cache_k, cache_v,
                                              ctx_tables, ctx_lens, include_pack=True,
                                              scale=None, logits_soft_cap=None):
    """The partial mode's CUDA wrapper: fp32 ``(acc, m, l)``."""
    _check("paged_attention_packed_ctx_partial", q, k, v, segment_ids, cache_k, cache_v,
           ctx_tables, ctx_lens)
    t, hq, hd = q.shape
    nb, bs, hkv, _ = cache_k.shape
    n, p = ctx_tables.shape
    acc = torch.empty(t, hq, hd, dtype=torch.float32, device=q.device)
    m = torch.empty(t, hq, dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    sc, cap = scalars(scale if scale is not None else hd ** -0.5, logits_soft_cap)
    launch("ctx_attention_partial", ptr(q), ptr(k), ptr(v), ptr(segment_ids), ptr(cache_k),
           ptr(cache_v), ptr(ctx_tables), ptr(ctx_lens), ptr(acc), ptr(m), ptr(l),
           t, hq, hkv, hd, nb, bs, n, p, int(bool(include_pack)), sc, cap)
    return acc, m, l
