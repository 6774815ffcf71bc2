"""Paged-attention decode — counterpart of ``deepspeed_tpu/ops/pallas/
paged_attention.py``.

``paged_attention_decode`` dispatches on the device: a CPU tensor runs the
plain body ``paged_attention_decode_plain`` (the JAX dense body,
``inference/paged.py:698``, in PyTorch); a CUDA tensor runs
``csrc/paged_decode.cu`` (bf16, head_dim 64, 128 or 256, any group of
query heads per kv head, MHA included, soft cap fused — so no configuration
sends decode to the plain body on the card).  Other head dims raise
``NotImplementedError`` (ROADMAP queue 2).

``paged_attention_decode_partial`` is the seq-sharded decode's per-shard
body (JAX ``inference/paged.py:558``, a jnp body there): the same kernel in
its partial mode, over one shard's slice of the pool, returning the fp32
``(acc, m, l)`` triple; its launches count under ``paged_decode_partial``.

At head_dim 64 the kernel is also the counterpart of the TPU's K2p
(``paged_attention.py:225 _paged_decode_packed``), which packs kv heads
side by side on the 128-wide lanes because a TPU page slice must be 128
lanes wide.  The CUDA kernel gathers the ``[nb, bs, hkv, hd]`` pool one kv
head at a time in 16-byte vectors and needs no packing; its launches count
under ``paged_decode_hd64`` (``paged_decode`` at head_dim 128).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import check_cuda, check_heads, launch, ptr, scalars

NEG_INF = -1e30


def paged_attention_decode_plain(q, cache_k, cache_v, block_table, seq_lens,
                                 scale=None, logits_soft_cap=None):
    """Dense reference: gathers every table entry (ids clamped to the pool,
    as the JAX body does), masks positions >= seq_lens, fp32 softmax.
    q [B, hq, hd]; pools [nb, bs, hkv, hd]; block_table [B, P];
    seq_lens [B] (including the current token) -> [B, hq, hd]."""
    b, hq, hd = q.shape
    nb, bs, hkv, _ = cache_k.shape
    p = block_table.shape[1]
    g = hq // hkv
    safe = block_table.long().clamp(0, nb - 1)
    k = cache_k[safe].reshape(b, p * bs, hkv, hd).float()
    v = cache_v[safe].reshape(b, p * bs, hkv, hd).float()
    scale = scale if scale is not None else hd ** -0.5
    qf = q.float().reshape(b, hkv, g, hd)
    logits = torch.einsum("bhgd,bkhd->bhgk", qf, k) * scale
    if logits_soft_cap is not None:
        logits = logits_soft_cap * torch.tanh(logits / logits_soft_cap)
    mask = torch.arange(p * bs, device=q.device)[None, :] < seq_lens[:, None]
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", probs, v)
    return out.reshape(b, hq, hd).to(q.dtype)


def paged_attention_decode(q, cache_k, cache_v, block_table, seq_lens,
                           scale: Optional[float] = None,
                           logits_soft_cap: Optional[float] = None):
    if q.device.type == "cpu":
        return paged_attention_decode_plain(
            q, cache_k, cache_v, block_table, seq_lens, scale, logits_soft_cap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_decode: unsupported device {q.device}")
    return paged_attention_decode_kernel(
        q, cache_k, cache_v, block_table, seq_lens, scale, logits_soft_cap)


def paged_attention_decode_partial_plain(q, cache_k, cache_v, block_table, seq_lens,
                                         scale=None, logits_soft_cap=None):
    """The seq-sharded decode's per-shard body (JAX
    ``inference/paged.py:558 _paged_attention_decode_partial``): attention
    over the pages of ``block_table`` that lie in ``[0, nb)`` (the others
    are another shard's, or padding, and are skipped), unnormalized.
    Returns fp32 ``(acc [B, hq, hd], m [B, hq], l [B, hq])``; a slot with no
    key here gives ``(0, -1e30, 0)``."""
    b, hq, hd = q.shape
    nb, bs, hkv, _ = cache_k.shape
    p = block_table.shape[1]
    g = hq // hkv
    owned = (block_table >= 0) & (block_table < nb)  # [B, P]
    safe = torch.where(owned, block_table, 0).long()
    k = cache_k[safe].reshape(b, p * bs, hkv, hd).float()
    v = cache_v[safe].reshape(b, p * bs, hkv, hd).float()
    scale = scale if scale is not None else hd ** -0.5
    qf = q.float().reshape(b, hkv, g, hd)
    logits = torch.einsum("bhgd,bkhd->bhgk", qf, k) * scale
    if logits_soft_cap is not None:
        logits = logits_soft_cap * torch.tanh(logits / logits_soft_cap)
    key_ok = (torch.arange(p * bs, device=q.device)[None, :] < seq_lens[:, None]) \
        & owned.repeat_interleave(bs, dim=1)  # [B, p * bs]
    logits = torch.where(key_ok[:, None, None, :], logits, NEG_INF)
    m = logits.max(dim=-1).values  # NEG_INF where no key lives here
    # a keyless row's exp(NEG_INF - NEG_INF) = 1 must not reach l or acc
    w = torch.where(key_ok[:, None, None, :], torch.exp(logits - m[..., None]), 0.0)
    acc = torch.einsum("bhgk,bkhd->bhgd", w, v)
    return acc.reshape(b, hq, hd), m.reshape(b, hq), w.sum(dim=-1).reshape(b, hq)


def paged_attention_decode_partial(q, cache_k, cache_v, block_table, seq_lens,
                                   scale: Optional[float] = None,
                                   logits_soft_cap: Optional[float] = None):
    """The partial mode on ``q``'s device: the plain body on the CPU, the
    kernel on CUDA."""
    if q.device.type == "cpu":
        return paged_attention_decode_partial_plain(
            q, cache_k, cache_v, block_table, seq_lens, scale, logits_soft_cap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_decode_partial: unsupported device {q.device}")
    return paged_attention_decode_partial_kernel(
        q, cache_k, cache_v, block_table, seq_lens, scale, logits_soft_cap)


def _check(name, q, cache_k, cache_v, block_table, seq_lens):
    """Shapes first (a CPU tensor reaches these checks too), then the
    device, type and layout checks of a CUDA launch."""
    b, hq, hd = q.shape
    nb, bs, hkv, hd_k = cache_k.shape
    if cache_v.shape != cache_k.shape or hd_k != hd:
        raise ValueError(f"{name}: q {tuple(q.shape)} pool {tuple(cache_k.shape)} / "
                         f"{tuple(cache_v.shape)} do not match")
    check_heads(name, hq, hkv, hd)
    if block_table.shape[0] != b or seq_lens.shape != (b,):
        raise ValueError(f"{name}: block_table {tuple(block_table.shape)} / seq_lens "
                         f"{tuple(seq_lens.shape)} do not match batch {b}")
    check_cuda(name, torch.bfloat16, q, cache_k, cache_v)
    check_cuda(name, torch.int32, block_table, seq_lens)
    if block_table.device != q.device:
        raise ValueError(f"{name}: block_table/seq_lens on another device than q")


def paged_attention_decode_kernel(q, cache_k, cache_v, block_table, seq_lens,
                                  scale=None, logits_soft_cap=None):
    """The CUDA kernel wrapper: checks, allocates, launches."""
    _check("paged_attention_decode", q, cache_k, cache_v, block_table, seq_lens)
    b, hq, hd = q.shape
    nb, bs, hkv, _ = cache_k.shape
    out = torch.empty_like(q)
    sc, cap = scalars(scale if scale is not None else hd ** -0.5, logits_soft_cap)
    launch("paged_decode_hd64" if hd == 64 else "paged_decode", ptr(q), ptr(cache_k),
           ptr(cache_v), ptr(block_table), ptr(seq_lens), ptr(out), b, hq, hkv, hd, nb, bs,
           block_table.shape[1], sc, cap)
    return out


def paged_attention_decode_partial_kernel(q, cache_k, cache_v, block_table, seq_lens,
                                          scale=None, logits_soft_cap=None):
    """The partial mode's CUDA wrapper (both head dims count as
    ``paged_decode_partial``): fp32 ``(acc, m, l)``."""
    _check("paged_attention_decode_partial", q, cache_k, cache_v, block_table, seq_lens)
    b, hq, hd = q.shape
    nb, bs, hkv, _ = cache_k.shape
    acc = torch.empty(b, hq, hd, dtype=torch.float32, device=q.device)
    m = torch.empty(b, hq, dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    sc, cap = scalars(scale if scale is not None else hd ** -0.5, logits_soft_cap)
    launch("paged_decode_partial", ptr(q), ptr(cache_k), ptr(cache_v), ptr(block_table),
           ptr(seq_lens), ptr(acc), ptr(m), ptr(l), b, hq, hkv, hd, nb, bs,
           block_table.shape[1], sc, cap)
    return acc, m, l
