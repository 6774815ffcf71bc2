"""Inference model runner — counterpart of ``deepspeed_tpu/inference/
model_runner.py``: prefill, packed prefill (cold and over cached context),
batched decode and the speculative verify pass against the paged KV pools.

Tensors (parameters, pools) live on the runner's device; the per-dispatch
index metadata (segment ids, positions, page lists, block tables, lengths)
arrives as host arrays (numpy or CPU tensors), built by the engine on the
host anyway.  Which KV rows a prefill or verify dispatch writes is decided
on the host from them, so the in-place pool writes never wait for the
device.  The decode tick's body, ``decode_body``, takes device tensors and
decides its rows on the device, at a fixed shape: a CUDA graph holds it
(the engine's decode bursts), and ``decode_step`` uploads host arrays to
it.  Each function
returns ``(logits fp32, (k_pools, v_pools))`` like the JAX one; the pools
are the caller's tensors, updated in place.

Under a tensor-parallel ``ctx`` (``ops.quantizer.ServingContext.tp``) the
runner takes the rank's local ``cfg`` (its q and kv heads) and its shard
of the tree: the attention runs on the local heads against a pool of the
local kv heads, the row-parallel ``wo`` / ``w_down`` reduce their partial
sums over ``model`` in ``serving_mm``, and the logits gather the vocab
shards.

Attention goes through the CUDA kernels on a CUDA device (flash prefill,
paged decode, packed-context) and through their plain bodies on the CPU;
so do the matmuls of a quantized tree (``serving_mm``: the dequant-matmul
kernels).  ``seq_shards > 1`` (seq-sharded serving) sends the decode,
context and verify dispatches through the partial kernels and their
log-sum-exp merge (``paged.py``); a cold pack attends densely on the flash
kernel and has no ring, as in JAX.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from ..models.transformer import (
    TransformerConfig,
    _activation,
    apply_rope,
    head_bias_vec,
    head_kernel,
    norm,
    rope_tables,
)
from ..moe.layer import moe_block_dropless
from ..ops.kernels.flash_attention import flash_attention
from ..ops.quantizer import QUANT_TYPES, map_quant, serving_mm
from .paged import (
    decode_rows,
    page_write_index,
    paged_attention_decode,
    paged_attention_packed_ctx,
    seq_shard_tables,
    spec_write_index,
    write_decode_rows,
    write_pages,
    write_rows,
)

Params = Any


def _layer(params: Params, l: int) -> Params:
    """Layer ``l``'s weights: views into the stacked [L, ...] tensors (a
    quantized leaf slices its payload and its per-layer scales)."""
    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, QUANT_TYPES):
            return map_quant(x, lambda t: t[l])
        return x[l]

    return take(params["layers"])


def _dev(x, device, dtype=torch.int32) -> torch.Tensor:
    """Host metadata -> device tensor."""
    return torch.as_tensor(np.asarray(x), dtype=dtype).to(device)


def _shard_tables(tables, kv_cache, seq_shards: int):
    """Per-seq-shard translated tables, once per dispatch for every layer
    (None on one shard)."""
    if seq_shards == 1:
        return None
    return seq_shard_tables(tables, kv_cache[0][0].shape[0], seq_shards)


def _qkv(lw, x, cfg: TransformerConfig, ctx=None):
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = serving_mm(x, lw["wq"], lw.get("bq") if cfg.qkv_bias else None, ctx=ctx)
    k = serving_mm(x, lw["wk"], lw.get("bk") if cfg.qkv_bias else None, ctx=ctx)
    v = serving_mm(x, lw["wv"], lw.get("bv") if cfg.qkv_bias else None, ctx=ctx)
    return q.reshape(b, s, hq, hd), k.reshape(b, s, hkv, hd), v.reshape(b, s, hkv, hd)


def _ffn(lw, x, cfg, ctx=None):
    if cfg.moe_num_experts > 0:
        # dropless at inference: capacity competition would make routing
        # depend on batch padding (JAX model_runner._ffn); the experts stay
        # unquantized, as JAX's quantizer leaves them
        return moe_block_dropless(lw["moe"], x, cfg)[0]
    mlp = lw["mlp"]
    act = _activation(cfg.activation)
    up = serving_mm(x, mlp["w_up"], mlp.get("b_up"), ctx=ctx)
    if cfg.gated_mlp:
        h = act(serving_mm(x, mlp["w_gate"], mlp.get("b_gate"), ctx=ctx)) * up
    else:
        h = act(up)
    return serving_mm(h, mlp["w_down"], mlp.get("b_down"), kind="row", ctx=ctx)


def _attn_out(lw, x, ctx=None):
    return serving_mm(x, lw["wo"], lw.get("bo"), kind="row", ctx=ctx)


def _lm_logits(params, cfg, x, ctx=None):
    """fp32 logits [..., vocab]; a tensor-parallel rank computes its vocab
    shard (a tied head reads its rows of the whole table) and gathers the
    others' (every rank then holds the same logits)."""
    tp = ctx.tp if ctx is not None else None
    if tp is None or not tp.vocab_sharded:
        return serving_mm(x, head_kernel(params, cfg), head_bias_vec(params), ctx=ctx).float()
    w = (tp.head_rows(params["embed"]["embedding"]).t().to(cfg.dtype) if cfg.tie_embeddings
         else params["lm_head"]["kernel"])
    return tp.gather_vocab(serving_mm(x, w, head_bias_vec(params)).float())


def _embed(params, cfg, tokens, positions):
    """Token (+ learned position) embedding (+ embedding norm), [.., d]."""
    x = params["embed"]["embedding"][tokens].to(cfg.dtype)
    if cfg.position == "learned":
        x = x + params["pos_embed"]["embedding"][
            positions.clamp(0, cfg.max_seq_len - 1)].to(cfg.dtype)
    if cfg.embedding_norm:
        x = norm(x, params["embed_norm"], cfg.norm, cfg.norm_eps)
    return x


def _check_family(cfg: TransformerConfig) -> None:
    """The reference's v2 engine refuses ALiBi and parallel-block models by
    design and serves them through its dense v1 engine ``init_inference``
    (``inference/engine.py``), as JAX does."""
    if cfg.position == "alibi":
        raise NotImplementedError(
            "InferenceEngineV2 cannot serve position='alibi' models: the paged decode "
            "kernel has no additive positional-bias operand — use init_inference "
            "(deepspeed_tpu_torch.inference.init_inference, the dense v1 engine) instead")
    if cfg.parallel_block:
        raise NotImplementedError(
            "InferenceEngineV2 cannot serve parallel_block models (falcon/gptj/phi "
            "layout): the runner wires sequential attn_norm/mlp_norm blocks — use "
            "init_inference (deepspeed_tpu_torch.inference.init_inference, the dense "
            "v1 engine) instead")


def _block(lw, x, cfg, rot, attend, ctx):
    """One decoder layer around an attention callback: attend(q, k, v)
    writes this layer's KV and returns the attention output [b, s, hq, hd]."""
    h = norm(x, lw["attn_norm"], cfg.norm, cfg.norm_eps)
    q, k, v = _qkv(lw["attn"], h, cfg, ctx)
    if rot is not None:
        q, k = apply_rope(q, *rot), apply_rope(k, *rot)
    attn = attend(q, k, v)
    b, s = x.shape[:2]
    x = x + _attn_out(lw["attn"], attn.reshape(b, s, -1), ctx).to(x.dtype)
    h = norm(x, lw["mlp_norm"], cfg.norm, cfg.norm_eps)
    return x + _ffn(lw, h, cfg, ctx).to(x.dtype)


def prefill(params: Params, cfg: TransformerConfig, tokens, length, blocks,
            kv_cache: Tuple, ctx=None):
    """One prompt (padded to a page multiple): run it, write its KV pages
    (``blocks`` [n_pages], -1 padded), return (logits at ``length - 1``,
    caches)."""
    _check_family(cfg)
    ck, cv = kv_cache
    device = ck[0].device
    tokens = _dev(tokens, device, torch.long)
    s = tokens.shape[0]
    positions = torch.arange(s, device=device)
    x = _embed(params, cfg, tokens, positions)[None]
    rot = rope_tables(positions, cfg.hd, cfg.rope_theta) if cfg.position == "rope" else None
    nb, bs = ck[0].shape[:2]
    src, dst = page_write_index(blocks, nb, device)
    for l in range(cfg.num_layers):
        def attend(q, k, v, l=l):
            write_pages(ck[l], k[0].reshape(-1, bs, *k.shape[2:]), src, dst)
            write_pages(cv[l], v[0].reshape(-1, bs, *v.shape[2:]), src, dst)
            return flash_attention(q, k, v, causal=True,
                                   logits_soft_cap=cfg.logits_soft_cap)
        x = _block(_layer(params, l), x, cfg, rot, attend, ctx)
    x = norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    last = x[0, min(max(int(length) - 1, 0), s - 1)]
    return _lm_logits(params, cfg, last, ctx), kv_cache


def _packed(params, cfg, tokens, segment_ids, positions, pack_pages, last_idx,
            kv_cache, ctx, attention):
    """Shared body of the packed prefills: embed, per layer write the pack's
    KV pages (page-granular: every segment starts page-aligned) and attend,
    then logits at each segment's last row."""
    _check_family(cfg)
    ck, cv = kv_cache
    device = ck[0].device
    tok = _dev(tokens, device, torch.long)
    pos = _dev(positions, device, torch.long)
    t = tok.shape[0]
    x = _embed(params, cfg, tok, pos)[None]
    rot = rope_tables(pos, cfg.hd, cfg.rope_theta) if cfg.position == "rope" else None
    nb, bs = ck[0].shape[:2]
    src, dst = page_write_index(pack_pages, nb, device)
    seg = _dev(segment_ids, device)
    for l in range(cfg.num_layers):
        def attend(q, k, v, l=l):
            write_pages(ck[l], k[0].reshape(t // bs, bs, *k.shape[2:]), src, dst)
            write_pages(cv[l], v[0].reshape(t // bs, bs, *v.shape[2:]), src, dst)
            return attention(q, k, v, seg, ck[l], cv[l])
        x = _block(_layer(params, l), x, cfg, rot, attend, ctx)
    x = norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    last = x[0, _dev(np.clip(np.asarray(last_idx), 0, t - 1), device, torch.long)]
    return _lm_logits(params, cfg, last, ctx), kv_cache


def prefill_packed(params: Params, cfg: TransformerConfig, tokens, segment_ids,
                   positions, pack_pages, last_idx, kv_cache: Tuple, ctx=None):
    """Several prompts packed at PAGE-aligned starts under one token budget
    (``tokens``/``segment_ids``/``positions`` [T], ``pack_pages`` [T/bs]
    destination page per bs-chunk, -1 pad; ``last_idx`` [N] each prompt's
    last row, -1 pad).  Cross-prompt attention is blocked by the segment
    mask of the flash kernel.  Returns (logits [N, vocab], caches)."""
    def attention(q, k, v, seg, ck, cv):
        return flash_attention(q, k, v, causal=True, segment_ids=seg[None],
                               logits_soft_cap=cfg.logits_soft_cap)

    return _packed(params, cfg, tokens, segment_ids, positions, pack_pages,
                   last_idx, kv_cache, ctx, attention)


def prefill_packed_ctx(params: Params, cfg: TransformerConfig, tokens, segment_ids,
                       positions, pack_pages, last_idx, ctx_tables, ctx_lens,
                       kv_cache: Tuple, ctx=None, mesh=None, dp: int = 1,
                       seq_shards: int = 1):
    """``prefill_packed`` over token SUFFIXES: each segment also attends to
    its slot's cached pages below its start (``ctx_tables`` [N, P],
    ``ctx_lens`` [N]); ``positions`` are absolute.  Prefix-cache hits and
    chunked-prefill continuation chunks ride this."""
    device = kv_cache[0][0].device
    tables = _dev(ctx_tables, device)
    lens = _dev(ctx_lens, device)
    shards = _shard_tables(tables, kv_cache, seq_shards)

    def attention(q, k, v, seg, ck, cv):
        # the pool already holds this pack's pages; ctx_lens masks them
        return paged_attention_packed_ctx(
            q[0], k[0], v[0], seg, ck, cv, tables, lens,
            logits_soft_cap=cfg.logits_soft_cap, mesh=mesh, dp=dp,
            seq_shards=seq_shards, shard_tables=shards)

    return _packed(params, cfg, tokens, segment_ids, positions, pack_pages,
                   last_idx, kv_cache, ctx, attention)


def verify_packed_ctx(params: Params, cfg: TransformerConfig, tokens, segment_ids,
                      positions, dst_pages, dst_offs, ctx_tables, ctx_lens,
                      kv_cache: Tuple, ctx=None, mesh=None, dp: int = 1,
                      seq_shards: int = 1):
    """Speculative verify: score k + 1 positions per sequence in ONE pass.
    Each slot's pack segment is [its last committed token, its drafts] at
    consecutive absolute ``positions`` (``tokens`` / ``segment_ids`` /
    ``positions`` / ``dst_pages`` / ``dst_offs`` [T], pad rows segment 0 and
    page -1); ``ctx_tables`` [N, P], ``ctx_lens`` [N] the committed
    (KV-written) length per slot, which ends mid-page.

    Attention is the packed-context kernel's: one softmax over the cached
    context and the in-pack causal drafts.  Unlike ``prefill_packed_ctx``,
    the pack's KV is written row by row (``write_spec_kv``: the pack starts
    mid-page), and logits come back for EVERY pack row (each verifies the
    next draft or samples the correction / bonus token).  KV rows of
    rejected drafts stay behind, masked by length and overwritten as the
    sequence grows.  Returns (logits [T, vocab] fp32, caches)."""
    _check_family(cfg)
    ck, cv = kv_cache
    device = ck[0].device
    tok = _dev(tokens, device, torch.long)
    pos = _dev(positions, device, torch.long)
    x = _embed(params, cfg, tok, pos)[None]
    rot = rope_tables(pos, cfg.hd, cfg.rope_theta) if cfg.position == "rope" else None
    nb, bs = ck[0].shape[:2]
    src, dst = spec_write_index(dst_pages, dst_offs, bs, nb, device)
    seg = _dev(segment_ids, device)
    tables = _dev(ctx_tables, device)
    lens = _dev(ctx_lens, device)
    shards = _shard_tables(tables, kv_cache, seq_shards)
    for l in range(cfg.num_layers):
        def attend(q, k, v, l=l):
            write_rows(ck[l], k[0], src, dst)
            write_rows(cv[l], v[0], src, dst)
            # ctx_lens masks the rows just written; they enter through the
            # in-pack causal half
            return paged_attention_packed_ctx(
                q[0], k[0], v[0], seg, ck[l], cv[l], tables, lens,
                logits_soft_cap=cfg.logits_soft_cap, mesh=mesh, dp=dp,
                seq_shards=seq_shards, shard_tables=shards)
        x = _block(_layer(params, l), x, cfg, rot, attend, ctx)
    x = norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    return _lm_logits(params, cfg, x[0], ctx), kv_cache


def decode_body(params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
                seq_lens: torch.Tensor, block_tables: torch.Tensor, active: torch.Tensor,
                kv_cache: Tuple, ctx=None, mesh=None, dp: int = 1, seq_shards: int = 1):
    """One batched decode tick on device tensors: ``tokens`` [B] the last
    sampled token per slot, ``seq_lens`` [B] int32 the length BEFORE this
    token, ``block_tables`` [B, P] int32, ``active`` [B] bool, all on the
    pools' device.  Reads nothing back to the host (the KV write's rows come
    from ``paged.decode_rows``), so a CUDA graph can hold it: the engine's
    per-tick ``step()`` and its decode bursts both run it.  Returns (logits
    [B, vocab] fp32, caches)."""
    _check_family(cfg)
    ck, cv = kv_cache
    nb, bs = ck[0].shape[:2]
    pos = seq_lens.long()
    x = _embed(params, cfg, tokens.long(), pos)[:, None]  # [B, 1, d]
    rot = rope_tables(pos[:, None], cfg.hd, cfg.rope_theta) if cfg.position == "rope" else None
    rows = decode_rows(block_tables, pos, active, bs, nb)
    lens_after = seq_lens + 1  # attention length incl. this token
    shards = _shard_tables(block_tables, kv_cache, seq_shards)
    for l in range(cfg.num_layers):
        def attend(q, k, v, l=l):
            write_decode_rows(ck[l], k[:, 0], rows)
            write_decode_rows(cv[l], v[:, 0], rows)
            return paged_attention_decode(
                q[:, 0], ck[l], cv[l], block_tables, lens_after,
                logits_soft_cap=cfg.logits_soft_cap, mesh=mesh, dp=dp,
                seq_shards=seq_shards, shard_tables=shards)
        x = _block(_layer(params, l), x, cfg, rot, attend, ctx)
    x = norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    return _lm_logits(params, cfg, x[:, 0], ctx), kv_cache


def decode_step(params: Params, cfg: TransformerConfig, tokens, seq_lens,
                block_tables, active, kv_cache: Tuple, ctx=None, mesh=None,
                dp: int = 1, seq_shards: int = 1):
    """One batched decode tick from host arrays: ``tokens`` [B] last sampled
    token per slot, ``seq_lens`` [B] length BEFORE this token,
    ``block_tables`` [B, P], ``active`` [B]; uploaded, then ``decode_body``.
    Returns (logits [B, vocab], caches)."""
    device = kv_cache[0][0].device
    return decode_body(params, cfg, _dev(tokens, device), _dev(seq_lens, device),
                       _dev(block_tables, device), _dev(active, device, torch.bool),
                       kv_cache, ctx=ctx, mesh=mesh, dp=dp, seq_shards=seq_shards)
