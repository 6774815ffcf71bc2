"""Paged KV cache — counterpart of ``deepspeed_tpu/inference/paged.py``.

One block pool per layer, ``[num_blocks, block_size, hkv, hd]``; block
tables map each sequence slot to its pages.  Writes update the pools IN
PLACE (``index_copy_``), which takes the place of JAX buffer donation: the
functions that write return nothing new, the caller's pool tensors hold the
result.  Entries whose page is -1 (or, for decode, whose slot is inactive)
are dropped from a write; which entries survive is decided on the host,
from the host-built page lists, so no write needs a device round trip.

Attention over the pool dispatches to the CUDA kernels on a CUDA tensor and
to the plain bodies on a CPU tensor (``ops/kernels``).  Single device only:
a ``mesh`` / ``dp`` / ``seq_shards`` argument raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.kernels import resolve_device
from ..ops.kernels.ctx_attention import (
    paged_attention_packed_ctx as _packed_ctx_dispatch,
    paged_attention_packed_ctx_plain,
)
from ..ops.kernels.paged_attention import (
    paged_attention_decode as _decode_dispatch,
    paged_attention_decode_plain,
)

# the JAX module's names for the dense ground-truth bodies
_paged_attention_decode_dense = paged_attention_decode_plain
_paged_attention_packed_ctx_dense = paged_attention_packed_ctx_plain


def init_paged_cache(num_layers: int, num_blocks: int, block_size: int,
                     num_kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                     device=None) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """Per-LAYER block pools (a tuple of [num_blocks, bs, hkv, hd] tensors
    for K and one for V), zero-filled, on ``device`` (CUDA unless the caller
    names another; see ``ops.kernels.resolve_device``)."""
    device = resolve_device(device)
    shape = (num_blocks, block_size, num_kv_heads, head_dim)
    k = tuple(torch.zeros(shape, dtype=dtype, device=device) for _ in range(num_layers))
    v = tuple(torch.zeros(shape, dtype=dtype, device=device) for _ in range(num_layers))
    return k, v


# ---------------------------------------------------------------------------
# writes (in place)
# ---------------------------------------------------------------------------
def page_write_index(pages, nb: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """For a host page list ``pages`` [n] (-1 = padding chunk): the chunk
    indices that are written and their destination pages, as device
    tensors.  Out-of-range entries drop, like the JAX scatter's
    ``mode='drop'``."""
    pages = np.asarray(pages, dtype=np.int64).reshape(-1)
    keep = np.nonzero((pages >= 0) & (pages < nb))[0]
    return (torch.from_numpy(keep).to(device),
            torch.from_numpy(pages[keep]).to(device))


def write_pages(cache_layer: torch.Tensor, chunks: torch.Tensor,
                src: torch.Tensor, dst: torch.Tensor) -> None:
    """``cache_layer[dst] = chunks[src]`` in place; chunks [n, bs, hkv, hd]."""
    cache_layer.index_copy_(0, dst, chunks.index_select(0, src).to(cache_layer.dtype))


def write_prefill_kv(cache_layer: torch.Tensor, kv: torch.Tensor, blocks, length=None) -> None:
    """Scatter a prompt's K (or V) [s_pad, hkv, hd] into its pages
    (``blocks`` [n_pages] on the host, -1 padded).  Rows past the prompt's
    length inside its last page hold padding; attention masks them by
    length.  ``length`` is accepted for the JAX signature and not needed."""
    nb, bs = cache_layer.shape[0], cache_layer.shape[1]
    src, dst = page_write_index(blocks, nb, cache_layer.device)
    write_pages(cache_layer, kv.reshape(-1, bs, *kv.shape[1:]), src, dst)


def decode_write_index(block_table, positions, active, bs: int, nb: int,
                       device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Host block table [B, P], positions [B] and active [B] -> (slots that
    write, their flat pool rows ``page * bs + pos % bs``) on ``device``.
    Inactive slots and -1 pages drop."""
    table = np.asarray(block_table)
    pos = np.asarray(positions, dtype=np.int64)
    act = np.asarray(active, dtype=bool)
    slots = np.arange(table.shape[0])
    col = np.minimum(pos // bs, table.shape[1] - 1)
    page = table[slots, col].astype(np.int64)
    keep = np.nonzero(act & (page >= 0) & (page < nb))[0]
    rows = page[keep] * bs + pos[keep] % bs
    return torch.from_numpy(keep).to(device), torch.from_numpy(rows).to(device)


def write_rows(cache_layer: torch.Tensor, kv: torch.Tensor, slots: torch.Tensor,
               rows: torch.Tensor) -> None:
    """One new token per writing slot: ``pool.flat[rows] = kv[slots]`` in
    place; kv [B, hkv, hd]."""
    nb, bs, hkv, hd = cache_layer.shape
    cache_layer.view(nb * bs, hkv, hd).index_copy_(
        0, rows, kv.index_select(0, slots).to(cache_layer.dtype))


def write_decode_kv(cache_layer: torch.Tensor, kv: torch.Tensor, block_table,
                    positions, active) -> None:
    """Scatter one new token per active sequence (host metadata)."""
    nb, bs = cache_layer.shape[0], cache_layer.shape[1]
    slots, rows = decode_write_index(block_table, positions, active, bs, nb,
                                     cache_layer.device)
    write_rows(cache_layer, kv, slots, rows)


def spec_write_index(pages, offsets, bs: int, nb: int,
                     device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Host destination pages / in-page rows [T] of a verify pack (page -1
    = pad row) -> (pack rows that write, their flat pool rows
    ``page * bs + offset``) on ``device``.  Pad rows and out-of-range pages
    drop, like the JAX scatter's out-of-bounds sentinel."""
    pages = np.asarray(pages, dtype=np.int64).reshape(-1)
    offs = np.asarray(offsets, dtype=np.int64).reshape(-1)
    keep = np.nonzero((pages >= 0) & (pages < nb))[0]
    return (torch.from_numpy(keep).to(device),
            torch.from_numpy(pages[keep] * bs + offs[keep]).to(device))


def write_spec_kv(cache_layer: torch.Tensor, kv: torch.Tensor, pages, offsets) -> None:
    """Scatter a speculative verify pack's K (or V) rows [T, hkv, hd] one
    row each to (``pages``, ``offsets``) [T] (host arrays, page -1 = pad
    row, written nowhere).  A verify pack starts MID-PAGE at the decode
    head, where the page-granular ``write_pages`` would overwrite the live
    rows before it; a row scatter is exact."""
    nb, bs = cache_layer.shape[0], cache_layer.shape[1]
    src, dst = spec_write_index(pages, offsets, bs, nb, cache_layer.device)
    write_rows(cache_layer, kv, src, dst)


# ---------------------------------------------------------------------------
# attention over the pool
# ---------------------------------------------------------------------------
def _single_device(mesh, dp: int, seq_shards: int) -> None:
    if mesh is not None or dp != 1 or seq_shards != 1:
        raise NotImplementedError(
            "mesh / dp / seq_shards serving is not ported yet (single device only)")


def paged_attention_decode(q, cache_k_layer, cache_v_layer, block_table, seq_lens,
                           scale: Optional[float] = None,
                           logits_soft_cap: Optional[float] = None, mesh=None,
                           dp: int = 1, seq_shards: int = 1):
    """Single-token attention against paged KV.  q [B, hq, hd]; pools
    [nb, bs, hkv, hd]; block_table [B, P] int32; seq_lens [B] int32 (length
    INCLUDING the current token) -> [B, hq, hd]."""
    _single_device(mesh, dp, seq_shards)
    return _decode_dispatch(q, cache_k_layer, cache_v_layer, block_table, seq_lens,
                            scale=scale, logits_soft_cap=logits_soft_cap)


def paged_attention_packed_ctx(q, k, v, segment_ids, cache_k_layer, cache_v_layer,
                               ctx_tables, ctx_lens, scale: Optional[float] = None,
                               logits_soft_cap: Optional[float] = None, mesh=None,
                               dp: int = 1, seq_shards: int = 1, ctx=None):
    """Packed-prefill attention where each pack segment also attends to its
    slot's cached pages below its start offset (prefix-cache hits, chunked
    prefill).  q/k/v [T, h, hd]; segment_ids [T] (slot + 1, 0 = pad);
    pools WITH this pack's pages already written (masked out by
    ``ctx_lens``); ctx_tables [N, P]; ctx_lens [N] -> [T, hq, hd], pad rows
    0.  ``ctx`` (the serving context) is accepted for the JAX signature."""
    _single_device(mesh, dp, seq_shards)
    return _packed_ctx_dispatch(q, k, v, segment_ids, cache_k_layer, cache_v_layer,
                                ctx_tables, ctx_lens, scale=scale,
                                logits_soft_cap=logits_soft_cap)
