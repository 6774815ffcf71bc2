"""Paged KV cache — counterpart of ``deepspeed_tpu/inference/paged.py``.

One block pool per layer, ``[num_blocks, block_size, hkv, hd]``; block
tables map each sequence slot to its pages.  Writes update the pools IN
PLACE (``index_copy_``), which takes the place of JAX buffer donation: the
functions that write return nothing new, the caller's pool tensors hold the
result.  Entries whose page is -1 (or, for decode, whose slot is inactive)
are dropped from a write.  For prefill and verify packs, which entries
survive is decided on the host, from the host-built page lists.  The
decode write is decided on the device, at a fixed shape, so a CUDA graph
can hold it (``decode_rows``): JAX scatters a dropped slot to an
out-of-bounds sentinel that its scatter drops; PyTorch has no dropping
scatter, so each pool's storage holds one spare row per slot past its
``nb * bs`` rows (``init_paged_cache(max_seqs=...)``), and dropped slot
``b`` writes its own spare row ``nb * bs + b``.  No two slots share a
target, and no dropped slot touches a real row.

Attention over the pool dispatches to the CUDA kernels on a CUDA tensor and
to the plain bodies on a CPU tensor (``ops/kernels``).

Tensor-parallel serving (JAX's ``_paged_attention_packed_ctx_tp``,
``:203-325``, and ``_paged_attention_decode_tp``, ``:593-695``): a rank of
the ``model`` axis is its own process, so its attention region is the
plain call on its own heads.  Its pool holds the kv heads JAX's
``kv_pool_pspec`` (``:516``) gives it -- a ``1 / tp`` slice when ``tp``
divides the kv heads -- and, where it does not, the kv head its q heads
read, which JAX's replicated pool leaves each rank to pick
(``narrow_kv``, ``:260-283``): the rank computes only that head
(``parallel.tensor_parallel.TensorParallel.serving_placement``).  K3 /
K2 take the local q heads against it as any query group.

Seq-sharded serving (``seq_shards = S > 1``, JAX's ``_paged_attention_
decode_tp`` / ``_paged_attention_packed_ctx_tp`` at one replica and no
tensor parallelism): the pool's block dim splits into ``S`` contiguous
slices and a sequence's pages stripe across them (``ragged.StateManager``).
Shard ``s`` attends over its slice only -- the pool view
``pool[s*nbl:(s+1)*nbl]``, its tables translated by ``-s*nbl`` so another
shard's pages fall outside ``[0, nbl)`` and are skipped -- with the partial
modes of the decode and packed-context kernels, which return the
unnormalized fp32 ``(acc, m, l)``.  The ``S`` partials then fold by
log-sum-exp in the order JAX's ``S-1``-hop ring leaves them on shard 0.
Here the shards run in one process on one device, so a shard's slice is a
view of the one pool and page writes and copy-on-write keep their global
block ids; placing the shards on separate devices is ROADMAP queue 1
item 7 (a ``mesh`` with ``model > 1`` or ``dp > 1`` raises: seq shards
with a model axis stay refused).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.kernels import resolve_device
from ..ops.kernels.ctx_attention import (
    paged_attention_packed_ctx as _packed_ctx_dispatch,
    paged_attention_packed_ctx_partial,
    paged_attention_packed_ctx_partial_plain,
    paged_attention_packed_ctx_plain,
)
from ..ops.kernels.paged_attention import (
    paged_attention_decode as _decode_dispatch,
    paged_attention_decode_partial,
    paged_attention_decode_partial_plain,
    paged_attention_decode_plain,
)

# the JAX module's names for the dense ground-truth bodies and the partials
_paged_attention_decode_dense = paged_attention_decode_plain
_paged_attention_packed_ctx_dense = paged_attention_packed_ctx_plain
_paged_attention_decode_partial = paged_attention_decode_partial_plain
_packed_ctx_partial = paged_attention_packed_ctx_partial_plain


def init_paged_cache(num_layers: int, num_blocks: int, block_size: int,
                     num_kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                     device=None, max_seqs: int = 64
                     ) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """Per-LAYER block pools (a tuple of [num_blocks, bs, hkv, hd] tensors
    for K and one for V), zero-filled, on ``device`` (CUDA unless the caller
    names another; see ``ops.kernels.resolve_device``).  Each pool's storage
    holds ``max_seqs`` spare rows past its end: the drop rows of a decode
    write over up to ``max_seqs`` slots (``write_decode_rows``)."""
    device = resolve_device(device)
    rows = num_blocks * block_size

    def pool():
        flat = torch.zeros(rows + max_seqs, num_kv_heads, head_dim, dtype=dtype, device=device)
        return flat[:rows].view(num_blocks, block_size, num_kv_heads, head_dim)

    return (tuple(pool() for _ in range(num_layers)),
            tuple(pool() for _ in range(num_layers)))


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


def write_rows(cache_layer: torch.Tensor, kv: torch.Tensor, slots: torch.Tensor,
               rows: torch.Tensor) -> None:
    """One new token per writing slot: ``pool.flat[rows] = kv[slots]`` in
    place; kv [B, hkv, hd]."""
    nb, bs, hkv, hd = cache_layer.shape
    cache_layer.view(nb * bs, hkv, hd).index_copy_(
        0, rows, kv.index_select(0, slots).to(cache_layer.dtype))


def write_decode_kv(cache_layer: torch.Tensor, kv: torch.Tensor, block_table,
                    positions, active) -> None:
    """Scatter one new token per active sequence (JAX's signature; any
    pool): ``decode_rows``'s rows, the dropped slots left out on the host."""
    nb, bs = cache_layer.shape[0], cache_layer.shape[1]
    dev = cache_layer.device
    rows = decode_rows(torch.as_tensor(np.asarray(block_table), device=dev),
                       torch.as_tensor(np.asarray(positions), device=dev),
                       torch.as_tensor(np.asarray(active), device=dev), bs, nb)
    slots = torch.nonzero(rows < nb * bs)[:, 0]
    write_rows(cache_layer, kv, slots, rows[slots])


def decode_rows(block_table: torch.Tensor, positions: torch.Tensor, active: torch.Tensor,
                bs: int, nb: int) -> torch.Tensor:
    """The decode write's target rows on the device, one per slot, at a
    fixed shape (JAX ``write_decode_kv``'s rule): block table [B, P],
    positions [B] and active [B] -> [B] flat pool rows ``page * bs + pos %
    bs``; an inactive slot, or one whose page is -1 or past the pool, gets
    its own drop row ``nb * bs + b``.  Reads nothing back to the host."""
    b, p = block_table.shape
    pos = positions.long()
    col = torch.clamp(pos // bs, max=p - 1)
    page = block_table.long().gather(1, col[:, None])[:, 0]
    keep = active & (page >= 0) & (page < nb)
    drop = nb * bs + torch.arange(b, device=block_table.device)
    return torch.where(keep, page * bs + pos % bs, drop)


def write_decode_rows(cache_layer: torch.Tensor, kv: torch.Tensor, rows: torch.Tensor) -> None:
    """``pool.flat[rows] = kv`` in place over the pool's rows AND its spare
    rows (``init_paged_cache``), kv [B, hkv, hd]: the fixed-shape decode
    write, ``rows`` from ``decode_rows``.  Raises if the pool's storage
    holds fewer than B spare rows."""
    nb, bs, hkv, hd = cache_layer.shape
    n = nb * bs + kv.shape[0]
    have = cache_layer.untyped_storage().nbytes() // cache_layer.element_size() \
        - cache_layer.storage_offset()
    if not cache_layer.is_contiguous() or have < n * hkv * hd:
        raise ValueError(f"the pool holds {have // (hkv * hd) - nb * bs} spare rows, the "
                         f"decode write needs {kv.shape[0]}: build it with "
                         f"init_paged_cache(max_seqs={kv.shape[0]})")
    flat = cache_layer.as_strided((n, hkv, hd), (hkv * hd, hd, 1))
    flat.index_copy_(0, rows, kv.to(cache_layer.dtype))


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
def _single_device(mesh, dp: int) -> None:
    """What the seq-shard mesh runs: one replica, no model axis beside the
    seq shards of a grid's ``seq`` axis on its one device (a tensor-parallel
    rank attends over its own heads with no mesh)."""
    tp = mesh.spec.model if mesh is not None else 1
    if tp > 1 or dp != 1:
        raise NotImplementedError(
            f"seq shards with a model axis (model {tp}) / replicas (dp {dp}) are not ported "
            "yet (ROADMAP queue 1 item 7)")


def seq_shard_tables(block_table: torch.Tensor, num_blocks: int,
                     seq_shards: int) -> List[torch.Tensor]:
    """``block_table`` translated for each seq shard of a pool of
    ``num_blocks`` (JAX ``paged.py:296-299``, ``:660-669``): shard ``s``'s
    table holds ``bt - s * nbl`` (-1 stays -1), so only its own pages land
    in ``[0, nbl)``.  One translation per dispatch serves every layer."""
    nbl = num_blocks // seq_shards
    return [torch.where(block_table >= 0, block_table - s * nbl, -1) for s in range(seq_shards)]


def _shard_views(pool: torch.Tensor, seq_shards: int) -> List[torch.Tensor]:
    """Seq shard ``s``'s slice ``pool[s*nbl:(s+1)*nbl]``: a view, not a copy."""
    nbl = pool.shape[0] // seq_shards
    return [pool[s * nbl:(s + 1) * nbl] for s in range(seq_shards)]


def _check_seq_shards(pool: torch.Tensor, seq_shards: int) -> None:
    if pool.shape[0] % seq_shards:
        raise ValueError(f"{seq_shards} seq shards must divide the block pool "
                         f"({pool.shape[0]})")


def _lse_merge(a, b):
    """Log-sum-exp combine of two flash partials ``(acc, m, l)``; rows with
    no key anywhere stay ``(0, -1e30, 0)``."""
    acc_a, m_a, l_a = a
    acc_b, m_b, l_b = b
    m = torch.maximum(m_a, m_b)
    wa = torch.exp(m_a - m)
    wb = torch.exp(m_b - m)
    return acc_a * wa[..., None] + acc_b * wb[..., None], m, l_a * wa + l_b * wb


def _lse_merge_packed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """JAX ``paged.py:542``: ``_lse_merge`` on packed partials
    ``[..., hd + 2]`` = ``concat([acc, m, l], -1)``."""
    acc, m, l = _lse_merge((a[..., :-2], a[..., -2], a[..., -1]),
                           (b[..., :-2], b[..., -2], b[..., -1]))
    return torch.cat([acc, m[..., None], l[..., None]], dim=-1)


def merge_partials(parts, dtype: torch.dtype) -> torch.Tensor:
    """The ``S`` shards' partials -> the normalized output.  The fold is the
    one JAX's ring leaves on shard 0 (each hop: ``merge(received, mine)``):
    shard 1's partial, merged with shards 2 .. S-1 in turn, then with shard
    0's.  Divides by ``max(l, 1e-30)`` (a keyless row gives 0) and casts."""
    c = parts[1]
    for mine in (*parts[2:], parts[0]):
        c = _lse_merge(c, mine)
    acc, _, l = c
    return (acc / l.clamp_min(1e-30)[..., None]).to(dtype)


def paged_attention_decode(q, cache_k_layer, cache_v_layer, block_table, seq_lens,
                           scale: Optional[float] = None,
                           logits_soft_cap: Optional[float] = None, mesh=None,
                           dp: int = 1, seq_shards: int = 1,
                           shard_tables: Optional[List[torch.Tensor]] = None):
    """Single-token attention against paged KV.  q [B, hq, hd]; pools
    [nb, bs, hkv, hd]; block_table [B, P] int32; seq_lens [B] int32 (length
    INCLUDING the current token) -> [B, hq, hd].  With ``seq_shards > 1``
    each shard's partial runs over its pool slice and the partials merge;
    ``shard_tables`` (``seq_shard_tables``) saves the per-call
    translation."""
    _single_device(mesh, dp)
    if seq_shards == 1:
        return _decode_dispatch(q, cache_k_layer, cache_v_layer, block_table, seq_lens,
                                scale=scale, logits_soft_cap=logits_soft_cap)
    _check_seq_shards(cache_k_layer, seq_shards)
    if shard_tables is None:
        shard_tables = seq_shard_tables(block_table, cache_k_layer.shape[0], seq_shards)
    parts = [paged_attention_decode_partial(q, ck, cv, bt, seq_lens, scale=scale,
                                            logits_soft_cap=logits_soft_cap)
             for ck, cv, bt in zip(_shard_views(cache_k_layer, seq_shards),
                                   _shard_views(cache_v_layer, seq_shards), shard_tables)]
    return merge_partials(parts, q.dtype)


def paged_attention_packed_ctx(q, k, v, segment_ids, cache_k_layer, cache_v_layer,
                               ctx_tables, ctx_lens, scale: Optional[float] = None,
                               logits_soft_cap: Optional[float] = None, mesh=None,
                               dp: int = 1, seq_shards: int = 1, ctx=None,
                               shard_tables: Optional[List[torch.Tensor]] = None):
    """Packed-prefill attention where each pack segment also attends to its
    slot's cached pages below its start offset (prefix-cache hits, chunked
    prefill).  q/k/v [T, h, hd]; segment_ids [T] (slot + 1, 0 = pad);
    pools WITH this pack's pages already written (masked out by
    ``ctx_lens``); ctx_tables [N, P]; ctx_lens [N] -> [T, hq, hd], pad rows
    0.  With ``seq_shards > 1`` each shard's partial covers its own pages,
    the pack's own keys are charged to shard 0 only, and the partials
    merge.  ``ctx`` (the serving context) is accepted for the JAX
    signature."""
    _single_device(mesh, dp)
    if seq_shards == 1:
        return _packed_ctx_dispatch(q, k, v, segment_ids, cache_k_layer, cache_v_layer,
                                    ctx_tables, ctx_lens, scale=scale,
                                    logits_soft_cap=logits_soft_cap)
    _check_seq_shards(cache_k_layer, seq_shards)
    if shard_tables is None:
        shard_tables = seq_shard_tables(ctx_tables, cache_k_layer.shape[0], seq_shards)
    parts = [paged_attention_packed_ctx_partial(
        q, k, v, segment_ids, ck, cv, bt, ctx_lens, include_pack=(s == 0), scale=scale,
        logits_soft_cap=logits_soft_cap)
        for s, (ck, cv, bt) in enumerate(zip(_shard_views(cache_k_layer, seq_shards),
                                             _shard_views(cache_v_layer, seq_shards),
                                             shard_tables))]
    return merge_partials(parts, q.dtype)
