// Packed-suffix attention over cached context pages plus in-pack causal
// keys, on Hopper's tensor cores (wgmma).
//
// Replaces: deepspeed_tpu/ops/pallas/ctx_attention.py
// `paged_attention_packed_ctx_kernel` (:244, the `pl.pallas_call` at :297),
// both modes: partial=False (normalized bf16 output), reached from
// prefix-cache hits, chunked-prefill continuation chunks and verify packs
// (`model_runner.prefill_packed_ctx` / `verify_packed_ctx` ->
// `paged.paged_attention_packed_ctx`), and partial=True (:325), the same
// packs under seq-sharded serving: each seq shard runs it over its own slice
// of the pool and writes the UNnormalized fp32 triple (acc, m, l) that
// `paged._lse_merge_packed` folds across the shards.  `include_pack` = 0
// leaves out phase (b) below (only shard 0 charges the pack's own keys).
//
// What it computes: each pack row of segment n (segment_ids == n + 1)
// attends, in ONE fp32 online softmax, to (a) its slot's cached positions
// [0, ctx_lens[n]) read through ctx_tables[n] -- table ids outside [0, nb)
// are skipped, ctx_lens may end mid-page -- and then (b) the keys of its own
// segment in the pack at or before its row.  Soft cap fused before the mask.
// Rows whose segment id is not in [1, N] (padding) come out exactly 0; in
// the partial mode as (acc 0, m -1e30, l 0), as does a row with no key on
// this shard.  A key tile none of whose keys is valid here (another shard's
// pages, padding) is skipped whole, so a shard's work follows the pages it
// owns.  Segments must be contiguous runs of the pack, in position order
// (the engine's pack assembly guarantees it; the TPU kernel assumes the
// same).
//
// Bound on H100: bytes of the live context pages plus the pack's q/k/v/o at
// short packs; flops (4 * hd per query-key-head) once the pack is long.
// The packs are small (a verify tick's 5 rows a slot, a 64-row suffix), so
// latency and wasted work decide the time.  Design (paged_tc.cuh
// `ctx_attn_kernel`; its key feed, ring and cluster merge are shared with
// paged_decode.cu): a unit is 64 (row, query head) pairs of one
// segment and one kv head, so a verify segment's 5 rows x g heads share one
// tile and read their context once per kv head, and a 64-row suffix at
// g = 4 fills 4 tiles; S = Q K^T and O += P V are wgmma products, the causal
// mask of (b) taken from each pair's row; the context pages are gathered
// row by row by cp.async into a ring, then the pack's keys; a unit's tiles
// are dealt over a cluster of CTAs and merged through distributed shared
// memory.  A CTA finds its unit in one pass over the segment ids (no CTA
// per (row tile, segment) pair), and the CTAs write the pad rows of their
// share of the pack, so the output needs no memset and no extra grid slice.
#include "paged_tc.cuh"

namespace {

// The find_unit scratch (3 N + 1 ints) fits the smallest ring.
constexpr int kMaxSegments = 4096;

bool make_ctx(const void* q, const void* k, const void* v, const int* seg, const void* kpool,
              const void* vpool, const int* tables, const int* ctx_lens, int T, int hq, int hkv,
              int nb, int bs, int N, int P, int include_pack, float scale, float cap,
              dst::PagedArgs* a) {
  if (hkv <= 0 || hq % hkv || T <= 0 || N < 1 || N > kMaxSegments || nb <= 0 || bs <= 0 ||
      P <= 0)
    return false;
  *a = dst::PagedArgs{};
  a->q = static_cast<const dst::bf16*>(q);
  a->k = static_cast<const dst::bf16*>(k);
  a->v = static_cast<const dst::bf16*>(v);
  a->seg = seg;
  a->kpool = static_cast<const dst::bf16*>(kpool);
  a->vpool = static_cast<const dst::bf16*>(vpool);
  a->tables = tables;
  a->lens = ctx_lens;
  a->T = T;
  a->hq = hq;
  a->hkv = hkv;
  a->nb = nb;
  a->bs = bs;
  a->N = N;
  a->P = P;
  a->include_pack = include_pack;
  a->scale = scale;
  a->cap = cap;
  return true;
}

}  // namespace

// q [T, hq, hd], k/v [T, hkv, hd], pools [nb, bs, hkv, hd] bf16; seg [T]
// int32 (slot + 1, 0 = pad); tables [N, P] int32; ctx_lens [N] int32;
// o [T, hq, hd] bf16.  hd 64, 128 or 256, any hkv dividing hq, N <= 4096.
extern "C" int dst_ctx_attention(const void* q, const void* k, const void* v, const int* seg,
                                 const void* kpool, const void* vpool, const int* tables,
                                 const int* ctx_lens, void* o, int T, int hq, int hkv, int hd,
                                 int nb, int bs, int N, int P, float scale, float cap,
                                 void* stream) {
  dst::PagedArgs a;
  if (!make_ctx(q, k, v, seg, kpool, vpool, tables, ctx_lens, T, hq, hkv, nb, bs, N, P, 1,
                scale, cap, &a))
    return cudaErrorInvalidValue;
  a.o = static_cast<dst::bf16*>(o);
  return dst::ctx_attention<false>(a, hd, static_cast<cudaStream_t>(stream));
}

// The partial mode: the same inputs (tables translated to this shard's pool
// slice: ids outside [0, nb) belong to other shards and are skipped);
// acc [T, hq, hd], m [T, hq], l [T, hq] fp32; include_pack 0 / 1.
extern "C" int dst_ctx_attention_partial(const void* q, const void* k, const void* v,
                                         const int* seg, const void* kpool, const void* vpool,
                                         const int* tables, const int* ctx_lens, float* acc,
                                         float* m, float* l, int T, int hq, int hkv, int hd,
                                         int nb, int bs, int N, int P, int include_pack,
                                         float scale, float cap, void* stream) {
  dst::PagedArgs a;
  if (!make_ctx(q, k, v, seg, kpool, vpool, tables, ctx_lens, T, hq, hkv, nb, bs, N, P,
                include_pack, scale, cap, &a))
    return cudaErrorInvalidValue;
  a.acc = acc;
  a.m = m;
  a.l = l;
  return dst::ctx_attention<true>(a, hd, static_cast<cudaStream_t>(stream));
}
