// Packed-suffix attention over cached context pages plus in-pack causal keys.
//
// Replaces: deepspeed_tpu/ops/pallas/ctx_attention.py
// `paged_attention_packed_ctx_kernel` (the `pl.pallas_call` at :297), both
// modes: partial=False (normalized bf16 output), reached from prefix-cache
// hits, chunked-prefill continuation chunks and verify packs
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
// this shard.  A key tile none of whose pages is valid here (another shard's
// pages, padding) is skipped whole, so a shard's work follows the pages it
// owns.
// Segments must be contiguous runs of the pack, in position order (the
// engine's pack builder guarantees it; the TPU kernel assumes the same).
//
// Bound on H100: bytes of the live context pages plus the pack's q/k/v/o at
// short packs; flops (4 * hd per query-key-head) once the pack is long.
// The TPU kernel carries one (m, l, acc) triple across a sequential grid;
// CTAs here run in no order, so each CTA owns its rows' whole reduction:
// one CTA per (row tile of 16 / g rows of one segment, kv head, segment),
// looping over the segment's context pages and then its in-pack keys
// (attn_common.cuh).  Each CTA finds its segment's first row and length
// from segment_ids itself (a pass over T ids), and an extra z-slice of CTAs
// writes the zero pad rows, so the output needs no memset.  CUDA-core fp32
// arithmetic: the simple first version.
#include "attn_common.cuh"

namespace dst {

constexpr int kPPW = 4;  // 16 pairs per CTA: more CTAs over a short pack
constexpr int kMaxPairs = kWarps * kPPW;

// Where a CTA writes: the normalized bf16 rows (o), or the partial triple.
struct CtxOut {
  bf16* o;
  float* acc;
  float* m;
  float* l;
};

template <int HD, bool PARTIAL>
__global__ void __launch_bounds__(kThreads)
ctx_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ seg,
                     const bf16* __restrict__ kpool, const bf16* __restrict__ vpool,
                     const int* __restrict__ tables, const int* __restrict__ ctx_lens,
                     CtxOut out, int T, int hq, int hkv, int nb, int bs, int N, int P,
                     int include_pack, float scale, float cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_start, s_len;
  __shared__ int kvalid[kKeyTile];
  const Smem<HD> sm(smem_raw, kMaxPairs);
  const int g = hq / hkv;
  const int bm = kMaxPairs / g;
  const int h = blockIdx.y, n = blockIdx.z;
  const size_t qstride = static_cast<size_t>(hq) * HD;
  const size_t kstride = static_cast<size_t>(hkv) * HD;

  if (n == N) {  // pad rows of this kv head's query heads: exactly 0 / (0, -1e30, 0)
    const int row0 = blockIdx.x * bm;
    const int rows = min(bm, T - row0);
    for (int idx = threadIdx.x; idx < rows * g * HD; idx += blockDim.x) {
      const int r = row0 + idx / (g * HD);
      const int id = seg[r];
      if (id >= 1 && id <= N) continue;
      const size_t off = r * qstride + h * g * HD + idx % (g * HD);
      if (PARTIAL) {
        out.acc[off] = 0.f;
      } else {
        out.o[off] = __float2bfloat16(0.f);
      }
    }
    if (PARTIAL) {
      for (int idx = threadIdx.x; idx < rows * g; idx += blockDim.x) {
        const int r = row0 + idx / g;
        const int id = seg[r];
        if (id >= 1 && id <= N) continue;
        const size_t off = static_cast<size_t>(r) * hq + h * g + idx % g;
        out.m[off] = kNegInf;
        out.l[off] = 0.f;
      }
    }
    return;
  }

  if (threadIdx.x == 0) {
    s_start = T;
    s_len = 0;
  }
  __syncthreads();
  int lo = T, cnt = 0;
  for (int r = threadIdx.x; r < T; r += blockDim.x) {
    if (seg[r] == n + 1) {
      lo = min(lo, r);
      ++cnt;
    }
  }
  if (cnt) {
    atomicMin(&s_start, lo);
    atomicAdd(&s_len, cnt);
  }
  __syncthreads();
  const int start = s_start, slen = s_len;
  const int row0 = start + blockIdx.x * bm;
  const int nrows = min(bm, start + slen - row0);
  if (nrows <= 0) return;
  const int npairs = nrows * g;
  load_q<HD>(sm.q, npairs, scale, [&](int p) {
    return q + (row0 + p / g) * qstride + (h * g + p % g) * HD;
  });

  PairState<HD, kPPW> st;
  st.init();
  // (a) cached context of the slot, through its page table
  const int ctx_len = min(ctx_lens[n], P * bs);
  const int* row = tables + static_cast<size_t>(n) * P;
  for (int j0 = 0; j0 < ctx_len; j0 += kKeyTile) {
    __syncthreads();  // previous tile consumed; q written on the first pass
    int page = -1;
    if (threadIdx.x < kKeyTile) {
      const int pos = j0 + threadIdx.x;
      page = pos < ctx_len ? row[pos / bs] : -1;
      if (page >= nb) page = -1;
      kvalid[threadIdx.x] = page;
    }
    if (!__syncthreads_or(page >= 0)) continue;  // no key of this tile lives here
    load_tile<HD>(sm, [&](int t, const bf16** kp, const bf16** vp) {
      const int pg = kvalid[t];
      if (pg < 0) return false;
      const size_t off = ((static_cast<size_t>(pg) * bs + (j0 + t) % bs) * hkv + h) * HD;
      *kp = kpool + off;
      *vp = vpool + off;
      return true;
    });
    __syncthreads();
    attend_tile<HD>(sm, npairs, cap, st, [&](int, int t) { return kvalid[t] >= 0; });
  }
  // (b) the segment's own keys in the pack, causal by pack row
  const int kend = include_pack ? row0 + nrows : start;
  for (int j0 = start; j0 < kend; j0 += kKeyTile) {
    __syncthreads();
    load_tile<HD>(sm, [&](int t, const bf16** kp, const bf16** vp) {
      const int j = j0 + t;
      if (j >= kend) return false;
      *kp = k + j * kstride + h * HD;
      *vp = v + j * kstride + h * HD;
      return true;
    });
    __syncthreads();
    attend_tile<HD>(sm, npairs, cap, st, [&](int p, int t) { return j0 + t <= row0 + p / g; });
  }
  if (PARTIAL) {
    store_partial<HD>(
        st, npairs,
        [&](int p) { return out.acc + (row0 + p / g) * qstride + (h * g + p % g) * HD; },
        out.m, out.l, [&](int p) { return static_cast<size_t>(row0 + p / g) * hq + h * g + p % g; });
  } else {
    store_out<HD>(st, npairs, [&](int p) {
      return out.o + (row0 + p / g) * qstride + (h * g + p % g) * HD;
    });
  }
}

template <int HD, bool PARTIAL>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg, const void* kpool,
                   const void* vpool, const int* tables, const int* ctx_lens, CtxOut out, int T,
                   int hq, int hkv, int nb, int bs, int N, int P, int include_pack, float scale,
                   float cap, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD, kPPW>();
  cudaError_t err = allow_smem(ctx_attention_kernel<HD, PARTIAL>, smem);
  if (err != cudaSuccess) return err;
  const int bm = kMaxPairs / (hq / hkv);
  const dim3 grid((T + bm - 1) / bm, hkv, N + 1);  // z = N: the pad-row slice
  ctx_attention_kernel<HD, PARTIAL><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), seg,
      static_cast<const bf16*>(kpool), static_cast<const bf16*>(vpool), tables, ctx_lens, out, T,
      hq, hkv, nb, bs, N, P, include_pack, scale, cap);
  return cudaGetLastError();
}

template <bool PARTIAL>
int dispatch(const void* q, const void* k, const void* v, const int* seg, const void* kpool,
             const void* vpool, const int* tables, const int* ctx_lens, CtxOut out, int T, int hq,
             int hkv, int hd, int nb, int bs, int N, int P, int include_pack, float scale,
             float cap, void* stream) {
  if (hkv <= 0 || hq % hkv || hq / hkv > kMaxPairs || N < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch<64, PARTIAL>(q, k, v, seg, kpool, vpool, tables, ctx_lens, out, T, hq, hkv,
                                 nb, bs, N, P, include_pack, scale, cap, st);
    case 128:
      return launch<128, PARTIAL>(q, k, v, seg, kpool, vpool, tables, ctx_lens, out, T, hq, hkv,
                                  nb, bs, N, P, include_pack, scale, cap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace dst

// q [T, hq, hd], k/v [T, hkv, hd], pools [nb, bs, hkv, hd] bf16; seg [T]
// int32 (slot + 1, 0 = pad); tables [N, P] int32; ctx_lens [N] int32;
// o [T, hq, hd] bf16.
extern "C" int dst_ctx_attention(const void* q, const void* k, const void* v, const int* seg,
                                 const void* kpool, const void* vpool, const int* tables,
                                 const int* ctx_lens, void* o, int T, int hq, int hkv, int hd,
                                 int nb, int bs, int N, int P, float scale, float cap,
                                 void* stream) {
  const dst::CtxOut out{static_cast<dst::bf16*>(o), nullptr, nullptr, nullptr};
  return dst::dispatch<false>(q, k, v, seg, kpool, vpool, tables, ctx_lens, out, T, hq, hkv, hd,
                              nb, bs, N, P, 1, scale, cap, stream);
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
  const dst::CtxOut out{nullptr, acc, m, l};
  return dst::dispatch<true>(q, k, v, seg, kpool, vpool, tables, ctx_lens, out, T, hq, hkv, hd,
                             nb, bs, N, P, include_pack, scale, cap, stream);
}
