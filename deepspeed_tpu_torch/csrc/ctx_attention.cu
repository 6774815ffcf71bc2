// Packed-suffix attention over cached context pages plus in-pack causal keys.
//
// Replaces: deepspeed_tpu/ops/pallas/ctx_attention.py
// `paged_attention_packed_ctx_kernel` (the `pl.pallas_call` at :297,
// partial=False), reached from prefix-cache hits and chunked-prefill
// continuation chunks (`model_runner.prefill_packed_ctx` ->
// `paged.paged_attention_packed_ctx`).
//
// What it computes: each pack row of segment n (segment_ids == n + 1)
// attends, in ONE fp32 online softmax, to (a) its slot's cached positions
// [0, ctx_lens[n]) read through ctx_tables[n] -- table ids outside [0, nb)
// are skipped, ctx_lens may end mid-page -- and then (b) the keys of its own
// segment in the pack at or before its row.  Soft cap fused before the mask.
// Rows whose segment id is not in [1, N] (padding) come out exactly 0.
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

template <int HD>
__global__ void __launch_bounds__(kThreads)
ctx_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ seg,
                     const bf16* __restrict__ kpool, const bf16* __restrict__ vpool,
                     const int* __restrict__ tables, const int* __restrict__ ctx_lens,
                     bf16* __restrict__ o, int T, int hq, int hkv, int nb, int bs, int N, int P,
                     float scale, float cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_start, s_len;
  __shared__ int kvalid[kKeyTile];
  const Smem<HD> sm(smem_raw, kMaxPairs);
  const int g = hq / hkv;
  const int bm = kMaxPairs / g;
  const int h = blockIdx.y, n = blockIdx.z;
  const size_t qstride = static_cast<size_t>(hq) * HD;
  const size_t kstride = static_cast<size_t>(hkv) * HD;

  if (n == N) {  // pad rows: exactly 0 for this kv head's query heads
    const int row0 = blockIdx.x * bm;
    const int rows = min(bm, T - row0);
    for (int idx = threadIdx.x; idx < rows * g * HD; idx += blockDim.x) {
      const int r = row0 + idx / (g * HD);
      const int id = seg[r];
      if (id < 1 || id > N) o[r * qstride + h * g * HD + idx % (g * HD)] = __float2bfloat16(0.f);
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
    if (threadIdx.x < kKeyTile) {
      const int pos = j0 + threadIdx.x;
      const int page = pos < ctx_len ? row[pos / bs] : -1;
      kvalid[threadIdx.x] = (page >= 0 && page < nb) ? page : -1;
    }
    __syncthreads();
    load_tile<HD>(sm, [&](int t, const bf16** kp, const bf16** vp) {
      const int page = kvalid[t];
      if (page < 0) return false;
      const size_t off = ((static_cast<size_t>(page) * bs + (j0 + t) % bs) * hkv + h) * HD;
      *kp = kpool + off;
      *vp = vpool + off;
      return true;
    });
    __syncthreads();
    attend_tile<HD>(sm, npairs, cap, st, [&](int, int t) { return kvalid[t] >= 0; });
  }
  // (b) the segment's own keys in the pack, causal by pack row
  const int kend = row0 + nrows;
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
  store_out<HD>(st, npairs, [&](int p) {
    return o + (row0 + p / g) * qstride + (h * g + p % g) * HD;
  });
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg, const void* kpool,
                   const void* vpool, const int* tables, const int* ctx_lens, void* o, int T,
                   int hq, int hkv, int nb, int bs, int N, int P, float scale, float cap,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<HD, kPPW>();
  cudaError_t err = allow_smem(ctx_attention_kernel<HD>, smem);
  if (err != cudaSuccess) return err;
  const int bm = kMaxPairs / (hq / hkv);
  const dim3 grid((T + bm - 1) / bm, hkv, N + 1);  // z = N: the pad-row slice
  ctx_attention_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), seg,
      static_cast<const bf16*>(kpool), static_cast<const bf16*>(vpool), tables, ctx_lens,
      static_cast<bf16*>(o), T, hq, hkv, nb, bs, N, P, scale, cap);
  return cudaGetLastError();
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
  if (hkv <= 0 || hq % hkv || hq / hkv > dst::kMaxPairs || N < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return dst::launch<64>(q, k, v, seg, kpool, vpool, tables, ctx_lens, o, T, hq, hkv, nb, bs,
                             N, P, scale, cap, st);
    case 128:
      return dst::launch<128>(q, k, v, seg, kpool, vpool, tables, ctx_lens, o, T, hq, hkv, nb,
                              bs, N, P, scale, cap, st);
    default:
      return cudaErrorInvalidValue;
  }
}
