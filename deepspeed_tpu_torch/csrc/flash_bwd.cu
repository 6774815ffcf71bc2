// Causal flash-attention backward (FlashAttention-2) with packed segments,
// GQA and soft cap: two kernels, no atomics.
//
// Replaces: deepspeed_tpu/ops/pallas/flash_kernel.py `_bwd` (:364): the dq
// `pl.pallas_call` at :384 (flash_bwd_dq_kernel) and the dk/dv
// `pl.pallas_call` at :407 (flash_bwd_dkv_kernel).
//
// What it computes, for the forward o = softmax(cap(q k^T * scale)) v over
// keys j <= i of row i's segment, given o, its log-sum-exp `lse` (written by
// flash_fwd.cu, capped scaled-score units) and delta[b, i, h] = rowsum(dO * o)
// (one PyTorch op, as JAX computes it outside Pallas at :370):
//   p  = exp(s_cap - lse)                       (the forward's probabilities)
//   dp = dO . v
//   ds = p * (dp - delta) * (1 - (s_cap / cap)^2) * scale   (cap factor :131)
//   dq = sum_j ds k_j,   dk = sum_i ds q_i,   dv = sum_i p dO_i
// dk and dv of kv head h sum over all g = hq / hkv query heads of its group
// directly, in one CTA: the JAX kernel repeats k/v to hq heads and sums the
// groups afterwards (:426-447, :461-468); only the summation order differs.
// bf16 in, fp32 accumulation, bf16 dq / dk / dv.
//
// Bound on H100: at least 10 * hd flops per causal (query, key, q-head)
// (recompute q.k, dO.v, and the dq / dk / dv products) -- compute-bound for
// long sequences.  Design: CUDA-core fp32 (no wgmma yet: simple and right
// first), in the lane-per-key layout of attn_common.cuh:
//   dq:  one CTA per (tile of 32 / g query rows, kv head, batch) owns all g
//        heads of its rows (32 (row, head) pairs, q pre-scaled and dO in
//        fp32 shared memory) and streams 32-key tiles of K and V from key 0
//        up to its last row; lane t scores key t, rebuilds p from lse and
//        forms ds; dq accumulates in registers (lane l owns hd/32 dims).
//        The heaviest row tiles (the last rows, which see the most keys) are
//        launched first.
//   dkv: one CTA per (32-key tile, kv head, batch) holds its keys (k
//        pre-scaled and v in fp32 shared memory) and streams tiles of 32
//        (query row, head) pairs from its first key to s; lane t owns pair
//        t, and dk / dv accumulate in registers over every row and head.
// Both skip whole tiles above the causal diagonal (the loops end there), and
// a tile in which no key shares a segment with a visible query row, as
// flash_fwd.cu does.  Masked or missing keys and rows carry p = ds = 0 and
// zero-filled rows, so they add nothing and meet no NaN.
#include "attn_common.cuh"

namespace dst {

constexpr int kDqPPW = 8;                    // (row, head) pairs per warp
constexpr int kDqPairs = kWarps * kDqPPW;    // 32 pairs per dq CTA
constexpr int kKvPPW = 8;                    // keys per warp
constexpr int kKvKeys = kWarps * kKvPPW;     // 32 keys per dkv CTA
constexpr int kPairTile = 32;                // (row, head) pairs per dkv tile, one per lane

// dq: q (pre-scaled) and dO rows in fp32, K and V tiles in bf16, rows padded
// by 8 so that 32 lanes reading 32 different rows hit distinct banks.
template <int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * 2 * kDqPairs * HD + sizeof(bf16) * 2 * kKeyTile * (HD + 8);
}

// dkv: k (pre-scaled) and v rows in fp32, q and dO tiles in bf16, padded.
template <int HD>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * 2 * kKvKeys * HD + sizeof(bf16) * 2 * kPairTile * (HD + 8);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ seg,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq, int s, int hq,
                    int hkv, float scale, float cap) {
  constexpr int kVpl = HD / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int qseg[kDqPairs];
  __shared__ int kseg[kKeyTile];
  __shared__ float lse_s[kDqPairs];
  __shared__ float delta_s[kDqPairs];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* dos = qs + kDqPairs * HD;
  bf16* kt = reinterpret_cast<bf16*>(dos + kDqPairs * HD);
  bf16* vt = kt + kKeyTile * (HD + 8);

  const int g = hq / hkv;
  const int bm = kDqPairs / g;  // query rows per CTA
  const int row0 = (gridDim.x - 1 - blockIdx.x) * bm;  // last (heaviest) rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int nrows = min(bm, s - row0);
  if (nrows <= 0) return;
  const int npairs = nrows * g;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t qstride = static_cast<size_t>(hq) * HD;
  const size_t kstride = static_cast<size_t>(hkv) * HD;
  const bf16* qb = q + static_cast<size_t>(b) * s * qstride;
  const bf16* dob = dout + static_cast<size_t>(b) * s * qstride;
  const bf16* kb = k + static_cast<size_t>(b) * s * kstride + h * HD;
  const bf16* vb = v + static_cast<size_t>(b) * s * kstride + h * HD;
  const int* sb = seg ? seg + static_cast<size_t>(b) * s : nullptr;
  auto pair_off = [&](int p) { return (row0 + p / g) * qstride + (h * g + p % g) * HD; };

  load_q<HD>(qs, npairs, scale, [&](int p) { return qb + pair_off(p); });
  load_q<HD>(dos, npairs, 1.f, [&](int p) { return dob + pair_off(p); });
  for (int p = threadIdx.x; p < npairs; p += blockDim.x) {
    const int row = row0 + p / g, head = h * g + p % g;
    lse_s[p] = lse[(static_cast<size_t>(b) * hq + head) * s + row];
    delta_s[p] = delta[(static_cast<size_t>(b) * s + row) * hq + head];
  }
  for (int r = threadIdx.x; r < bm; r += blockDim.x) qseg[r] = (sb && r < nrows) ? sb[row0 + r] : 0;

  float acc[kDqPPW][kVpl];
#pragma unroll
  for (int i = 0; i < kDqPPW; ++i)
#pragma unroll
    for (int c = 0; c < kVpl; ++c) acc[i][c] = 0.f;

  const int kend = row0 + nrows;  // causal: no row of this CTA sees a key >= kend
  for (int j0 = 0; j0 < kend; j0 += kKeyTile) {
    __syncthreads();  // previous tile consumed; rows / qseg written on the first pass
    int need = 0;
    if (threadIdx.x < kKeyTile) {
      const int j = j0 + threadIdx.x;
      const int ks = (sb && j < kend) ? sb[j] : 0;
      kseg[threadIdx.x] = ks;
      if (j < kend) {
        if (!sb) {
          need = 1;
        } else {
          for (int r = max(j - row0, 0); r < nrows; ++r) {
            if (qseg[r] == ks) {
              need = 1;
              break;
            }
          }
        }
      }
    }
    if (!__syncthreads_or(need)) continue;  // no shared segment: the tile adds nothing
    load_rows_bf16<HD>(kt, kKeyTile, [&](int t) {
      return j0 + t < kend ? kb + (j0 + t) * kstride : nullptr;
    });
    load_rows_bf16<HD>(vt, kKeyTile, [&](int t) {
      return j0 + t < kend ? vb + (j0 + t) * kstride : nullptr;
    });
    __syncthreads();
    const bf16* krow = kt + lane * (HD + 8);
    const bf16* vrow = vt + lane * (HD + 8);
#pragma unroll
    for (int i = 0; i < kDqPPW; ++i) {
      const int p = warp + kWarps * i;
      if (p >= npairs) break;  // uniform across the warp
      const int r = p / g;
      const float sraw = dot_f32_bf16<HD>(qs + p * HD, krow);
      const float dp = dot_f32_bf16<HD>(dos + p * HD, vrow);
      const bool ok = j0 + lane <= row0 + r && (!sb || kseg[lane] == qseg[r]);
      float ds;
      prob_and_ds(sraw, ok, lse_s[p], dp, delta_s[p], scale, cap, &ds);
#pragma unroll 8
      for (int t = 0; t < kKeyTile; ++t) {
        const float dst_ = __shfl_sync(kFull, ds, t);
        float kv[kVpl];
        load_bf16<kVpl>(kt + t * (HD + 8) + lane * kVpl, kv);
#pragma unroll
        for (int c = 0; c < kVpl; ++c) acc[i][c] += dst_ * kv[c];
      }
    }
  }
  bf16* dqb = dq + static_cast<size_t>(b) * s * qstride;
#pragma unroll
  for (int i = 0; i < kDqPPW; ++i) {
    const int p = warp + kWarps * i;
    if (p >= npairs) break;
    bf16* o = dqb + pair_off(p) + lane * kVpl;
#pragma unroll
    for (int c = 0; c < kVpl; ++c) o[c] = __float2bfloat16(acc[i][c]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ seg,
                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int s, int hq, int hkv, float scale, float cap) {
  constexpr int kVpl = HD / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int kseg[kKvKeys];
  __shared__ int row_t[kPairTile];
  __shared__ int qseg_t[kPairTile];
  __shared__ float lse_t[kPairTile];
  __shared__ float delta_t[kPairTile];
  float* kf = reinterpret_cast<float*>(smem_raw);
  float* vf = kf + kKvKeys * HD;
  bf16* qt = reinterpret_cast<bf16*>(vf + kKvKeys * HD);
  bf16* dot = qt + kPairTile * (HD + 8);

  const int g = hq / hkv;
  const int k0 = blockIdx.x * kKvKeys;  // the first keys see the most rows: launched first
  const int h = blockIdx.y, b = blockIdx.z;
  const int nkeys = min(kKvKeys, s - k0);
  if (nkeys <= 0) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t qstride = static_cast<size_t>(hq) * HD;
  const size_t kstride = static_cast<size_t>(hkv) * HD;
  const bf16* qb = q + static_cast<size_t>(b) * s * qstride;
  const bf16* dob = dout + static_cast<size_t>(b) * s * qstride;
  const bf16* kb = k + static_cast<size_t>(b) * s * kstride + h * HD;
  const bf16* vb = v + static_cast<size_t>(b) * s * kstride + h * HD;
  const int* sb = seg ? seg + static_cast<size_t>(b) * s : nullptr;

  load_q<HD>(kf, nkeys, scale, [&](int j) { return kb + (k0 + j) * kstride; });
  load_q<HD>(vf, nkeys, 1.f, [&](int j) { return vb + (k0 + j) * kstride; });
  for (int j = threadIdx.x; j < kKvKeys; j += blockDim.x) kseg[j] = (sb && j < nkeys) ? sb[k0 + j] : 0;

  float acc_k[kKvPPW][kVpl], acc_v[kKvPPW][kVpl];
#pragma unroll
  for (int i = 0; i < kKvPPW; ++i)
#pragma unroll
    for (int c = 0; c < kVpl; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // (row, head) pairs from row k0 on, head inner: pair P is row k0 + P / g
  const int npq = (s - k0) * g;
  for (int p0 = 0; p0 < npq; p0 += kPairTile) {
    __syncthreads();  // previous tile consumed; kseg written on the first pass
    int need = 0;
    if (threadIdx.x < kPairTile) {
      const int pp = p0 + threadIdx.x;
      int row = -1;
      if (pp < npq) {
        row = k0 + pp / g;
        const int head = h * g + pp % g;
        lse_t[threadIdx.x] = lse[(static_cast<size_t>(b) * hq + head) * s + row];
        delta_t[threadIdx.x] = delta[(static_cast<size_t>(b) * s + row) * hq + head];
        const int qsg = sb ? sb[row] : 0;
        qseg_t[threadIdx.x] = qsg;
        if (!sb) {
          need = 1;  // every row >= k0 sees key k0
        } else {
          for (int j = 0; j < nkeys && k0 + j <= row; ++j) {
            if (kseg[j] == qsg) {
              need = 1;
              break;
            }
          }
        }
      }
      row_t[threadIdx.x] = row;
    }
    if (!__syncthreads_or(need)) continue;  // no shared segment: the tile adds nothing
    auto pair_row = [&](const bf16* base, int t) -> const bf16* {
      const int pp = p0 + t;
      return row_t[t] >= 0 ? base + row_t[t] * qstride + (h * g + pp % g) * HD : nullptr;
    };
    load_rows_bf16<HD>(qt, kPairTile, [&](int t) { return pair_row(qb, t); });
    load_rows_bf16<HD>(dot, kPairTile, [&](int t) { return pair_row(dob, t); });
    __syncthreads();
    const bf16* qrow = qt + lane * (HD + 8);
    const bf16* dorow = dot + lane * (HD + 8);
    const int row = row_t[lane];
#pragma unroll
    for (int i = 0; i < kKvPPW; ++i) {
      const int j = warp + kWarps * i;
      if (j >= nkeys) break;  // uniform across the warp
      const float sraw = dot_f32_bf16<HD>(kf + j * HD, qrow);
      const float dp = dot_f32_bf16<HD>(vf + j * HD, dorow);
      const bool ok = row >= k0 + j && (!sb || qseg_t[lane] == kseg[j]);
      float ds;
      const float pr = prob_and_ds(sraw, ok, lse_t[lane], dp, delta_t[lane], scale, cap, &ds);
#pragma unroll 8
      for (int t = 0; t < kPairTile; ++t) {
        const float pt = __shfl_sync(kFull, pr, t);
        const float dst_ = __shfl_sync(kFull, ds, t);
        float qv[kVpl], dv_[kVpl];
        load_bf16<kVpl>(qt + t * (HD + 8) + lane * kVpl, qv);
        load_bf16<kVpl>(dot + t * (HD + 8) + lane * kVpl, dv_);
#pragma unroll
        for (int c = 0; c < kVpl; ++c) {
          acc_k[i][c] += dst_ * qv[c];
          acc_v[i][c] += pt * dv_[c];
        }
      }
    }
  }
  const size_t obase = static_cast<size_t>(b) * s * kstride + h * HD;
#pragma unroll
  for (int i = 0; i < kKvPPW; ++i) {
    const int j = warp + kWarps * i;
    if (j >= nkeys) break;
    bf16* ok_ = dk + obase + (k0 + j) * kstride + lane * kVpl;
    bf16* ov_ = dv + obase + (k0 + j) * kstride + lane * kVpl;
#pragma unroll
    for (int c = 0; c < kVpl; ++c) {
      ok_[c] = __float2bfloat16(acc_k[i][c]);
      ov_[c] = __float2bfloat16(acc_v[i][c]);
    }
  }
}

template <int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const int* seg,
                      const void* dout, const float* lse, const float* delta, void* dq, int b,
                      int s, int hq, int hkv, float scale, float cap, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<HD>();
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<HD>, smem);
  if (err != cudaSuccess) return err;
  const int bm = kDqPairs / (hq / hkv);
  const dim3 grid((s + bm - 1) / bm, hkv, b);
  flash_bwd_dq_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), seg,
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), s, hq, hkv, scale, cap);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const int* seg,
                       const void* dout, const float* lse, const float* delta, void* dk, void* dv,
                       int b, int s, int hq, int hkv, float scale, float cap,
                       cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<HD>();
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<HD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kKvKeys - 1) / kKvKeys, hkv, b);
  flash_bwd_dkv_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), seg,
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      s, hq, hkv, scale, cap);
  return cudaGetLastError();
}

}  // namespace dst

// q / dout [b, s, hq, hd], k / v [b, s, hkv, hd] bf16 contiguous; seg [b, s]
// int32 or null; lse [b, hq, s] and delta [b, s, hq] fp32; dq [b, s, hq, hd]
// bf16.  cap <= 0 disables the soft cap.  Returns the launch's
// cudaGetLastError() (non-zero: nothing ran).
extern "C" int dst_flash_bwd_dq(const void* q, const void* k, const void* v, const int* seg,
                                const void* dout, const float* lse, const float* delta, void* dq,
                                int b, int s, int hq, int hkv, int hd, float scale, float cap,
                                void* stream) {
  if (hkv <= 0 || hq % hkv || hq / hkv > dst::kDqPairs) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return dst::launch_dq<64>(q, k, v, seg, dout, lse, delta, dq, b, s, hq, hkv, scale, cap, st);
    case 128: return dst::launch_dq<128>(q, k, v, seg, dout, lse, delta, dq, b, s, hq, hkv, scale, cap, st);
    default: return cudaErrorInvalidValue;
  }
}

// The same inputs; dk / dv [b, s, hkv, hd] bf16, each summed over the g
// query heads of its kv head.
extern "C" int dst_flash_bwd_dkv(const void* q, const void* k, const void* v, const int* seg,
                                 const void* dout, const float* lse, const float* delta, void* dk,
                                 void* dv, int b, int s, int hq, int hkv, int hd, float scale,
                                 float cap, void* stream) {
  if (hkv <= 0 || hq % hkv) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return dst::launch_dkv<64>(q, k, v, seg, dout, lse, delta, dk, dv, b, s, hq, hkv, scale, cap, st);
    case 128: return dst::launch_dkv<128>(q, k, v, seg, dout, lse, delta, dk, dv, b, s, hq, hkv, scale, cap, st);
    default: return cudaErrorInvalidValue;
  }
}
