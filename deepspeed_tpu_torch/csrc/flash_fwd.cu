// Causal flash-attention forward with packed segments, GQA and soft cap.
//
// Replaces: deepspeed_tpu/ops/pallas/flash_kernel.py `_fwd` (the
// `pl.pallas_call` at :279, entry `pallas_flash_attention` :796), the kernel
// behind serving's cold packed prefill (`model_runner.prefill_packed`).
//
// What it computes: o[b, i, h] = softmax_j(cap(q_i . k_j * scale)) v_j over
// keys j with j <= i and seg[b, j] == seg[b, i] (every key when seg is
// null), kv head h / (hq / hkv); fp32 softmax, bf16 out.  With a non-null
// `lse` it also writes lse[b, h, i] = m + log(l), the log-sum-exp of the
// capped scaled scores (flash_kernel.py:170), which the training backward
// (flash_bwd.cu) reads to rebuild the probabilities; serving passes null.
//
// Bound on H100: in-segment causal work is 4 * hd flops per (query, key,
// head) -- compute-bound for long segments, byte-bound for the short
// segments of a serving pack.  Design (attn_common.cuh): one CTA per
// (tile of 64 / g query rows, kv head, batch) owns all g heads of the group,
// so each k/v tile is read once per group; key tiles run from 0 up to the
// CTA's last row (causal), and a tile is skipped outright when none of its
// keys shares a segment with a visible query row -- in a pack of short
// prompts almost every tile below the diagonal is skipped.  The arithmetic
// is CUDA-core fp32, not wgmma: simple and right first.
#include "attn_common.cuh"

namespace dst {

constexpr int kPPW = 16;  // 64 pairs per CTA: long key loops amortise each tile
constexpr int kMaxPairs = kWarps * kPPW;

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ seg,
                 bf16* __restrict__ o, float* __restrict__ lse, int s, int hq, int hkv,
                 float scale, float cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int qseg[kMaxPairs];
  __shared__ int kseg[kKeyTile];
  const Smem<HD> sm(smem_raw, kMaxPairs);
  const int g = hq / hkv;
  const int bm = kMaxPairs / g;  // query rows per CTA
  const int row0 = blockIdx.x * bm;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nrows = min(bm, s - row0);
  if (nrows <= 0) return;
  const int npairs = nrows * g;
  const size_t qstride = static_cast<size_t>(hq) * HD;
  const size_t kstride = static_cast<size_t>(hkv) * HD;
  const bf16* qb = q + static_cast<size_t>(b) * s * qstride;
  const bf16* kb = k + static_cast<size_t>(b) * s * kstride + h * HD;
  const bf16* vb = v + static_cast<size_t>(b) * s * kstride + h * HD;
  bf16* ob = o + static_cast<size_t>(b) * s * qstride;
  const int* sb = seg ? seg + static_cast<size_t>(b) * s : nullptr;

  load_q<HD>(sm.q, npairs, scale, [&](int p) {
    return qb + (row0 + p / g) * qstride + (h * g + p % g) * HD;
  });
  for (int r = threadIdx.x; r < bm; r += blockDim.x) qseg[r] = (sb && r < nrows) ? sb[row0 + r] : 0;

  PairState<HD, kPPW> st;
  st.init();
  const int kend = row0 + nrows;  // causal: no row of this CTA sees a key >= kend
  for (int j0 = 0; j0 < kend; j0 += kKeyTile) {
    __syncthreads();  // previous tile consumed; q/qseg written on the first pass
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
    load_tile<HD>(sm, [&](int t, const bf16** kp, const bf16** vp) {
      const int j = j0 + t;
      if (j >= kend) return false;
      *kp = kb + j * kstride;
      *vp = vb + j * kstride;
      return true;
    });
    __syncthreads();
    attend_tile<HD>(sm, npairs, cap, st, [&](int p, int t) {
      const int r = p / g;
      return j0 + t <= row0 + r && (!sb || kseg[t] == qseg[r]);
    });
  }
  store_out<HD>(st, npairs, [&](int p) {
    return ob + (row0 + p / g) * qstride + (h * g + p % g) * HD;
  });
  if (lse != nullptr && threadIdx.x % 32 == 0) {
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int i = 0; i < kPPW; ++i) {
      const int p = warp + kWarps * i;
      if (p >= npairs) break;
      const int head = h * g + p % g;
      lse[(static_cast<size_t>(b) * hq + head) * s + row0 + p / g] =
          st.m[i] + logf(fmaxf(st.l[i], 1e-30f));
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg, void* o,
                   float* lse, int b, int s, int hq, int hkv, float scale, float cap,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<HD, kPPW>();
  cudaError_t err = allow_smem(flash_fwd_kernel<HD>, smem);
  if (err != cudaSuccess) return err;
  const int bm = kMaxPairs / (hq / hkv);
  const dim3 grid((s + bm - 1) / bm, hkv, b);
  flash_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), seg,
      static_cast<bf16*>(o), lse, s, hq, hkv, scale, cap);
  return cudaGetLastError();
}

}  // namespace dst

// q [b, s, hq, hd], k/v [b, s, hkv, hd] bf16 contiguous; seg [b, s] int32 or
// null; o [b, s, hq, hd] bf16; lse [b, hq, s] fp32 or null.  cap <= 0
// disables the soft cap.  Returns the launch's cudaGetLastError() (non-zero:
// nothing ran).
extern "C" int dst_flash_fwd(const void* q, const void* k, const void* v, const int* seg, void* o,
                             float* lse, int b, int s, int hq, int hkv, int hd, float scale,
                             float cap, void* stream) {
  if (hkv <= 0 || hq % hkv || hq / hkv > dst::kMaxPairs) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return dst::launch<64>(q, k, v, seg, o, lse, b, s, hq, hkv, scale, cap, st);
    case 128: return dst::launch<128>(q, k, v, seg, o, lse, b, s, hq, hkv, scale, cap, st);
    default: return cudaErrorInvalidValue;
  }
}
