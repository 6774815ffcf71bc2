// Causal flash-attention forward with packed segments, GQA and soft cap, on
// Hopper's tensor cores (wgmma).
//
// Replaces: deepspeed_tpu/ops/pallas/flash_kernel.py `_fwd` (the
// `pl.pallas_call` at :279, entry `pallas_flash_attention` :796): the
// training forward (with lse) and serving's cold packed prefill
// (`model_runner.prefill_packed`, no lse).
//
// What it computes: o[b, i, h] = softmax_j(cap(q_i . k_j * scale)) v_j over
// keys j with j <= i and seg[b, j] == seg[b, i] (every key when seg is
// null), kv head h / (hq / hkv); fp32 softmax, bf16 in and out.  With a
// non-null `lse` it also writes lse[b, h, i] = m + log(l), the log-sum-exp of
// the capped scaled scores (flash_kernel.py:170), from which the backward
// (flash_bwd.cu) rebuilds the probabilities; serving passes null.
//
// Bound on H100: 4 * hd flops per causal in-segment (query, key, q-head) on
// the bf16 tensor cores (989 TFLOP/s) -- operation-bound for long segments
// (b 8, s 4096, hq 8, hd 128: 0.28 ms), byte-bound for the short segments of
// a serving pack.  Design:
//   - one CTA of two consumer warpgroups owns 128 query rows (64 each) of ONE
//     query head; its kv head is h / g, so any group size runs, and the g
//     heads of a group re-read the same K / V tiles from the 50 MB L2;
//   - S = Q K^T is wgmma m64nBKk16 with Q and K in shared memory; O += P V is
//     the register-A form, P converted to bf16 in registers, V [key][hd]
//     read MN-major (transposed B); the online softmax (m, l) stays in fp32
//     registers, row max and sum over the accumulator's quad lanes;
//   - K / V tiles of BK keys stream through a 2-stage cp.async ring into the
//     128 B-swizzled layout the descriptors read (tc_common.cuh): the next
//     tile loads while this one is multiplied;
//   - key tiles above the causal diagonal are never loaded, and a tile whose
//     segment range misses the query tile's is skipped (a serving pack of
//     16 x 128 loads only its diagonal tiles); a warpgroup whose 64 rows see
//     none of a loaded tile skips its products; the mask is applied only on
//     diagonal tiles and on tiles of mixed segments;
//   - the heaviest query tiles (the last rows) are launched first.
#include "tc_common.cuh"

namespace dst {
namespace {

using namespace tc;

// The tile shape at head dim HD: two consumer warpgroups own 64 query rows
// each; key tiles of BK keys stream through a ring of ST = 2 stages.  BK is
// 128 (S is 64 floats a thread) unless the hd-256 O accumulator (128
// floats) leaves room for 64.
template <int HD_>
struct Tiles {
  static constexpr int HD = HD_, NWG = 2, BK = HD == 256 ? 64 : 128, ST = 2;
  static constexpr int BQ = 64 * NWG, THREADS = 128 * NWG;
  static constexpr size_t SMEM = 1024 + sizeof(bf16) * (BQ * HD + 2 * ST * BK * HD);
};

template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ seg,
                 bf16* __restrict__ o, float* __restrict__ lse, int s, int hq, int hkv,
                 float scale, float cap) {
  constexpr int HD = T::HD, BK = T::BK, ST = T::ST, kBQ = T::BQ, kThreads = T::THREADS;
  extern __shared__ unsigned char smem_raw[];
  bf16* sq = align_1024(smem_raw);
  bf16* sk = sq + kBQ * HD;      // [ST][BK][HD]
  bf16* sv = sk + ST * BK * HD;  // [ST][BK][HD]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // last (heaviest) rows first
  const int hk = h / (hq / hkv);
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const size_t qstride = static_cast<size_t>(hq) * HD, kstride = static_cast<size_t>(hkv) * HD;
  const bf16* qb = q + static_cast<size_t>(b) * s * qstride + static_cast<size_t>(h) * HD;
  const bf16* kb = k + static_cast<size_t>(b) * s * kstride + static_cast<size_t>(hk) * HD;
  const bf16* vb = v + static_cast<size_t>(b) * s * kstride + static_cast<size_t>(hk) * HD;
  const int* sb = seg ? seg + static_cast<size_t>(b) * s : nullptr;

  const int kend = min(s, q0 + kBQ);  // causal: no row of the CTA sees a key >= kend
  const int ntk = (kend + BK - 1) / BK;
  const int wrow0 = q0 + 64 * wg;                 // this warpgroup's rows
  const int wrow_last = min(wrow0 + 63, s - 1);   // < wrow0: no live row
  const int row_a = wrow0 + (threadIdx.x % 128) / 32 * 16 + lane / 4;  // rows row_a, row_a + 8

  int cmin = 0, cmax = 0, wmin = 0, wmax = 0, qseg[2] = {0, 0};
  if (sb) {
    seg_range(sb, q0, kend, &cmin, &cmax);
    seg_range(sb, wrow0, wrow_last + 1, &wmin, &wmax);
    qseg[0] = row_a < s ? sb[row_a] : -1;
    qseg[1] = row_a + 8 < s ? sb[row_a + 8] : -1;
  }
  // the next key tile from `jt` on that shares a segment with the CTA's rows
  // (warp-uniform: every warp scans the same ids)
  auto next_tile = [&](int jt) {
    for (; sb && jt < ntk; ++jt) {
      int mn, mx;
      seg_range(sb, jt * BK, min(jt * BK + BK, kend), &mn, &mx);
      if (mx >= cmin && mn <= cmax) break;
    }
    return jt;
  };
  auto load_kv = [&](int jt, int stage) {
    load_tile<BK, HD, kThreads>(sk + stage * BK * HD, kb, kstride, jt * BK, s - jt * BK);
    load_tile<BK, HD, kThreads>(sv + stage * BK * HD, vb, kstride, jt * BK, s - jt * BK);
  };

  // the ring: tile `fetch` is the next to load, `cur` the one multiplied; a
  // stage is refilled only after the barrier that follows its last use
  load_tile<kBQ, HD, kThreads>(sq, qb, qstride, q0, s - q0);
  int fetch = next_tile(0);
#pragma unroll
  for (int st = 0; st < ST - 1; ++st) {
    if (fetch < ntk) {
      load_kv(fetch, st);
      fetch = next_tile(fetch + 1);
    }
    cp_async_commit();
  }

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const ScoreMap smap(scale, cap);

  int cur = next_tile(0);
  for (int it = 0; cur < ntk; ++it) {
    cp_async_wait<ST - 2>();
    fence_async_smem();
    __syncthreads();  // tile `cur` landed; every warp is done with iteration it - 1
    if (fetch < ntk) {
      load_kv(fetch, (it + ST - 1) % ST);
      fetch = next_tile(fetch + 1);
    }
    cp_async_commit();

    const int j0 = cur * BK;
    bool live = wrow0 < s && j0 <= wrow_last;
    bool uniform = true;
    if (live && sb) {
      int kmin, kmax;
      seg_range(sb, j0, min(j0 + BK, kend), &kmin, &kmax);
      live = kmax >= wmin && kmin <= wmax;
      uniform = kmin == kmax && wmin == wmax && kmin == wmin;
    }
    if (live) {  // uniform across the warpgroup
      const bf16* tk = sk + (it % ST) * BK * HD;
      const bf16* tv = sv + (it % ST) * BK * HD;
      float sc[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<BK>(sc, desc_k<kBQ>(sq, 64 * wg, kk), desc_k<BK>(tk, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      const bool masked = j0 + BK - 1 > wrow0 || !uniform;
      smap.apply_cap(sc);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        if (masked) {
          const int r = (i >> 1) & 1;
          const int row = row_a + 8 * r;
          const int key = j0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          if (key > row || (sb && sb[min(key, s - 1)] != qseg[r])) sc[i] = -INFINITY;
        }
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      }
      // m is in base-2 logits: p = 2^(sc * mul - m)
      float base[2], corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mnew = fmaxf(m[r], quad_max(mx[r]) * smap.mul);
        base[r] = mnew == -INFINITY ? 0.f : mnew;  // a row with no key yet: p = 0
        corr[r] = fast_exp2(m[r] - base[r]);
        m[r] = mnew;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const float p = fast_exp2(fmaf(sc[i], smap.mul, -base[(i >> 1) & 1]));
        sc[i] = p;
        l[(i >> 1) & 1] += p;
      }
      // every A fragment is formed before the first product, so no register
      // of the batch changes under an issued wgmma
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(sc, kk, pa[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<HD>(acc, pa[kk], desc_mn<BK>(tv, kk, 0), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    cur = next_tile(cur + 1);
  }
  cp_async_wait<0>();

  bf16* ob = o + static_cast<size_t>(b) * s * qstride + static_cast<size_t>(h) * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    const float lr = quad_sum(l[r]);
    if (row >= s) continue;
    const float inv = lr > 0.f ? 1.f / lr : 0.f;
    bf16* orow = ob + static_cast<size_t>(row) * qstride + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    if (lse != nullptr && (lane & 3) == 0)
      lse[(static_cast<size_t>(b) * hq + h) * s + row] = m[r] * kLn2 + logf(lr);
  }
}

template <class T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg, void* o,
                   float* lse, int b, int s, int hq, int hkv, float scale, float cap,
                   cudaStream_t stream) {
  cudaError_t err = allow_smem(flash_fwd_kernel<T>, T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(hq, b, (s + T::BQ - 1) / T::BQ);
  flash_fwd_kernel<T><<<grid, T::THREADS, T::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), seg,
      static_cast<bf16*>(o), lse, s, hq, hkv, scale, cap);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dst

// q [b, s, hq, hd], k/v [b, s, hkv, hd] bf16 contiguous; seg [b, s] int32 or
// null; o [b, s, hq, hd] bf16; lse [b, hq, s] fp32 or null.  hd 64, 128 or
// 256, any hkv dividing hq, any s >= 1.  cap <= 0 disables the soft cap.
// Returns the launch's cudaGetLastError() (non-zero: nothing ran).
extern "C" int dst_flash_fwd(const void* q, const void* k, const void* v, const int* seg, void* o,
                             float* lse, int b, int s, int hq, int hkv, int hd, float scale,
                             float cap, void* stream) {
  if (hkv <= 0 || hq % hkv || b <= 0 || s <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return dst::launch<dst::Tiles<64>>(q, k, v, seg, o, lse, b, s, hq, hkv, scale, cap, st);
    case 128: return dst::launch<dst::Tiles<128>>(q, k, v, seg, o, lse, b, s, hq, hkv, scale, cap, st);
    case 256: return dst::launch<dst::Tiles<256>>(q, k, v, seg, o, lse, b, s, hq, hkv, scale, cap, st);
    default: return cudaErrorInvalidValue;
  }
}
