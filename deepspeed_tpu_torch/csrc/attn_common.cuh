// Shared building blocks of the CUDA-core attention kernels (paged decode
// and packed-context attention, each with its partial mode); the
// tensor-core kernels (tc_common.cuh, flash_tc.cuh) take only bf16, kFull
// and allow_smem from here.
//
// Work unit: one CTA of 4 warps owns up to 4 * PPW (query row, query head)
// PAIRS that read the same kv head.  The GQA group of g query heads of one
// kv head is part of the pair set, so each key/value tile is read from
// device memory once for all g heads (kv heads are never repeated).  Each
// warp owns PPW pairs ("pairs per warp", a template argument: many pairs
// amortise a tile over more work, few pairs give more CTAs) and keeps their
// fp32 online-softmax state (running max m, running sum l, output
// accumulator) in registers.
//
// Keys stream through shared memory in tiles of 32, one key per lane:
//   scores:  lane t computes q . k_t for its key (q pre-scaled, fp32, from
//            shared memory as a broadcast; k rows padded by 8 bf16 so the
//            16-byte reads of 32 different rows hit distinct banks),
//   softmax: warp max / sum over the 32 lanes, fp32,
//   values:  lane l owns HD/32 output dims and accumulates p_t * v_t[dims]
//            with p_t broadcast by shuffle.
// Invalid keys are zero-filled in shared memory and carry p = 0 exactly, so
// a tile that is entirely masked changes no state.
//
// This is CUDA-core (FMA) arithmetic, not tensor-core: the first, simple
// version.  Its cost per tile is dominated by the fp32 dot products.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dst {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeyTile = 32;                        // keys per tile, one per lane
constexpr float kNegInf = -1e30f;                   // finite mask value
constexpr unsigned kFull = 0xffffffffu;

typedef __nv_bfloat16 bf16;

// Dynamic shared memory: q [4 * PPW][HD] fp32, K tile [32][HD + 8] bf16,
// V tile [32][HD] bf16.
template <int HD, int PPW>
constexpr size_t smem_bytes() {
  return sizeof(float) * kWarps * PPW * HD + sizeof(bf16) * kKeyTile * (HD + 8) +
         sizeof(bf16) * kKeyTile * HD;
}

template <int HD>
struct Smem {
  float* q;
  bf16* k;
  bf16* v;
  __device__ Smem(unsigned char* base, int max_pairs) {
    q = reinterpret_cast<float*>(base);
    k = reinterpret_cast<bf16*>(q + max_pairs * HD);
    v = k + kKeyTile * (HD + 8);
  }
};

template <int HD, int PPW>
struct PairState {
  float acc[PPW][HD / 32];
  float m[PPW];
  float l[PPW];

  __device__ void init() {
#pragma unroll
    for (int i = 0; i < PPW; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < HD / 32; ++c) acc[i][c] = 0.f;
    }
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// N consecutive bf16 -> fp32 (N = 2 or 4: the per-lane value slice).
template <int N>
__device__ __forceinline__ void load_bf16(const bf16* p, float* out);

template <>
__device__ __forceinline__ void load_bf16<2>(const bf16* p, float* out) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  out[0] = f.x;
  out[1] = f.y;
}

template <>
__device__ __forceinline__ void load_bf16<4>(const bf16* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}

// q rows of the CTA's pairs into shared memory as fp32, pre-multiplied by
// the softmax scale.  qptr(p) -> the pair's [HD] row in device memory.
template <int HD, typename QPtr>
__device__ __forceinline__ void load_q(float* qs, int npairs, float scale, QPtr qptr) {
  constexpr int kVecs = HD / 8;
  for (int idx = threadIdx.x; idx < npairs * kVecs; idx += blockDim.x) {
    const int p = idx / kVecs, c = idx % kVecs;
    const uint4 raw = reinterpret_cast<const uint4*>(qptr(p))[c];
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float* dst = qs + p * HD + c * 8;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h2[j]);
      dst[2 * j] = f.x * scale;
      dst[2 * j + 1] = f.y * scale;
    }
  }
}

// One key tile into shared memory.  rows(t, &k, &v) -> false for a key that
// does not exist (its rows are zero-filled, so p = 0 * v never meets NaN).
template <int HD, typename Rows>
__device__ __forceinline__ void load_tile(const Smem<HD>& sm, Rows rows) {
  constexpr int kVecs = HD / 8;
  for (int idx = threadIdx.x; idx < kKeyTile * kVecs; idx += blockDim.x) {
    const int t = idx / kVecs, c = idx % kVecs;
    const bf16* kp = nullptr;
    const bf16* vp = nullptr;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (rows(t, &kp, &vp)) {
      kv = reinterpret_cast<const uint4*>(kp)[c];
      vv = reinterpret_cast<const uint4*>(vp)[c];
    }
    reinterpret_cast<uint4*>(sm.k + t * (HD + 8))[c] = kv;
    reinterpret_cast<uint4*>(sm.v + t * HD)[c] = vv;
  }
}

// Fold the tile in shared memory into every pair of this warp.
// key_ok(p, t) says whether pair p may attend key t of the tile.  The soft
// cap (cap > 0) applies before the mask, as in the reference bodies.
template <int HD, int PPW, typename KeyOk>
__device__ __forceinline__ void attend_tile(const Smem<HD>& sm, int npairs, float cap,
                                            PairState<HD, PPW>& st, KeyOk key_ok) {
  constexpr int kVpl = HD / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* krow = sm.k + lane * (HD + 8);
#pragma unroll
  for (int i = 0; i < PPW; ++i) {
    const int p = warp + kWarps * i;
    if (p >= npairs) break;  // uniform across the warp
    const float* q = sm.q + p * HD;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      const uint4 raw = reinterpret_cast<const uint4*>(krow)[c];
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float4 qa = reinterpret_cast<const float4*>(q + c * 8)[0];
      const float4 qb = reinterpret_cast<const float4*>(q + c * 8)[1];
      const float2 k0 = __bfloat1622float2(h2[0]);
      const float2 k1 = __bfloat1622float2(h2[1]);
      const float2 k2 = __bfloat1622float2(h2[2]);
      const float2 k3 = __bfloat1622float2(h2[3]);
      s += qa.x * k0.x + qa.y * k0.y + qa.z * k1.x + qa.w * k1.y +
           qb.x * k2.x + qb.y * k2.y + qb.z * k3.x + qb.w * k3.y;
    }
    if (cap > 0.f) s = cap * tanhf(s / cap);
    const bool ok = key_ok(p, lane);
    s = ok ? s : kNegInf;
    const float m_new = fmaxf(st.m[i], warp_max(s));
    const float alpha = __expf(st.m[i] - m_new);
    const float pr = ok ? __expf(s - m_new) : 0.f;
    st.l[i] = st.l[i] * alpha + warp_sum(pr);
    st.m[i] = m_new;
    float a[kVpl];
#pragma unroll
    for (int c = 0; c < kVpl; ++c) a[c] = st.acc[i][c] * alpha;
#pragma unroll 8
    for (int t = 0; t < kKeyTile; ++t) {
      const float pt = __shfl_sync(kFull, pr, t);
      float vv[kVpl];
      load_bf16<kVpl>(sm.v + t * HD + lane * kVpl, vv);
#pragma unroll
      for (int c = 0; c < kVpl; ++c) a[c] += pt * vv[c];
    }
#pragma unroll
    for (int c = 0; c < kVpl; ++c) st.acc[i][c] = a[c];
  }
}

// Normalise and write every pair of this warp.  optr(p) -> the pair's [HD]
// output row.  A pair with no key at all (l = 0) writes 0.
template <int HD, int PPW, typename OPtr>
__device__ __forceinline__ void store_out(const PairState<HD, PPW>& st, int npairs, OPtr optr) {
  constexpr int kVpl = HD / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < PPW; ++i) {
    const int p = warp + kWarps * i;
    if (p >= npairs) break;
    const float inv = 1.f / fmaxf(st.l[i], 1e-30f);
    bf16* o = optr(p) + lane * kVpl;
#pragma unroll
    for (int c = 0; c < kVpl; ++c) o[c] = __float2bfloat16(st.acc[i][c] * inv);
  }
}

// The partial modes (seq-sharded serving): write every pair's UNnormalized
// fp32 state as it stands -- acc [HD] at aptr(p), the running max at m[mi(p)]
// and the running sum at l[mi(p)].  A pair that met no key keeps its initial
// (0, kNegInf, 0): finite, so the log-sum-exp merge of two empty partials
// stays (0, kNegInf, 0) instead of NaN.
template <int HD, int PPW, typename APtr, typename MIdx>
__device__ __forceinline__ void store_partial(const PairState<HD, PPW>& st, int npairs,
                                              APtr aptr, float* m, float* l, MIdx mi) {
  constexpr int kVpl = HD / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < PPW; ++i) {
    const int p = warp + kWarps * i;
    if (p >= npairs) break;
    float* a = aptr(p) + lane * kVpl;
#pragma unroll
    for (int c = 0; c < kVpl; ++c) a[c] = st.acc[i][c];
    if (lane == 0) {
      m[mi(p)] = st.m[i];
      l[mi(p)] = st.l[i];
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace dst
