// Dequant-matmul: the serving matmul over a compressed weight.
//
// Replaces: deepspeed_tpu/ops/pallas/quant_matmul.py `quant_matmul` (K4, the
// `pl.pallas_call` at :148; int8 or float8_e4m3fn weights) and
// `quant_matmul_fp6` (K5, :282; FP6 e2m3 codes in three quarter-strided
// uint8 planes), reached from every matmul of a quantized serving engine
// (`ops/quantizer.serving_mm` -> `_mm_local`): q / k / v / o, up / gate /
// down and the vocabulary head, 7 per layer and 1 per forward.
//
// What it computes: y[m, n] = bf16( (sum_k x[m, k] * w[k, n]) * s[n] + bias[n] )
// with x bf16 [M, K] and w decoded exactly from its compressed bytes (int8
// +-127, e4m3 and e2m3 all have at most 8 significant bits, so the decode to
// bf16 is exact).  Products are exact and summed in fp32 on the tensor
// cores; scale and bias are applied in fp32 before the one rounding, the
// Pallas kernel's epilogue (:107-112, :229-234).  FP6 layout: packed row r
// of the planes [3, K/4, N] carries the codes of weight rows r, K/4 + r,
// K/2 + r and 3K/4 + r, so K-step kk decodes plane rows [16 kk, 16 kk + 16)
// into four quarter tiles and contracts quarter i against the x columns
// i K/4 + 16 kk + [0, 16).
//
// Bound on H100: at decode (M = 16 rows) bytes.  Every compressed weight
// byte is read once (K N bytes, 0.75 K N for fp6) for 2 M = 32 flops, far
// under the card's ~295 flops per byte.  At prefill (M = 512) operations.
// Design: one CTA of 4 warps owns a BM x 128 output tile (BM = 16 when
// M <= 16, else 64) and walks K in steps of 64: the x tile (bf16) and the
// weight tile, decoded to bf16 on its way from registers to shared memory,
// then WMMA bf16 16x16x16 products into fp32 fragments.  Global loads are
// 16 bytes a thread and the next step's loads are issued before this step's
// products (a register double buffer).  No dequantized weight is ever
// written to device memory: the weight bytes read are the compressed ones.
// When the output tiles alone leave most of the 132 SMs idle (decode, and
// narrow N such as wk / wv), K is split across CTAs that write fp32 partial
// tiles to a workspace, and a second kernel sums them and applies the
// epilogue.  M tiles vary fastest in the grid, so the CTAs that read one
// weight tile run together and share it through L2.  Ragged M, N and K are
// masked (zero-filled tiles, guarded stores): any shape runs.
//
// The simple first version: WMMA (not wgmma / TMA), one shared-memory
// stage, static split heuristics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace dstq {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;  // 4 warps
constexpr int BN = 128;        // output columns per CTA
constexpr int BK = 64;         // contraction depth per K-step
constexpr int BK4 = BK / 4;    // fp6: plane rows per K-step (4 quarters x 16)
constexpr int LDA = BK + 8;    // shared-memory row pitches (elements); the
constexpr int LDB = BN + 8;    // padding spreads rows over banks and keeps
constexpr int LDC = BN + 4;    // WMMA's 32-byte pointer alignment

enum Fmt { kInt8 = 0, kE4M3 = 1, kFP6 = 2 };

template <int BM>
struct Tile {
  static constexpr int kWarpsM = BM >= 32 ? 2 : 1;
  static constexpr int kWarpsN = 4 / kWarpsM;
  static constexpr int kFM = BM / kWarpsM / 16;  // 16x16 fragments per warp
  static constexpr int kFN = BN / kWarpsN / 16;
  static constexpr int kXChunks = BM * BK / 8 / kThreads;  // 16-byte x chunks a thread
  static constexpr size_t kSmemAB = sizeof(bf16) * (BM * LDA + BK * LDB);
  static constexpr size_t kSmemC = sizeof(float) * BM * LDC;
  static constexpr size_t kSmem = kSmemAB > kSmemC ? kSmemAB : kSmemC;
};

// Exact decodes to fp32 by bit placement, then bf16 by truncation (every
// value has at most 8 significant bits, so dropping the low 16 bits of the
// fp32 word is exact).  int8: the 2^23 magic, float(2^23 + (b ^ 0x80)) -
// (2^23 + 128) = b.  e4m3 (s eeee mmm, bias 7) and e2m3 (s ee mmm, bias 1):
// the sign to bit 31 and the exponent and mantissa bits to bits 20-30 read
// as an fp32 (a denormal when the exponent is 0, which this source keeps:
// no flush to zero), times 2^(127 - bias).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ float int8_f(uint32_t word, int k) {
  const uint32_t sel = 0x7650u + k;  // byte k of word, then 0x00 0x00 0x4B
  return __uint_as_float(__byte_perm(word ^ 0x80808080u, 0x4B000000u, sel)) - 8388736.f;
}

__device__ __forceinline__ float e4m3_f(uint32_t b) {
  return __uint_as_float(((b & 0x80u) << 24) | ((b & 0x7Fu) << 20)) * 0x1p120f;
}

__device__ __forceinline__ float fp6_f(uint32_t c) {
  return __uint_as_float(((c & 0x20u) << 26) | ((c & 0x1Fu) << 20)) * 0x1p126f;
}

// 16 weight bytes -> 16 bf16 (int8 or e4m3), as 8 bf16x2 words
template <int FMT>
__device__ __forceinline__ void decode16(const uint4& in, uint32_t (&out)[8]) {
  const uint32_t w[4] = {in.x, in.y, in.z, in.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float f[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      f[k] = FMT == kInt8 ? int8_f(w[j], k) : e4m3_f((w[j] >> (8 * k)) & 0xFFu);
    out[2 * j] = pack_bf16x2(f[0], f[1]);
    out[2 * j + 1] = pack_bf16x2(f[2], f[3]);
  }
}

// 8 bf16 of one x row starting at column col0, of which the first n lie in
// the matrix (the rest are zero)
__device__ __forceinline__ uint4 load_x8(const bf16* row, long col0, int n, bool vec) {
  if (vec && n == 8) return *reinterpret_cast<const uint4*>(row + col0);
  union {
    uint4 u;
    bf16 h[8];
  } r;
#pragma unroll
  for (int e = 0; e < 8; ++e) r.h[e] = e < n ? row[col0 + e] : __float2bfloat16(0.f);
  return r.u;
}

// 16 bytes of one weight / plane row starting at p, of which the first n
// are valid
__device__ __forceinline__ uint4 load_b16(const uint8_t* p, int n, bool vec) {
  if (vec && n == 16) return *reinterpret_cast<const uint4*>(p);
  union {
    uint4 u;
    uint8_t b[16];
  } r;
#pragma unroll
  for (int e = 0; e < 16; ++e) r.b[e] = e < n ? p[e] : 0;
  return r.u;
}

__device__ __forceinline__ void store_bf16x16(bf16* dst, const uint32_t (&v)[8]) {
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(v[4], v[5], v[6], v[7]);
}

template <int FMT, int BM>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ w,
           const float* __restrict__ scale, const float* __restrict__ bias,
           bf16* __restrict__ y, float* __restrict__ ws, int M, int N, int K,
           int steps_per_split, bool xvec, bool wvec) {
  typedef Tile<BM> T;
  __shared__ __align__(128) unsigned char smem[T::kSmem];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [BM][LDA]
  bf16* Bs = As + BM * LDA;                  // [BK][LDB]
  float* Cs = reinterpret_cast<float*>(smem);  // [BM][LDC], after the K loop

  const int tid = threadIdx.x, warp = tid / 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int K4 = K / 4;
  const int steps = FMT == kFP6 ? (K4 + BK4 - 1) / BK4 : (K + BK - 1) / BK;
  const int kb0 = blockIdx.z * steps_per_split;
  const int kb1 = min(steps, kb0 + steps_per_split);

  uint4 xr[T::kXChunks];
  uint4 wr[4];  // int8 / e4m3: 4 row chunks; fp6: the 3 planes of one row chunk

  auto load_step = [&](int kk) {
#pragma unroll
    for (int i = 0; i < T::kXChunks; ++i) {
      const int idx = tid + i * kThreads, r = idx / 8, j0 = (idx % 8) * 8;
      long col0;
      long lim;
      if (FMT == kFP6) {  // quarter j0 / 16 of the step
        const long base = static_cast<long>(j0 / 16) * K4;
        col0 = base + kk * BK4 + j0 % 16;
        lim = base + K4;
      } else {
        col0 = static_cast<long>(kk) * BK + j0;
        lim = K;
      }
      const int n = m0 + r < M ? static_cast<int>(max(0L, min(8L, lim - col0))) : 0;
      xr[i] = load_x8(x + static_cast<long>(m0 + r) * K, col0, n, xvec);
    }
    const int c0 = (tid % 8) * 16;
    const int nc = max(0, min(16, N - (n0 + c0)));
    if (FMT == kFP6) {
      const int r = kk * BK4 + tid / 8;
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const uint8_t* src = w + (static_cast<long>(p) * K4 + r) * N + n0 + c0;
        wr[p] = load_b16(src, r < K4 ? nc : 0, wvec);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = kk * BK + tid / 8 + 16 * i;
        wr[i] = load_b16(w + static_cast<long>(r) * N + n0 + c0, r < K ? nc : 0, wvec);
      }
    }
  };

  auto store_step = [&]() {
#pragma unroll
    for (int i = 0; i < T::kXChunks; ++i) {
      const int idx = tid + i * kThreads;
      *reinterpret_cast<uint4*>(As + (idx / 8) * LDA + (idx % 8) * 8) = xr[i];
    }
    const int c0 = (tid % 8) * 16;
    if (FMT == kFP6) {
      const uint8_t* b0 = reinterpret_cast<const uint8_t*>(&wr[0]);
      const uint8_t* b1 = reinterpret_cast<const uint8_t*>(&wr[1]);
      const uint8_t* b2 = reinterpret_cast<const uint8_t*>(&wr[2]);
      uint32_t v[4][8];  // quarter q: 16 bf16 as 8 bf16x2 words
#pragma unroll
      for (int e = 0; e < 16; e += 2) {
        float f[4][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t a0 = b0[e + h], a1 = b1[e + h], a2 = b2[e + h];
          f[0][h] = fp6_f(a0 >> 2);
          f[1][h] = fp6_f(((a0 & 3u) << 4) | (a1 >> 4));
          f[2][h] = fp6_f(((a1 & 15u) << 2) | (a2 >> 6));
          f[3][h] = fp6_f(a2 & 63u);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q][e / 2] = pack_bf16x2(f[q][0], f[q][1]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) store_bf16x16(Bs + (q * BK4 + tid / 8) * LDB + c0, v[q]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t v[8];
        decode16<FMT>(wr[i], v);
        store_bf16x16(Bs + (tid / 8 + 16 * i) * LDB + c0, v);
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::kFM][T::kFN];
#pragma unroll
  for (int i = 0; i < T::kFM; ++i)
#pragma unroll
    for (int j = 0; j < T::kFN; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const int wm = (warp / T::kWarpsN) * T::kFM * 16;
  const int wn = (warp % T::kWarpsN) * T::kFN * 16;

  if (kb0 < kb1) load_step(kb0);
  for (int kk = kb0; kk < kb1; ++kk) {
    store_step();
    __syncthreads();
    if (kk + 1 < kb1) load_step(kk + 1);  // in flight during the products
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[T::kFM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
#pragma unroll
      for (int i = 0; i < T::kFM; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm + 16 * i) * LDA + ks, LDA);
#pragma unroll
      for (int j = 0; j < T::kFN; ++j) {
        wmma::load_matrix_sync(fb, Bs + ks * LDB + wn + 16 * j, LDB);
#pragma unroll
        for (int i = 0; i < T::kFM; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < T::kFM; ++i)
#pragma unroll
    for (int j = 0; j < T::kFN; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * LDC + wn + 16 * j, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  const bool split = gridDim.z > 1;
  for (int idx = tid; idx < BM * BN; idx += kThreads) {
    const int r = idx / BN, c = idx % BN, m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    const float v = Cs[r * LDC + c];
    const long o = static_cast<long>(m) * N + n;
    if (split) {
      ws[static_cast<long>(blockIdx.z) * M * N + o] = v;
    } else {
      float out = v * scale[n];
      if (bias) out += bias[n];
      y[o] = __float2bfloat16(out);
    }
  }
}

// sum of the split-K partial tiles, then the fp32 epilogue
__global__ void qmm_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ scale,
                                  const float* __restrict__ bias, bf16* __restrict__ y, int M,
                                  int N, int splits) {
  const long total = static_cast<long>(M) * N;
  for (long o = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x; o < total;
       o += static_cast<long>(gridDim.x) * blockDim.x) {
    float v = 0.f;
    for (int z = 0; z < splits; ++z) v += ws[z * total + o];
    const int n = static_cast<int>(o % N);
    float out = v * scale[n];
    if (bias) out += bias[n];
    y[o] = __float2bfloat16(out);
  }
}

template <int FMT, int BM>
cudaError_t launch(const void* x, const void* w, const float* s, const float* bias, void* y,
                   float* ws, int M, int N, int K, int splits, int per, bool xvec, bool wvec,
                   cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
  qmm_kernel<FMT, BM><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(w), s, bias,
      static_cast<bf16*>(y), ws, M, N, K, per, xvec, wvec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long total = static_cast<long>(M) * N;
  const int blocks = static_cast<int>(min((total + 255) / 256, 65536L));
  qmm_reduce_kernel<<<blocks, 256, 0, stream>>>(ws, s, bias, static_cast<bf16*>(y), M, N, splits);
  return cudaGetLastError();
}

template <int FMT>
cudaError_t dispatch_bm(const void* x, const void* w, const float* s, const float* bias, void* y,
                        float* ws, int M, int N, int K, int splits, int per, bool xvec, bool wvec,
                        cudaStream_t stream) {
  if (M <= 16) return launch<FMT, 16>(x, w, s, bias, y, ws, M, N, K, splits, per, xvec, wvec, stream);
  return launch<FMT, 64>(x, w, s, bias, y, ws, M, N, K, splits, per, xvec, wvec, stream);
}

}  // namespace dstq

// x [M, K] bf16; w: int8 / e4m3 [K, N] (fmt 0 / 1) or the fp6 planes
// [3, K/4, N] uint8 (fmt 2, K % 4 == 0); s [N] fp32; bias [N] fp32 or null;
// y [M, N] bf16; ws [splits, M, N] fp32 when splits > 1 (else unused), each
// split covering `per` K-steps (64 rows of K, 16 plane rows for fp6).
// xvec / wvec: x rows (and fp6 quarters) and weight rows start 16-byte
// aligned, so whole chunks load as one 16-byte access.
extern "C" int dst_quant_matmul(const void* x, const void* w, const float* s, const float* bias,
                                void* y, float* ws, int M, int N, int K, int fmt, int splits,
                                int per, int xvec, int wvec, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1 || per < 1 || (splits > 1 && !ws) ||
      (fmt == dstq::kFP6 && K % 4) || (N + dstq::BN - 1) / dstq::BN > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case dstq::kInt8:
      return dstq::dispatch_bm<dstq::kInt8>(x, w, s, bias, y, ws, M, N, K, splits, per, xvec, wvec, st);
    case dstq::kE4M3:
      return dstq::dispatch_bm<dstq::kE4M3>(x, w, s, bias, y, ws, M, N, K, splits, per, xvec, wvec, st);
    case dstq::kFP6:
      return dstq::dispatch_bm<dstq::kFP6>(x, w, s, bias, y, ws, M, N, K, splits, per, xvec, wvec, st);
    default:
      return cudaErrorInvalidValue;
  }
}
