// Per-row (per-group) symmetric quantizers and their dequantizer.
//
// Replaces: deepspeed_tpu/ops/pallas/quant_kernel.py `quantize_int8` (K6a,
// the `pl.pallas_call` at :59), `quantize_fp8` (K6c, :110) and
// `dequantize_int8` (K6b, :82), reached from the quantizer API
// (`ops/quantizer.quantize_int8`, `quantize_fp8`, `dequantize`,
// `fake_quantize_int8`), the counterpart of DeepSpeed's
// `deepspeed.ops.quantizer`.
//
// What it computes, for each row (group) of x [G, N]:
//   amax = max |x| (fp32; a NaN anywhere makes it NaN, as torch's and jnp's
//   max do), s = max(amax, 1e-12) * (1 / qmax) with 1 / qmax rounded to
//   fp32 (XLA compiles the Pallas kernel's division by the constant qmax to
//   this multiply, so these are the JAX kernel's scales; NaN stays NaN),
//   int8: q = clip(rint(x / s), -127, 127)      (round half to even; NaN -> 0)
//   fp8:  q = fp8(x / s), e4m3fn (qmax 448) or e5m2 (qmax 57344), the
//         round-to-nearest-even cast without saturation that torch's
//         `.to(float8_*)` and ml_dtypes share,
// and dequantize: out = dtype(float(q) * s) for int8, e4m3 or e5m2 q.
// x / s is an IEEE division (`__fdiv_rn`; this source is built without fast
// math), so the bytes and scales equal the plain PyTorch version's and JAX's.
//
// Bound on H100: bytes.  [4096, 14336] bf16 -> 8-bit moves 176 MB, 0.0526
// ms at 3.35 TB/s; the arithmetic (about a dozen instructions an element,
// most of them the division) fits under that if the loads keep flowing.
//
// Quantize design (K6a / K6c):
// - one CTA a row; the row is read from device memory once and kept in
//   registers between the amax and the write: chunks of 16 elements (two
//   16-byte loads of bf16 / fp16, four of fp32), CPT chunks a thread, chunk
//   j * T + t for thread t (a 14,336-wide bf16 row: T = 224, CPT = 4, 32
//   registers of data a thread, four CTAs an SM, 112 KB of loads in flight
//   an SM).  Each thread issues all its loads before it reduces anything;
//   the other CTAs of the SM overlap one row's reduction and stores with
//   their loads.
// - q goes out 16 bytes a store (a chunk's 16 codes).  Chunks start where
//   the element index g * N + i is a multiple of 16, so every row's vector
//   loads and stores are aligned for any N; a row's first and last few
//   elements (fewer than 16 each), the chunks past CPT * T of a row wider
//   than the registers hold (two passes, the second from L2) and a tensor
//   whose base is not 16-byte aligned take scalar loads.
// - amax by NaN-propagating max (HMNMX2 on bf16 / fp16 pairs, unsigned max
//   on fp32 |x| bits, REDUX across a warp).
// - the conversions, on a row whose scale is finite (every x finite):
//   |x / s| <= qmax (1 + 2^-23): s >= amax / qmax * (1 - 2^-24)^2, with
//   fp32(1 / qmax) and the product rounded to nearest.  So
//   * int8: rint(x / s) lies in [-127, 127] and needs no clip; it is the
//     low byte of fp32(x / s + 1.5 * 2^23) (a full-rate add that rounds
//     half to even to an integer, instead of a quarter-rate F2I);
//   * fp8: the hardware pair conversion `cvt.rn.satfinite.{e4m3,e5m2}x2.f32`
//     (F2FP, two codes an instruction) equals the cast without saturation:
//     the two differ only above 464 (e4m3: NaN against 448) and above 61440
//     (e5m2: inf against 57344).
//   A row with an inf or NaN (scale inf or NaN; x / s is then +-0 or NaN)
//   takes the element-wise conversion of the reference: the same branch for
//   the whole row, chosen once from the scale.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace dstk {

typedef __nv_bfloat16 bf16;
constexpr int kThreads = 256;   // the dequantizer's CTA
constexpr int kMaxThreads = 256;  // the quantizer's largest CTA
constexpr int kChunk = 16;      // elements a chunk: one 16-byte store of codes

enum Type { kF32 = 0, kBF16 = 1, kF16 = 2 };    // float input / output types
enum QFmt { kInt8 = 0, kE4M3 = 1, kE5M2 = 2 };  // quantized types

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }
template <>
__device__ __forceinline__ __half from_f<__half>(float v) { return __float2half(v); }

template <int Q>
__device__ __forceinline__ float q_to_f(uint8_t b) {
  if constexpr (Q == kInt8) {
    return static_cast<float>(static_cast<int8_t>(b));
  } else if constexpr (Q == kE4M3) {
    __nv_fp8_e4m3 v;
    v.__x = b;
    return static_cast<float>(v);
  } else {
    __nv_fp8_e5m2 v;
    v.__x = b;
    return static_cast<float>(v);
  }
}

// ---------------------------------------------------------------------------
// quantize
// ---------------------------------------------------------------------------
// 16-byte words a chunk of 16 elements takes
template <typename InT>
struct Words {
  static constexpr int kN = sizeof(InT);
};

// |v| as bits: for non-negative floats the unsigned order is the float
// order, and every NaN is above inf, so an unsigned max propagates NaN
__device__ __forceinline__ uint32_t abs_bits(float v) { return __float_as_uint(v) & 0x7fffffffu; }

template <typename InT>
__device__ __forceinline__ uint32_t chunk_amax(const uint4 (&w)[Words<InT>::kN]) {
  constexpr int W = Words<InT>::kN;
  if constexpr (sizeof(InT) == 4) {
    uint32_t m = 0;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      m = max(m, abs_bits(__uint_as_float(w[k].x)));
      m = max(m, abs_bits(__uint_as_float(w[k].y)));
      m = max(m, abs_bits(__uint_as_float(w[k].z)));
      m = max(m, abs_bits(__uint_as_float(w[k].w)));
    }
    return m;
  } else if constexpr (std::is_same<InT, bf16>::value) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(w);
    __nv_bfloat162 m = __habs2(p[0]);
#pragma unroll
    for (int k = 1; k < 4 * W; ++k) m = __hmax2_nan(m, __habs2(p[k]));
    const uint32_t u = *reinterpret_cast<const uint32_t*>(&m);  // both halves >= +0
    return max(u << 16, u & 0xffff0000u);
  } else {
    const __half2* p = reinterpret_cast<const __half2*>(w);
    __half2 m = __habs2(p[0]);
#pragma unroll
    for (int k = 1; k < 4 * W; ++k) m = __hmax2_nan(m, __habs2(p[k]));
    const float2 f = __half22float2(m);
    return max(abs_bits(f.x), abs_bits(f.y));
  }
}

// the 16 elements of a chunk as floats (exact)
template <typename InT>
__device__ __forceinline__ void chunk_floats(const uint4 (&w)[Words<InT>::kN], float (&f)[kChunk]) {
  const uint32_t* u = reinterpret_cast<const uint32_t*>(w);
  if constexpr (sizeof(InT) == 4) {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) f[i] = __uint_as_float(u[i]);
  } else if constexpr (std::is_same<InT, bf16>::value) {
#pragma unroll
    for (int i = 0; i < kChunk / 2; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kChunk / 2; ++i) {
      const float2 t = __half22float2(*reinterpret_cast<const __half2*>(&u[i]));
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
}

// one code, exactly as the reference writes it (any v, NaN included)
template <int Q>
__device__ __forceinline__ uint32_t code1(float v) {
  if constexpr (Q == kInt8) {
    if (v != v) return 0u;  // torch / XLA cast NaN to int8 0
    return static_cast<uint8_t>(static_cast<int8_t>(fminf(fmaxf(rintf(v), -127.f), 127.f)));
  } else {
    return __nv_cvt_float_to_fp8(v, __NV_NOSAT, Q == kE4M3 ? __NV_E4M3 : __NV_E5M2);
  }
}

// four codes packed little-endian, on a finite row (|v| <= qmax (1 + 2^-23))
template <int Q>
__device__ __forceinline__ uint32_t codes4_finite(float a, float b, float c, float d) {
  if constexpr (Q == kInt8) {
    constexpr float kMagic = 12582912.f;  // 1.5 * 2^23: the low byte is rint(v)
    const uint32_t ab = __byte_perm(__float_as_uint(__fadd_rn(a, kMagic)),
                                    __float_as_uint(__fadd_rn(b, kMagic)), 0x0040);
    const uint32_t cd = __byte_perm(__float_as_uint(__fadd_rn(c, kMagic)),
                                    __float_as_uint(__fadd_rn(d, kMagic)), 0x0040);
    return __byte_perm(ab, cd, 0x5410);
  } else {
    // cvt d, hi, lo: the first operand lands in the upper byte
    unsigned short lo, hi;
    if constexpr (Q == kE4M3) {
      asm("cvt.rn.satfinite.e4m3x2.f32 %0, %1, %2;" : "=h"(lo) : "f"(b), "f"(a));
      asm("cvt.rn.satfinite.e4m3x2.f32 %0, %1, %2;" : "=h"(hi) : "f"(d), "f"(c));
    } else {
      asm("cvt.rn.satfinite.e5m2x2.f32 %0, %1, %2;" : "=h"(lo) : "f"(b), "f"(a));
      asm("cvt.rn.satfinite.e5m2x2.f32 %0, %1, %2;" : "=h"(hi) : "f"(d), "f"(c));
    }
    return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
  }
}

template <typename InT, int Q, bool kFinite>
__device__ __forceinline__ uint4 chunk_codes(const uint4 (&w)[Words<InT>::kN], float scale) {
  float f[kChunk];
  chunk_floats<InT>(w, f);
#pragma unroll
  for (int i = 0; i < kChunk; ++i) f[i] = __fdiv_rn(f[i], scale);
  uint32_t out[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (kFinite) {
      out[k] = codes4_finite<Q>(f[4 * k], f[4 * k + 1], f[4 * k + 2], f[4 * k + 3]);
    } else {
      out[k] = code1<Q>(f[4 * k]) | (code1<Q>(f[4 * k + 1]) << 8) |
               (code1<Q>(f[4 * k + 2]) << 16) | (code1<Q>(f[4 * k + 3]) << 24);
    }
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

template <typename InT>
__device__ __forceinline__ void load_chunk(const uint4* src, uint4 (&w)[Words<InT>::kN]) {
#pragma unroll
  for (int k = 0; k < Words<InT>::kN; ++k) w[k] = src[k];
}

__device__ __forceinline__ uint32_t block_max_bits(uint32_t v) {
  __shared__ uint32_t part[kMaxThreads / 32];
  v = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  v = part[0];
  for (int i = 1; i < static_cast<int>(blockDim.x >> 5); ++i) v = max(v, part[i]);
  return v;
}

// one CTA of blockDim.x (a multiple of 32, <= kMaxThreads) threads a row;
// vec: x and q are 16-byte aligned (else every element is scalar)
template <typename InT, int Q, int CPT>
__global__ void __launch_bounds__(kMaxThreads)
quantize_rows_kernel(const InT* __restrict__ x, uint8_t* __restrict__ q, float* __restrict__ s,
                     int N, float inv_qmax, int vec) {
  constexpr int W = Words<InT>::kN;
  const int T = blockDim.x, t = threadIdx.x;
  const long base = static_cast<long>(blockIdx.x) * N;
  const InT* xr = x + base;
  uint8_t* qr = q + base;
  // scalar head up to the first element whose global index is a multiple
  // of 16, chunks, scalar tail
  const int head = vec ? min(N, static_cast<int>((kChunk - (base & (kChunk - 1))) & (kChunk - 1)))
                       : N;
  const int nc = (N - head) / kChunk;
  const int tail = head + nc * kChunk;
  const uint4* xv = reinterpret_cast<const uint4*>(xr + head);
  uint4* qv = reinterpret_cast<uint4*>(qr + head);

  uint4 w[CPT][W];
  uint32_t am = 0;
#pragma unroll
  for (int j = 0; j < CPT; ++j)
    if (j * T + t < nc) load_chunk<InT>(xv + (j * T + t) * W, w[j]);
#pragma unroll
  for (int j = 0; j < CPT; ++j)
    if (j * T + t < nc) am = max(am, chunk_amax<InT>(w[j]));
  for (int c = CPT * T + t; c < nc; c += T) {  // wider than the registers hold
    uint4 u[W];
    load_chunk<InT>(xv + c * W, u);
    am = max(am, chunk_amax<InT>(u));
  }
  for (int i = t; i < head; i += T) am = max(am, abs_bits(to_f(xr[i])));
  for (int i = tail + t; i < N; i += T) am = max(am, abs_bits(to_f(xr[i])));
  const float amax = __uint_as_float(block_max_bits(am));
  const float scale = __fmul_rn(amax < 1e-12f ? 1e-12f : amax, inv_qmax);  // NaN stays NaN
  if (t == 0) s[blockIdx.x] = scale;

  if (isfinite(scale)) {
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      if (j * T + t < nc) qv[j * T + t] = chunk_codes<InT, Q, true>(w[j], scale);
    for (int c = CPT * T + t; c < nc; c += T) {
      uint4 u[W];
      load_chunk<InT>(xv + c * W, u);
      qv[c] = chunk_codes<InT, Q, true>(u, scale);
    }
  } else {
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      if (j * T + t < nc) qv[j * T + t] = chunk_codes<InT, Q, false>(w[j], scale);
    for (int c = CPT * T + t; c < nc; c += T) {
      uint4 u[W];
      load_chunk<InT>(xv + c * W, u);
      qv[c] = chunk_codes<InT, Q, false>(u, scale);
    }
  }
  for (int i = t; i < head; i += T) qr[i] = code1<Q>(__fdiv_rn(to_f(xr[i]), scale));
  for (int i = tail + t; i < N; i += T) qr[i] = code1<Q>(__fdiv_rn(to_f(xr[i]), scale));
}

template <typename InT, int Q>
cudaError_t quantize_q(const InT* x, uint8_t* q, float* s, int G, int N, float inv_qmax,
                       cudaStream_t st) {
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(q) % 16 == 0);
  // the most chunks a row can hold; the fewest chunks a thread (CPT in 1, 2,
  // 4, 8) that keeps the CTA at <= kMaxThreads, the rest streamed
  const int nc = vec ? N / kChunk : 0;
  int cpt = 1;
  while (cpt < 8 && (nc + cpt - 1) / cpt > kMaxThreads) cpt *= 2;
  const int want = vec ? (nc + cpt - 1) / cpt : N;
  const int threads = std::min(kMaxThreads, std::max(32, (want + 31) / 32 * 32));
  const int v = vec;
  switch (cpt) {
    case 1:
      quantize_rows_kernel<InT, Q, 1><<<G, threads, 0, st>>>(x, q, s, N, inv_qmax, v);
      break;
    case 2:
      quantize_rows_kernel<InT, Q, 2><<<G, threads, 0, st>>>(x, q, s, N, inv_qmax, v);
      break;
    case 4:
      quantize_rows_kernel<InT, Q, 4><<<G, threads, 0, st>>>(x, q, s, N, inv_qmax, v);
      break;
    default:
      quantize_rows_kernel<InT, Q, 8><<<G, threads, 0, st>>>(x, q, s, N, inv_qmax, v);
      break;
  }
  return cudaGetLastError();
}

template <typename InT>
cudaError_t quantize_in(const void* x, void* q, float* s, int G, int N, int qfmt,
                        float inv_qmax, cudaStream_t st) {
  const InT* xi = static_cast<const InT*>(x);
  uint8_t* qo = static_cast<uint8_t*>(q);
  switch (qfmt) {
    case kInt8:
      return quantize_q<InT, kInt8>(xi, qo, s, G, N, inv_qmax, st);
    case kE4M3:
      return quantize_q<InT, kE4M3>(xi, qo, s, G, N, inv_qmax, st);
    case kE5M2:
      return quantize_q<InT, kE5M2>(xi, qo, s, G, N, inv_qmax, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// dequantize (K6b): one CTA of 256 threads a row, scalar loads and stores
// ---------------------------------------------------------------------------
template <int Q, typename OutT>
__global__ void __launch_bounds__(kThreads)
dequantize_rows_kernel(const uint8_t* __restrict__ q, const float* __restrict__ s,
                       OutT* __restrict__ out, int N) {
  const long base = static_cast<long>(blockIdx.x) * N;
  const float scale = s[blockIdx.x];
  for (int i = threadIdx.x; i < N; i += kThreads)
    out[base + i] = from_f<OutT>(q_to_f<Q>(q[base + i]) * scale);
}

template <int Q>
cudaError_t dequantize_q(const void* q, const float* s, void* out, int G, int N, int otype,
                         cudaStream_t st) {
  const uint8_t* qi = static_cast<const uint8_t*>(q);
  switch (otype) {
    case kF32:
      dequantize_rows_kernel<Q, float><<<G, kThreads, 0, st>>>(qi, s, static_cast<float*>(out), N);
      break;
    case kBF16:
      dequantize_rows_kernel<Q, bf16><<<G, kThreads, 0, st>>>(qi, s, static_cast<bf16*>(out), N);
      break;
    case kF16:
      dequantize_rows_kernel<Q, __half><<<G, kThreads, 0, st>>>(qi, s, static_cast<__half*>(out), N);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace dstk

// x [G, N] of type itype (0 fp32, 1 bf16, 2 fp16) -> q [G, N] (qfmt 0 int8,
// 1 e4m3fn, 2 e5m2) and s [G] fp32; inv_qmax: 1 / qmax in fp32 (qmax 127,
// 448, 57344)
extern "C" int dst_quantize_rows(const void* x, void* q, float* s, int G, int N, int itype,
                                 int qfmt, float inv_qmax, void* stream) {
  if (G <= 0 || N <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (itype) {
    case dstk::kF32:
      return dstk::quantize_in<float>(x, q, s, G, N, qfmt, inv_qmax, st);
    case dstk::kBF16:
      return dstk::quantize_in<dstk::bf16>(x, q, s, G, N, qfmt, inv_qmax, st);
    case dstk::kF16:
      return dstk::quantize_in<__half>(x, q, s, G, N, qfmt, inv_qmax, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// q [G, N] (qfmt as above), s [G] fp32 -> out [G, N] of type otype
extern "C" int dst_dequantize_rows(const void* q, const float* s, void* out, int G, int N,
                                   int qfmt, int otype, void* stream) {
  if (G <= 0 || N <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (qfmt) {
    case dstk::kInt8:
      return dstk::dequantize_q<dstk::kInt8>(q, s, out, G, N, otype, st);
    case dstk::kE4M3:
      return dstk::dequantize_q<dstk::kE4M3>(q, s, out, G, N, otype, st);
    case dstk::kE5M2:
      return dstk::dequantize_q<dstk::kE5M2>(q, s, out, G, N, otype, st);
    default:
      return cudaErrorInvalidValue;
  }
}
