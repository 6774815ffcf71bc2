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
//   amax = max |x| (fp32), s = max(amax, 1e-12) * (1 / qmax) with 1 / qmax
//   rounded to fp32 (XLA compiles the Pallas kernel's division by the
//   constant qmax to this multiply, so these are the JAX kernel's scales),
//   int8: q = clip(rint(x / s), -127, 127)      (round half to even)
//   fp8:  q = fp8(x / s), e4m3fn (qmax 448) or e5m2 (qmax 57344), the
//         round-to-nearest-even cast without saturation that torch's
//         `.to(float8_*)` and ml_dtypes share,
// and dequantize: out = dtype(float(q) * s) for int8, e4m3 or e5m2 q.
// x / s is an IEEE division (this source is built without fast math), so
// the bytes and scales equal the plain PyTorch version's and JAX's.
//
// Bound on H100: bytes (a few operations per element).  Design: one CTA of
// 256 threads per row; the amax pass reads the row with coalesced loads and
// reduces by warp shuffles, the second pass reads it again (now from L1 /
// L2) and writes q.  A row never leaves its CTA, so no cross-CTA reduction
// is needed.  The simple first version: scalar loads.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dstk {

typedef __nv_bfloat16 bf16;
constexpr int kThreads = 256;

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

__device__ __forceinline__ float block_max(float v) {
  __shared__ float part[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = v;
  __syncthreads();
  v = part[0];
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i) v = fmaxf(v, part[i]);
  return v;
}

template <typename InT, int Q>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const InT* __restrict__ x, uint8_t* __restrict__ q, float* __restrict__ s,
                     int N, float inv_qmax) {
  const long base = static_cast<long>(blockIdx.x) * N;
  const InT* xr = x + base;
  float amax = 0.f;
  for (int i = threadIdx.x; i < N; i += kThreads) amax = fmaxf(amax, fabsf(to_f(xr[i])));
  amax = block_max(amax);
  const float scale = fmaxf(amax, 1e-12f) * inv_qmax;
  if (threadIdx.x == 0) s[blockIdx.x] = scale;
  uint8_t* qr = q + base;
  for (int i = threadIdx.x; i < N; i += kThreads) {
    const float v = to_f(xr[i]) / scale;
    if constexpr (Q == kInt8) {
      qr[i] = static_cast<uint8_t>(static_cast<int8_t>(fminf(fmaxf(rintf(v), -127.f), 127.f)));
    } else {
      qr[i] = __nv_cvt_float_to_fp8(v, __NV_NOSAT, Q == kE4M3 ? __NV_E4M3 : __NV_E5M2);
    }
  }
}

template <int Q, typename OutT>
__global__ void __launch_bounds__(kThreads)
dequantize_rows_kernel(const uint8_t* __restrict__ q, const float* __restrict__ s,
                       OutT* __restrict__ out, int N) {
  const long base = static_cast<long>(blockIdx.x) * N;
  const float scale = s[blockIdx.x];
  for (int i = threadIdx.x; i < N; i += kThreads)
    out[base + i] = from_f<OutT>(q_to_f<Q>(q[base + i]) * scale);
}

template <typename InT>
cudaError_t quantize_in(const void* x, void* q, float* s, int G, int N, int qfmt,
                        float inv_qmax, cudaStream_t st) {
  const InT* xi = static_cast<const InT*>(x);
  uint8_t* qo = static_cast<uint8_t*>(q);
  switch (qfmt) {
    case kInt8:
      quantize_rows_kernel<InT, kInt8><<<G, kThreads, 0, st>>>(xi, qo, s, N, inv_qmax);
      break;
    case kE4M3:
      quantize_rows_kernel<InT, kE4M3><<<G, kThreads, 0, st>>>(xi, qo, s, N, inv_qmax);
      break;
    case kE5M2:
      quantize_rows_kernel<InT, kE5M2><<<G, kThreads, 0, st>>>(xi, qo, s, N, inv_qmax);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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
