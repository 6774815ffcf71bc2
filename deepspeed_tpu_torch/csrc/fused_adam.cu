// Fused AdamW over flat fp32 buffers: one pass that reads p, g, m, v and
// writes p, m, v once per element.
//
// Replaces: deepspeed_tpu/ops/pallas/fused_adam.py `fused_adamw_flat` (:46,
// the `pl.pallas_call` at :60; the update is `_adamw_kernel` :30-43).
//
// What it computes, in fp32, for t = *step (the 1-based update count):
//   m = b1 m + (1 - b1) g
//   v = b2 v + (1 - b2) g^2
//   p = p - lr (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd p)
// optax's adamw (scale_by_adam + add_decayed_weights + scale_by_learning_
// rate), the order of operations of the port's plain version.  1 - b1 and
// 1 - b2 arrive rounded from double, as a Python float meets an fp32 tensor.
// lr (fp32), step (int32) and the fp16 overflow flag `finite` (bool, or
// null) are read from device memory, so the engine's step never waits on
// the host: where *finite is false the kernel writes nothing (the engine
// does not advance the count either).  Any n: there is no TPU tile rule.
//
// Bound on H100: 28 bytes an element (4 fp32 reads, 3 writes) over
// 3.35 TB/s: byte-bound, about 20 flops an element.  Design: a grid-stride
// loop of 16-byte (float4) accesses where all four buffers are 16-byte
// aligned (the engine's flat buffers are), one element a step otherwise;
// each thread works out the bias corrections once.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dst {

struct AdamConsts {
  float b1, b2, c1, c2, eps, wd;  // c1 = 1 - b1, c2 = 1 - b2
};

struct AdamStep {
  float lr, bc1, bc2;  // bc = 1 - b^t
};

__device__ __forceinline__ void adam_elem(float& p, float g, float& m, float& v,
                                          const AdamConsts& a, const AdamStep& st) {
  const float mn = m * a.b1 + g * a.c1;
  const float vn = v * a.b2 + (g * g) * a.c2;
  const float upd = (mn / st.bc1) / (sqrtf(vn / st.bc2) + a.eps) + a.wd * p;
  p = p - st.lr * upd;
  m = mn;
  v = vn;
}

template <bool kVec4>
__global__ void __launch_bounds__(256)
fused_adamw_kernel(float* __restrict__ p, const float* __restrict__ g, float* __restrict__ m,
                   float* __restrict__ v, long long n, const float* __restrict__ lr,
                   const int* __restrict__ step, const bool* __restrict__ finite,
                   AdamConsts a) {
  if (finite != nullptr && !*finite) return;
  const float t = static_cast<float>(*step);
  const AdamStep st{*lr, 1.f - powf(a.b1, t), 1.f - powf(a.b2, t)};
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (kVec4) {
    const long long nv = n / 4;
    for (long long i = first; i < nv; i += stride) {
      float4 pp = reinterpret_cast<float4*>(p)[i];
      const float4 gg = reinterpret_cast<const float4*>(g)[i];
      float4 mm = reinterpret_cast<float4*>(m)[i];
      float4 vv = reinterpret_cast<float4*>(v)[i];
      adam_elem(pp.x, gg.x, mm.x, vv.x, a, st);
      adam_elem(pp.y, gg.y, mm.y, vv.y, a, st);
      adam_elem(pp.z, gg.z, mm.z, vv.z, a, st);
      adam_elem(pp.w, gg.w, mm.w, vv.w, a, st);
      reinterpret_cast<float4*>(p)[i] = pp;
      reinterpret_cast<float4*>(m)[i] = mm;
      reinterpret_cast<float4*>(v)[i] = vv;
    }
    done = nv * 4;
  }
  for (long long i = done + first; i < n; i += stride) {
    float pp = p[i], mm = m[i], vv = v[i];
    adam_elem(pp, g[i], mm, vv, a, st);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
  }
}

}  // namespace dst

// p, g, m, v: n fp32 each on the device (p, m, v updated in place); lr
// fp32 [1], step int32 [1] (t, 1-based), finite bool [1] or null.  c1 / c2
// are 1 - b1 / 1 - b2.  Returns the launch's cudaGetLastError() (non-zero:
// nothing ran).
extern "C" int dst_fused_adamw(float* p, const float* g, float* m, float* v, long long n,
                               const float* lr, const int* step, const bool* finite, float b1,
                               float b2, float c1, float c2, float eps, float wd, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const dst::AdamConsts a{b1, b2, c1, c2, eps, wd};
  const bool vec4 = ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                      reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const int threads = 256;
  const long long work = vec4 ? (n + 3) / 4 : n;
  const int blocks = static_cast<int>(work < 132LL * 16 * threads ? (work + threads - 1) / threads
                                                                  : 132LL * 16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec4) {
    dst::fused_adamw_kernel<true><<<blocks, threads, 0, st>>>(p, g, m, v, n, lr, step, finite, a);
  } else {
    dst::fused_adamw_kernel<false><<<blocks, threads, 0, st>>>(p, g, m, v, n, lr, step, finite, a);
  }
  return cudaGetLastError();
}
