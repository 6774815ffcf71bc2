// Host-side fused AdamW / Lion for offloaded optimizer state: the port's
// own copy of the JAX package's csrc/adam/host_adam.cpp, unchanged in its
// arithmetic, so the two packages' host updates agree bit for bit.
//
// Counterpart of the reference's AVX CPU Adam (csrc/adam/cpu_adam.cpp +
// csrc/includes/simd.h): the hot loop is written so the compiler
// auto-vectorises it at -O3 -march=native, with OpenMP threads across
// chunks.  The NVMe tier (runtime/offload.py) runs it on the host, where
// the masters and moments live.  fp32 master params, fp32 m / v, gradients
// fp32 or bf16 (the bf16 bits shifted into an fp32, no copy).  Not a port
// of a Pallas kernel: the JAX package runs this same C++ on the host.
//
// C ABI for ctypes (ops/op_builder.py); no torch, no pybind11.

#include <cmath>
#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// AdamW step on contiguous fp32 arrays.
// step is the 1-based step count AFTER increment (bias correction uses it).
void host_adamw_fp32(float *param, const float *grad, float *m, float *v,
                     int64_t n, float lr, float beta1, float beta2, float eps,
                     float weight_decay, int64_t step) {
  const float bc1 = 1.0f - std::pow(beta1, (float)step);
  const float bc2 = 1.0f - std::pow(beta2, (float)step);
  const float one_m_b1 = 1.0f - beta1;
  const float one_m_b2 = 1.0f - beta2;
#pragma omp parallel for simd schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const float g = grad[i];
    const float mi = beta1 * m[i] + one_m_b1 * g;
    const float vi = beta2 * v[i] + one_m_b2 * g * g;
    m[i] = mi;
    v[i] = vi;
    const float mhat = mi / bc1;
    const float vhat = vi / bc2;
    param[i] -= lr * (mhat / (std::sqrt(vhat) + eps) + weight_decay * param[i]);
  }
}

// Same but gradients arrive as bf16 (uint16 view) — the layout grads have
// when copied straight off the device.
void host_adamw_bf16grad(float *param, const uint16_t *grad_bf16, float *m,
                         float *v, int64_t n, float lr, float beta1,
                         float beta2, float eps, float weight_decay,
                         int64_t step) {
  const float bc1 = 1.0f - std::pow(beta1, (float)step);
  const float bc2 = 1.0f - std::pow(beta2, (float)step);
  const float one_m_b1 = 1.0f - beta1;
  const float one_m_b2 = 1.0f - beta2;
#pragma omp parallel for simd schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    uint32_t bits = ((uint32_t)grad_bf16[i]) << 16;
    float g;
    std::memcpy(&g, &bits, sizeof(g));
    const float mi = beta1 * m[i] + one_m_b1 * g;
    const float vi = beta2 * v[i] + one_m_b2 * g * g;
    m[i] = mi;
    v[i] = vi;
    const float mhat = mi / bc1;
    const float vhat = vi / bc2;
    param[i] -= lr * (mhat / (std::sqrt(vhat) + eps) + weight_decay * param[i]);
  }
}

// Fused Lion (reference: csrc/lion/) — sign-of-interpolation update.
void host_lion_fp32(float *param, const float *grad, float *m, int64_t n,
                    float lr, float beta1, float beta2, float weight_decay) {
#pragma omp parallel for simd schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const float g = grad[i];
    const float c = beta1 * m[i] + (1.0f - beta1) * g;
    const float upd = (c > 0.0f) ? 1.0f : ((c < 0.0f) ? -1.0f : 0.0f);
    param[i] -= lr * (upd + weight_decay * param[i]);
    m[i] = beta2 * m[i] + (1.0f - beta2) * g;
  }
}

int host_adam_num_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}
}
