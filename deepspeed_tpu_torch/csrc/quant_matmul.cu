// Dequant-matmul: the serving matmul over a compressed weight, on Hopper's
// tensor cores (wgmma).
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
// K/2 + r and 3K/4 + r.
//
// Bound on H100: at decode (M = 16 rows) bytes: every compressed weight byte
// is read once (K N bytes, 0.75 K N for fp6) for 2 M = 32 flops, far under
// the card's ~295 flops per byte, so the kernel must keep enough weight bytes
// in flight to hold HBM busy.  At prefill (M = 512) operations: 2 M K N on
// the bf16 tensor cores, and the decode must hide behind the products.
//
// Design: the product is computed transposed, y^T = W^T x^T, so the weight
// is wgmma's register operand A and never goes through shared memory as
// bf16:
//   - a CTA owns 128 weight columns (the wgmma's M: 64 for each of two
//     consumer warpgroups) and BT tokens (the wgmma's N: 16 at decode, 64 /
//     128 / 256 at prefill, chosen by the wrapper), and walks K in stages of
//     64 (fp6: 16 packed rows = 4 quarters of 16);
//   - a producer warpgroup fills a ring of ST stages in shared memory with
//     each stage's raw weight bytes (16-byte chunks XOR-swizzled by row) and
//     its x tile (the 128 B swizzle wgmma's K-major descriptor reads) by
//     cp.async; each copy arrives on the stage's "full" mbarrier when it
//     lands (cp.async.mbarrier.arrive), so no thread waits on a copy and up
//     to ST stages are in flight (decode: 8 stages, 64 KB of weight bytes a
//     CTA, two CTAs an SM);
//   - each consumer warp reads its 16 weight columns' bytes with
//     ldmatrix.trans over byte PAIRS taken as b16: a thread receives
//     w[k0, 2p], w[k0, 2p + 1], w[k0 + 1, 2p], w[k0 + 1, 2p + 1] (k0 =
//     2 (lane % 4), p = lane / 4), so fragment row r of the warp's 16 is
//     weight column 2 (r % 8) + r / 8 and the bytes split into the A
//     fragment's bf16 pairs by bit placement (no shared-memory round trip of
//     the decoded weight); the epilogue stores columns (2p, 2p + 1) as one
//     bf16 pair.  FP6 reads its three planes the same way; one plane-byte
//     triple decodes to four codes, one per K quarter, which feed four k16
//     products against the x columns i K/4 + 16 kk + [0, 16) (quarter i of
//     the stage's x tile);
//   - a consumer warpgroup decodes a whole stage before its four products
//     (no register of an issued wgmma changes, so ptxas keeps them
//     asynchronous), waits for them and frees the slot on the stage's
//     "empty" mbarrier; the two consumer warpgroups and the producer run
//     apart, held together only by the ring.  At 128 and 256 tokens (one
//     CTA an SM) the producer hands registers to the consumers' accumulators
//     (setmaxnreg);
//   - token tiles vary fastest in the grid, so the CTAs that read one weight
//     tile run together and share it through L2; when the output tiles alone
//     leave the SMs short of work (decode, narrow N such as wk / wv), K is
//     split across CTAs that write fp32 partial tiles to a workspace, and a
//     second kernel sums them and applies the epilogue.
// Ragged M, N and K are masked (zero-filled tiles, guarded stores): any shape
// runs; rows or weights whose addresses are not 16-byte aligned load through
// registers instead of cp.async.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace dstq {

using dst::bf16;
using namespace dst::tc;

enum Fmt { kInt8 = 0, kE4M3 = 1, kFP6 = 2 };

constexpr int kNWG = 2;          // consumer warpgroups a CTA
constexpr int kConsumers = 128 * kNWG;
constexpr int kProducers = 128;  // the producer warpgroup
constexpr int kThreads = kConsumers + kProducers;
constexpr int BN = 64 * kNWG;    // weight columns per CTA
// Registers at one CTA an SM (token tiles 128 and 256).  A kernel that uses
// setmaxnreg is given its launch bound's 168 a thread (65536 / 384, rounded
// down to 8); the producers drop to 88 and hand (168 - 88) x 128 registers
// to the consumers' accumulators, which rise to 208: (208 - 168) x 256, the
// same number, so neither waits.  chip_smoke.py's sass phase checks the 168.
constexpr int kLaunchRegs = 168, kProducerRegs = 88, kConsumerRegs = 208;
static_assert((kLaunchRegs - kProducerRegs) * kProducers ==
                  (kConsumerRegs - kLaunchRegs) * kConsumers,
              "setmaxnreg: the producers' release must equal the consumers' request");
constexpr int BK = 64;           // contraction depth per stage
constexpr int BK4 = BK / 4;      // fp6: plane rows per stage (4 quarters x 16)

// Stage s of the ring: the x tile [BT][64] bf16 (128 B a row, swizzled),
// then the raw weight tile [WROWS][128] bytes (int8 / e4m3: 64 K rows; fp6:
// the three planes' 16 rows, plane p at rows 16 p ..).  Both are multiples
// of the 1024-byte swizzle atom.
template <int FMT, int BT>
struct Plan {
  static constexpr int ST = BT <= 16 ? 8 : BT <= 64 ? 6 : 5;
  static constexpr int WROWS = FMT == kFP6 ? 3 * BK4 : BK;
  static constexpr int XBYTES = BT * 128, WBYTES = WROWS * BN;
  static constexpr int STAGE = XBYTES + WBYTES;
  // + a full and an empty mbarrier a stage
  static constexpr size_t SMEM = 1024 + static_cast<size_t>(ST) * (STAGE + 16);
  // CTAs an SM holds (caps the registers): TOKEN_TILES[BT] in
  // ops/kernels/quant_matmul.py, whose K split keeps the grid resident.
  static constexpr int MIN_CTAS = BT <= 64 ? 2 : 1;
};

// ---------------------------------------------------------------------------
// exact decodes.  int8: the 2^23 magic, float(2^23 + (b ^ 0x80)) - (2^23 +
// 128) = b, whose fp32 high half is the bf16 (8 significant bits).  e4m3
// (s eeee mmm, bias 7) and e2m3 (s ee mmm, bias 1), two codes at a time: the
// sign to bit 15 and the exponent and mantissa bits to bits 4-10 of each
// bf16 half (a subnormal bf16 when the exponent is 0: bf16 arithmetic keeps
// subnormals), then one bf16x2 multiply by 2^(127 - bias).  Every value and
// product is exact.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t hi_halves(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ float int8_f(uint32_t word, int k) {
  const uint32_t sel = 0x7650u + k;  // byte k of word, then 0x00 0x00 0x4B
  return __uint_as_float(__byte_perm(word ^ 0x80808080u, 0x4B000000u, sel)) - 8388736.f;
}

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// One ldmatrix.trans word (bytes w[k0, 2p], w[k0, 2p + 1], w[k0 + 1, 2p],
// w[k0 + 1, 2p + 1]) -> the bf16 pairs of fragment rows p (column 2p: bytes
// 0 and 2) and p + 8 (column 2p + 1: bytes 1 and 3), each (k0, k0 + 1).
template <int FMT>
__device__ __forceinline__ void split_word(uint32_t word, uint32_t& row_p, uint32_t& row_p8) {
  if (FMT == kInt8) {
    row_p = hi_halves(int8_f(word, 0), int8_f(word, 2));
    row_p8 = hi_halves(int8_f(word, 1), int8_f(word, 3));
  } else if (FMT == kE4M3) {
    const uint32_t two120 = 0x7B807B80u;  // bf16x2 (2^120, 2^120)
    row_p = mul_bf16x2(((word << 8) & 0x80008000u) | ((word << 4) & 0x07F007F0u), two120);
    row_p8 = mul_bf16x2((word & 0x80008000u) | ((word >> 4) & 0x07F007F0u), two120);
  } else {  // fp6 codes, one a byte
    const uint32_t two126 = 0x7E807E80u;  // bf16x2 (2^126, 2^126)
    row_p = mul_bf16x2(((word << 10) & 0x80008000u) | ((word << 4) & 0x01F001F0u), two126);
    row_p8 = mul_bf16x2(((word << 2) & 0x80008000u) | ((word >> 4) & 0x01F001F0u), two126);
  }
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t addr, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// Byte offset of the 16-byte chunk c of row r in a raw weight tile.
__device__ __forceinline__ int wchunk(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// The A fragments of the stage's four k16 steps for this thread's warp
// (weight columns 16 chunk .. 16 chunk + 15 of the CTA's 128).
template <int FMT>
__device__ __forceinline__ void decode_stage(const unsigned char* wt, int chunk, int lane,
                                             uint32_t (&a)[4][4]) {
  const uint32_t base = smem_u32(wt);
  if (FMT == kFP6) {
    // rows 0-31: plane 0 (k 0-7, 8-15), plane 1 (k 0-7, 8-15); rows 32-47: plane 2
    uint32_t p01[4], p2[2];
    ldsm_x4_t(base + wchunk(lane, chunk), p01);
    ldsm_x2_t(base + wchunk(32 + lane % 16, chunk), p2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // packed rows 0-7, then 8-15
      const uint32_t b0 = p01[h], b1 = p01[2 + h], b2 = p2[h];
      const uint32_t c[4] = {(b0 >> 2) & 0x3F3F3F3Fu,
                             ((b0 & 0x03030303u) << 4) | ((b1 >> 4) & 0x0F0F0F0Fu),
                             ((b1 & 0x0F0F0F0Fu) << 2) | ((b2 >> 6) & 0x03030303u),
                             b2 & 0x3F3F3F3Fu};
#pragma unroll
      for (int q = 0; q < 4; ++q) split_word<FMT>(c[q], a[q][2 * h], a[q][2 * h + 1]);
    }
  } else {
    uint32_t r[2][4];  // k rows 0-31 (steps 0, 1), 32-63 (steps 2, 3)
    ldsm_x4_t(base + wchunk(lane, chunk), r[0]);
    ldsm_x4_t(base + wchunk(32 + lane, chunk), r[1]);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      split_word<FMT>(r[s / 2][2 * (s % 2)], a[s][0], a[s][1]);
      split_word<FMT>(r[s / 2][2 * (s % 2) + 1], a[s][2], a[s][3]);
    }
  }
}

// 8 bf16 of one x row starting at column col0, of which the first n lie in
// the matrix (the rest are zero)
__device__ __forceinline__ uint4 load_x8(const bf16* row, long col0, int n) {
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
__device__ __forceinline__ uint4 load_b16(const uint8_t* p, int n) {
  union {
    uint4 u;
    uint8_t b[16];
  } r;
#pragma unroll
  for (int e = 0; e < 16; ++e) r.b[e] = e < n ? p[e] : 0;
  return r.u;
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// mbarriers (shared::cta): init, arrive, wait for the phase of the given parity
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

template <int FMT, int BT>
__global__ void __launch_bounds__(kThreads, Plan<FMT, BT>::MIN_CTAS)
qmm_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ w,
           const float* __restrict__ scale, const float* __restrict__ bias,
           bf16* __restrict__ y, float* __restrict__ ws, int M, int N, int K,
           int steps_per_split, bool xvec, bool wvec) {
  typedef Plan<FMT, BT> P;
  constexpr int ST = P::ST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(align_1024(smem_raw));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST * P::STAGE);  // [ST]
  uint64_t* empty = full + ST;                                         // [ST]

  const int tid = threadIdx.x, lane = tid % 32;
  const int m0 = blockIdx.x * BT, n0 = blockIdx.y * BN;
  const int K4 = K / 4;
  const int steps = FMT == kFP6 ? (K4 + BK4 - 1) / BK4 : (K + BK - 1) / BK;
  const int kb0 = blockIdx.z * steps_per_split;
  const int nst = min(steps, kb0 + steps_per_split) - kb0;  // >= 1: no empty split

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + i, kProducers);        // every producer thread
      mbar_init(empty + i, kConsumers / 32);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer warpgroup: thread p copies the x chunks (rows p / 8 + 16 j,
    // 16-byte group p % 8) and the weight chunks (rows p / 8 + 16 j, chunk
    // p % 8) of each stage into its ring slot, zero-filled outside the
    // matrix, and arrives on the stage's full barrier when its copies have
    // landed (cp.async.mbarrier.arrive: no thread waits for them)
    if constexpr (P::MIN_CTAS == 1) setmaxnreg_dec<kProducerRegs>();
    const int p = tid - kConsumers, g = p % 8, r0 = p / 8;
    const int wn = n0 + 16 * g;
    const int wnv = max(0, min(16, N - wn));  // valid bytes of this thread's weight chunks
    const int xrows = max(0, min(BT, M - m0));
    auto produce = [&](int kk, int slot) {
      unsigned char* st = ring + slot * P::STAGE;
      bf16* xs = reinterpret_cast<bf16*>(st);
      long col;
      int nv;
      if (FMT == kFP6) {  // group g: quarter g / 2, packed columns 16 kk + 8 (g % 2) ..
        const int c4 = kk * BK4 + (g % 2) * 8;
        col = static_cast<long>(g / 2) * K4 + c4;
        nv = max(0, min(8, K4 - c4));
      } else {
        const int c = kk * BK + g * 8;
        col = c;
        nv = max(0, min(8, K - c));
      }
      const bf16* xr = x + static_cast<long>(m0 + r0) * K + col;
      if (xvec) {
#pragma unroll
        for (int j = 0; j < BT / 16; ++j) {
          const int r = r0 + 16 * j;
          const bool ok = nv > 0 && r < xrows;
          cp_async16(smem_u32(xs + r * 64 + ((g ^ (r & 7)) << 3)),
                     ok ? xr + static_cast<long>(16 * j) * K : x, ok);
        }
      } else {
#pragma unroll 1
        for (int j = 0; j < BT / 16; ++j) {
          const int r = r0 + 16 * j;
          const int n = r < xrows ? nv : 0;
          *reinterpret_cast<uint4*>(xs + r * 64 + ((g ^ (r & 7)) << 3)) =
              n ? load_x8(x + static_cast<long>(m0 + r) * K, col, n) : make_uint4(0, 0, 0, 0);
        }
      }
      unsigned char* wt = st + P::XBYTES;
#pragma unroll
      for (int j = 0; j < P::WROWS / 16; ++j) {
        const int r = r0 + 16 * j;
        long row;
        bool ok;
        if (FMT == kFP6) {  // plane j, packed row 16 kk + r0
          const int pr = kk * BK4 + r0;
          ok = pr < K4;
          row = static_cast<long>(j) * K4 + pr;
        } else {
          const int kr = kk * BK + r;
          ok = kr < K;
          row = kr;
        }
        const int n = ok ? wnv : 0;
        const uint8_t* src = w + row * N + wn;
        unsigned char* dst = wt + wchunk(r, g);
        if (wvec) {
          cp_async16(smem_u32(dst), n ? src : w, n > 0);
        } else {
          *reinterpret_cast<uint4*>(dst) = n ? load_b16(src, n) : make_uint4(0, 0, 0, 0);
        }
      }
    };
    const bool async = xvec && wvec;  // else some chunks went through registers
    int slot = 0, phase = 0;
    for (int s = 0; s < nst; ++s) {
      if (s >= ST) mbar_wait(empty + slot, phase ^ 1);  // the consumers are done with s - ST
      produce(kb0 + s, slot);
      if (async) {
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                         smem_u32(full + slot))
                     : "memory");
      } else {  // the stores are this thread's own: release them with the arrive
        cp_async_wait_all();
        mbar_arrive(full + slot);
      }
      if (++slot == ST) {
        slot = 0;
        phase ^= 1;
      }
    }
    cp_async_wait_all();
    return;
  }

  // the consumer warpgroups: wait for a stage, decode this warp's weight
  // columns into A fragments, four k16 products against the x tile, release
  // the slot
  if constexpr (P::MIN_CTAS == 1) setmaxnreg_inc<kConsumerRegs>();
  const int wg = tid / 128, warp = (tid % 128) / 32;
  const int chunk = 4 * wg + warp;  // this warp's 16 weight columns
  float acc[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) acc[i] = 0.f;
  int slot = 0, phase = 0;
  for (int s = 0; s < nst; ++s) {
    mbar_wait(full + slot, phase);
    fence_async_smem();  // the producers' copies of x, to the products' async proxy
    const unsigned char* st = ring + slot * P::STAGE;
    uint32_t a[4][4];
    decode_stage<FMT>(st + P::XBYTES, chunk, lane, a);
    wgmma_fence();
    const bf16* xs = reinterpret_cast<const bf16*>(st);
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_rs<BT, 0>(acc, a[k], desc_k<BT>(xs, 0, k), 1);
    wgmma_commit();
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + slot);
    if (++slot == ST) {
      slot = 0;
      phase ^= 1;
    }
  }
  fence_regs(acc);

  // thread (warp, lane) holds columns n, n + 1 (fragment rows p, p + 8) for
  // tokens m0 + 8 i + 2 (lane % 4) + c: acc[4 i + c] and acc[4 i + 2 + c]
  const int n = n0 + 64 * wg + 16 * warp + 2 * (lane / 4);
  if (n >= N) return;
  const bool pair = n + 1 < N && N % 2 == 0;
  const bool split = gridDim.z > 1;
  float s0 = 0.f, s1 = 0.f, b0 = 0.f, b1 = 0.f;
  if (!split) {
    s0 = scale[n];
    s1 = n + 1 < N ? scale[n + 1] : 0.f;
    if (bias) {
      b0 = bias[n];
      b1 = n + 1 < N ? bias[n + 1] : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < BT / 8; ++i) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int m = m0 + 8 * i + 2 * (lane % 4) + c;
      if (m >= M) continue;
      const float v0 = acc[4 * i + c], v1 = acc[4 * i + 2 + c];
      const long o = static_cast<long>(m) * N + n;
      if (split) {
        float* dst = ws + static_cast<long>(blockIdx.z) * M * N + o;
        if (pair) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (n + 1 < N) dst[1] = v1;
        }
      } else {
        const float o0 = v0 * s0 + b0, o1 = v1 * s1 + b1;
        if (pair) {
          *reinterpret_cast<uint32_t*>(y + o) = pack_bf16(o0, o1);
        } else {
          y[o] = __float2bfloat16(o0);
          if (n + 1 < N) y[o + 1] = __float2bfloat16(o1);
        }
      }
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

template <int FMT, int BT>
cudaError_t launch(const void* x, const void* w, const float* s, const float* bias, void* y,
                   float* ws, int M, int N, int K, int splits, int per, bool xvec, bool wvec,
                   cudaStream_t stream) {
  typedef Plan<FMT, BT> P;
  cudaError_t err = dst::allow_smem(qmm_kernel<FMT, BT>, P::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BT - 1) / BT, (N + BN - 1) / BN, splits);
  qmm_kernel<FMT, BT><<<grid, kThreads, P::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(w), s, bias,
      static_cast<bf16*>(y), ws, M, N, K, per, xvec, wvec);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long total = static_cast<long>(M) * N;
  const int blocks = static_cast<int>(min((total + 255) / 256, 65536L));
  qmm_reduce_kernel<<<blocks, 256, 0, stream>>>(ws, s, bias, static_cast<bf16*>(y), M, N, splits);
  return cudaGetLastError();
}

// The cases are the token tiles of ops/kernels/quant_matmul.py's TOKEN_TILES.
template <int FMT>
cudaError_t dispatch_bt(int bt, const void* x, const void* w, const float* s, const float* bias,
                        void* y, float* ws, int M, int N, int K, int splits, int per, bool xvec,
                        bool wvec, cudaStream_t st) {
  switch (bt) {
    case 16: return launch<FMT, 16>(x, w, s, bias, y, ws, M, N, K, splits, per, xvec, wvec, st);
    case 64: return launch<FMT, 64>(x, w, s, bias, y, ws, M, N, K, splits, per, xvec, wvec, st);
    case 128: return launch<FMT, 128>(x, w, s, bias, y, ws, M, N, K, splits, per, xvec, wvec, st);
    case 256: return launch<FMT, 256>(x, w, s, bias, y, ws, M, N, K, splits, per, xvec, wvec, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace dstq

// x [M, K] bf16; w: int8 / e4m3 [K, N] (fmt 0 / 1) or the fp6 planes
// [3, K/4, N] uint8 (fmt 2, K % 4 == 0); s [N] fp32; bias [N] fp32 or null;
// y [M, N] bf16; bt the token tile (16, 64, 128 or 256); ws [splits, M, N]
// fp32 when splits > 1 (else unused), each split covering `per` K-steps (64
// rows of K, 16 plane rows for fp6) and none of them empty.  xvec / wvec: x
// rows (and fp6 quarters) and weight rows start 16-byte aligned, so whole
// chunks load with cp.async.
extern "C" int dst_quant_matmul(const void* x, const void* w, const float* s, const float* bias,
                                void* y, float* ws, int M, int N, int K, int fmt, int bt,
                                int splits, int per, int xvec, int wvec, void* stream) {
  const int steps = fmt == dstq::kFP6 ? (K / 4 + dstq::BK4 - 1) / dstq::BK4
                                      : (K + dstq::BK - 1) / dstq::BK;
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1 || per < 1 || (splits > 1 && !ws) ||
      (fmt == dstq::kFP6 && K % 4) || (N + dstq::BN - 1) / dstq::BN > 65535 || splits > 65535 ||
      static_cast<long>(splits - 1) * per >= steps || static_cast<long>(splits) * per < steps)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case dstq::kInt8:
      return dstq::dispatch_bt<dstq::kInt8>(bt, x, w, s, bias, y, ws, M, N, K, splits, per, xvec,
                                            wvec, st);
    case dstq::kE4M3:
      return dstq::dispatch_bt<dstq::kE4M3>(bt, x, w, s, bias, y, ws, M, N, K, splits, per, xvec,
                                            wvec, st);
    case dstq::kFP6:
      return dstq::dispatch_bt<dstq::kFP6>(bt, x, w, s, bias, y, ws, M, N, K, splits, per, xvec,
                                           wvec, st);
    default:
      return cudaErrorInvalidValue;
  }
}
