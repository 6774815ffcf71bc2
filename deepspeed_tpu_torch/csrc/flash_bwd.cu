// Causal flash-attention backward (FlashAttention-2) with packed segments,
// GQA and soft cap, on Hopper's tensor cores (wgmma): two kernels, no
// atomics, so dq, dk and dv are deterministic.
//
// Replaces: deepspeed_tpu/ops/pallas/flash_kernel.py `_bwd` (:364): the dq
// `pl.pallas_call` at :384 (flash_bwd_dq_kernel) and the dk/dv
// `pl.pallas_call` at :407 (flash_bwd_dkv_kernel).
//
// What it computes, for the forward o = softmax(cap(q k^T * scale)) v over
// keys j <= i of row i's segment, given o's log-sum-exp `lse` (written by
// flash_fwd.cu, capped scaled-score units) and delta[b, i, h] = rowsum(dO * o)
// (one PyTorch op, as JAX computes it outside Pallas at :370):
//   p  = exp(s_cap - lse)                       (the forward's probabilities)
//   dp = dO . v
//   ds = p * (dp - delta) * (1 - (s_cap / cap)^2) * scale   (cap factor :131)
//   dq = sum_j ds k_j,   dk = sum_i ds q_i,   dv = sum_i p dO_i
// dk and dv of kv head h sum over all g = hq / hkv query heads of its group
// in registers: the JAX kernel repeats k/v to hq heads and sums the groups
// afterwards (:426-447, :461-468); only the summation order differs.  bf16 in,
// fp32 accumulation, bf16 dq / dk / dv.
//
// Bound on H100: 10 * hd flops per causal (query, key, q-head) for the pair
// on the bf16 tensor cores (b 8, s 4096, hq 8, hd 128: 0.70 ms); the split
// recomputes q.k and dO.v, so dq does 6 hd and dk/dv 8 hd.  Design: all
// five products are wgmma (tc_common.cuh), operands streamed by a 2-stage
// cp.async ring into 128 B-swizzled shared memory:
//   dk/dv: one CTA per (key tile, kv head, batch), 64 keys per warpgroup,
//          K and V resident.  It walks the g query heads of the group and,
//          for each, the 64-row query tiles from the diagonal to s: S^T = K
//          Q^T and dP^T = V dO^T (SS), P^T and dS^T formed in registers, then
//          dV += P^T dO and dK += dS^T Q with P^T / dS^T as the register A
//          operand and dO / Q read MN-major.  At hd 256 a CTA owns half of
//          the hd columns of dk / dv (the two halves recompute S and dP), so
//          both accumulators fit in registers.  Key tile 0 (the most rows)
//          launches first.
//   dq:    one CTA per (tile of 64 x warpgroups query rows, q-head, batch)
//          with Q, dO, lse and delta resident; it streams 64-key tiles of K
//          and V up to the diagonal: S = Q K^T, dP = dO V^T (SS), dS in
//          registers, dQ += dS K with K read MN-major.  The heaviest row
//          tiles (the last rows) launch first.
// Both skip key / query tiles past the causal diagonal (the loops end there)
// and tiles whose segment ranges do not meet, as flash_fwd.cu does; the mask
// runs only on diagonal, ragged and mixed-segment tiles.  Masked entries and
// zero-filled rows beyond s carry p = ds = 0, so they add nothing.
#include "tc_common.cuh"

namespace dst {
namespace {

using namespace tc;

// The tile shapes at head dim HD.  hd 256 runs one warpgroup a CTA (its
// accumulators and tiles fill what two would share), 64 and 128 run two.
// dk/dv: each warpgroup owns 64 keys; 64-row query tiles stream through a
// ring of ST = 2 stages.  At hd 256 a CTA owns 128 of the dk / dv columns
// (its two accumulators fill the registers).
template <int HD_>
struct DkvTiles {
  static constexpr int HD = HD_, NWG = HD == 256 ? 1 : 2, ST = 2;
  static constexpr int BKV = 64 * NWG, BQ = 64, THREADS = 128 * NWG;
  static constexpr int DO = HD == 256 ? 128 : HD;
  static constexpr size_t SMEM =
      1024 + sizeof(bf16) * (2 * BKV * HD + 2 * ST * BQ * HD) + sizeof(float) * 2 * ST * BQ;
};

// dq: each warpgroup owns 64 query rows; 64-key tiles stream through a ring
// of ST = 2 stages.
template <int HD_>
struct DqTiles {
  static constexpr int HD = HD_, NWG = HD == 256 ? 1 : 2, ST = 2;
  static constexpr int BQ = 64 * NWG, BK = 64, THREADS = 128 * NWG;
  static constexpr size_t SMEM = 1024 + sizeof(bf16) * (2 * BQ * HD + 2 * ST * BK * HD);
};

template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ seg,
                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int s, int hq, int hkv, float scale, float cap) {
  constexpr int HD = T::HD, NT = T::THREADS, BKV = T::BKV, kBQ = T::BQ, DO = T::DO, ST = T::ST;
  constexpr int SPLIT = HD / DO;
  extern __shared__ unsigned char smem_raw[];
  bf16* sk = align_1024(smem_raw);
  bf16* sv = sk + BKV * HD;
  bf16* sq = sv + BKV * HD;        // [ST][kBQ][HD]
  bf16* sdo = sq + ST * kBQ * HD;  // [ST][kBQ][HD]
  float* slse = reinterpret_cast<float*>(sdo + ST * kBQ * HD);  // [ST][kBQ]
  float* sdelta = slse + ST * kBQ;                              // [ST][kBQ]

  const int hk = blockIdx.x / SPLIT, c0 = (blockIdx.x % SPLIT) * DO;
  const int b = blockIdx.y, k0 = blockIdx.z * BKV;
  const int g = hq / hkv;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const size_t qstride = static_cast<size_t>(hq) * HD, kstride = static_cast<size_t>(hkv) * HD;
  const bf16* qb = q + static_cast<size_t>(b) * s * qstride;
  const bf16* dob = dout + static_cast<size_t>(b) * s * qstride;
  const int* sb = seg ? seg + static_cast<size_t>(b) * s : nullptr;
  const size_t kvoff = static_cast<size_t>(b) * s * kstride + static_cast<size_t>(hk) * HD;

  const int wkey0 = k0 + 64 * wg;                 // this warpgroup's keys
  const int wkey_last = min(wkey0 + 63, s - 1);   // < wkey0: no live key
  const int key_a = wkey0 + (threadIdx.x % 128) / 32 * 16 + lane / 4;  // keys key_a, key_a + 8
  const int rq0 = k0 / kBQ * kBQ;                 // first query tile that sees a key
  const int nqt = (s - rq0 + kBQ - 1) / kBQ;
  const int nitems = g * nqt;                     // (head, query tile), head outer

  int cmin = 0, cmax = 0, wmin = 0, wmax = 0, kseg[2] = {0, 0};
  if (sb) {
    seg_range(sb, k0, min(k0 + BKV, s), &cmin, &cmax);
    seg_range(sb, wkey0, wkey_last + 1, &wmin, &wmax);
    kseg[0] = key_a < s ? sb[key_a] : -1;
    kseg[1] = key_a + 8 < s ? sb[key_a + 8] : -1;
  }
  auto next_item = [&](int it) {
    for (; sb && it < nitems; ++it) {
      const int r0 = rq0 + (it % nqt) * kBQ;
      int mn, mx;
      seg_range(sb, r0, min(r0 + kBQ, s), &mn, &mx);
      if (mx >= cmin && mn <= cmax) break;
    }
    return it;
  };
  auto load_item = [&](int it, int stage) {
    const int hh = hk * g + it / nqt, r0 = rq0 + (it % nqt) * kBQ;
    load_tile<kBQ, HD, NT>(sq + stage * kBQ * HD, qb + hh * HD, qstride, r0, s - r0);
    load_tile<kBQ, HD, NT>(sdo + stage * kBQ * HD, dob + hh * HD, qstride, r0, s - r0);
    load_floats<NT>(slse + stage * kBQ, lse + (static_cast<size_t>(b) * hq + hh) * s + r0, 1, kBQ,
                    s - r0);
    load_floats<NT>(sdelta + stage * kBQ, delta + (static_cast<size_t>(b) * s + r0) * hq + hh,
                    hq, kBQ, s - r0);
  };

  // the ring, as in flash_fwd.cu: item `fetch` is the next to load, `cur`
  // the one multiplied
  load_tile<BKV, HD, NT>(sk, k + kvoff, kstride, k0, s - k0);
  load_tile<BKV, HD, NT>(sv, v + kvoff, kstride, k0, s - k0);
  int fetch = next_item(0);
#pragma unroll
  for (int st = 0; st < ST - 1; ++st) {
    if (fetch < nitems) {
      load_item(fetch, st);
      fetch = next_item(fetch + 1);
    }
    cp_async_commit();
  }

  float acc_k[DO / 2], acc_v[DO / 2];
#pragma unroll
  for (int i = 0; i < DO / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  const ScoreMap smap(scale, cap);

  int cur = next_item(0);
  for (int it = 0; cur < nitems; ++it) {
    cp_async_wait<ST - 2>();
    fence_async_smem();
    __syncthreads();  // item `cur` landed; every warp is done with iteration it - 1
    if (fetch < nitems) {
      load_item(fetch, (it + ST - 1) % ST);
      fetch = next_item(fetch + 1);
    }
    cp_async_commit();

    const int r0 = rq0 + (cur % nqt) * kBQ;
    const int rlast = min(r0 + kBQ, s) - 1;
    bool live = wkey0 < s && rlast >= wkey0;
    bool uniform = true;
    if (live && sb) {
      int rmin, rmax;
      seg_range(sb, r0, rlast + 1, &rmin, &rmax);
      live = rmax >= wmin && rmin <= wmax;
      uniform = rmin == rmax && wmin == wmax && rmin == wmin;
    }
    if (live) {  // uniform across the warpgroup
      const int st = it % ST;
      const bf16* tq = sq + st * kBQ * HD;
      const bf16* tdo = sdo + st * kBQ * HD;
      const float* tl = slse + st * kBQ;
      const float* td = sdelta + st * kBQ;
      float sc[kBQ / 2], dp[kBQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<kBQ>(sc, desc_k<BKV>(sk, 64 * wg, kk), desc_k<kBQ>(tq, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<kBQ>(dp, desc_k<BKV>(sv, 64 * wg, kk), desc_k<kBQ>(tdo, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      const bool masked = r0 < wkey0 + 63 || r0 + kBQ > s || !uniform;
      smap.apply_cap(sc);
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j) {  // columns 8 j + 2 (lane % 4) + {0, 1}
        const float2 lj = *reinterpret_cast<const float2*>(tl + 8 * j + 2 * (lane & 3));
        const float2 dj = *reinterpret_cast<const float2*>(td + 8 * j + 2 * (lane & 3));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          float p = fast_exp2(fmaf(sc[i], smap.mul, -(e & 1 ? lj.y : lj.x) * kLog2e));
          if (masked) {
            const int row = r0 + 8 * j + 2 * (lane & 3) + (e & 1);
            const int key = key_a + 8 * (e >> 1);
            if (key > row || row >= s || (sb && sb[row] != kseg[e >> 1])) p = 0.f;
          }
          float ds = p * (dp[i] - (e & 1 ? dj.y : dj.x)) * scale;
          if (smap.capped) ds *= smap.dcap(sc[i]);
          sc[i] = p;
          dp[i] = ds;
        }
      }
      uint32_t pa[kBQ / 16][4], da[kBQ / 16][4];  // formed before the first product
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        acc_to_a(sc, kk, pa[kk]);
        acc_to_a(dp, kk, da[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
        wgmma_rs<DO>(acc_v, pa[kk], desc_mn<kBQ>(tdo, kk, c0 / 64), 1);
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
        wgmma_rs<DO>(acc_k, da[kk], desc_mn<kBQ>(tq, kk, c0 / 64), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_k);
      fence_regs(acc_v);
    }
    cur = next_item(cur + 1);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_a + 8 * r;
    if (key >= s) continue;
    const size_t off = kvoff + static_cast<size_t>(key) * kstride + c0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < DO / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * j) =
          pack_bf16(acc_k[4 * j + 2 * r], acc_k[4 * j + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * j) =
          pack_bf16(acc_v[4 * j + 2 * r], acc_v[4 * j + 2 * r + 1]);
    }
  }
}

template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ seg,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq, int s, int hq,
                    int hkv, float scale, float cap) {
  constexpr int HD = T::HD, NT = T::THREADS, BQD = T::BQ, kBK = T::BK, ST = T::ST;
  extern __shared__ unsigned char smem_raw[];
  bf16* sq = align_1024(smem_raw);
  bf16* sdo = sq + BQD * HD;
  bf16* sk = sdo + BQD * HD;      // [ST][kBK][HD]
  bf16* sv = sk + ST * kBK * HD;  // [ST][kBK][HD]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQD;  // last (heaviest) rows first
  const int hk = h / (hq / hkv);
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const size_t qstride = static_cast<size_t>(hq) * HD, kstride = static_cast<size_t>(hkv) * HD;
  const size_t qoff = static_cast<size_t>(b) * s * qstride + static_cast<size_t>(h) * HD;
  const bf16* kb = k + static_cast<size_t>(b) * s * kstride + static_cast<size_t>(hk) * HD;
  const bf16* vb = v + static_cast<size_t>(b) * s * kstride + static_cast<size_t>(hk) * HD;
  const int* sb = seg ? seg + static_cast<size_t>(b) * s : nullptr;

  const int kend = min(s, q0 + BQD);
  const int ntk = (kend + kBK - 1) / kBK;
  const int wrow0 = q0 + 64 * wg;
  const int wrow_last = min(wrow0 + 63, s - 1);
  const int row_a = wrow0 + (threadIdx.x % 128) / 32 * 16 + lane / 4;  // rows row_a, row_a + 8

  float lse2[2], dlt[2];
  int qseg[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    const bool ok = row < s;
    lse2[r] = ok ? lse[(static_cast<size_t>(b) * hq + h) * s + row] * kLog2e : 0.f;
    dlt[r] = ok ? delta[(static_cast<size_t>(b) * s + row) * hq + h] : 0.f;
    if (sb) qseg[r] = ok ? sb[row] : -1;
  }
  int cmin = 0, cmax = 0, wmin = 0, wmax = 0;
  if (sb) {
    seg_range(sb, q0, kend, &cmin, &cmax);
    seg_range(sb, wrow0, wrow_last + 1, &wmin, &wmax);
  }
  auto next_tile = [&](int jt) {
    for (; sb && jt < ntk; ++jt) {
      int mn, mx;
      seg_range(sb, jt * kBK, min(jt * kBK + kBK, kend), &mn, &mx);
      if (mx >= cmin && mn <= cmax) break;
    }
    return jt;
  };
  auto load_kv = [&](int jt, int stage) {
    load_tile<kBK, HD, NT>(sk + stage * kBK * HD, kb, kstride, jt * kBK, s - jt * kBK);
    load_tile<kBK, HD, NT>(sv + stage * kBK * HD, vb, kstride, jt * kBK, s - jt * kBK);
  };

  load_tile<BQD, HD, NT>(sq, q + qoff, qstride, q0, s - q0);
  load_tile<BQD, HD, NT>(sdo, dout + qoff, qstride, q0, s - q0);
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

    const int j0 = cur * kBK;
    bool live = wrow0 < s && j0 <= wrow_last;
    bool uniform = true;
    if (live && sb) {
      int kmin, kmax;
      seg_range(sb, j0, min(j0 + kBK, kend), &kmin, &kmax);
      live = kmax >= wmin && kmin <= wmax;
      uniform = kmin == kmax && wmin == wmax && kmin == wmin;
    }
    if (live) {  // uniform across the warpgroup
      const bf16* tk = sk + (it % ST) * kBK * HD;
      const bf16* tv = sv + (it % ST) * kBK * HD;
      float sc[kBK / 2], dp[kBK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<kBK>(sc, desc_k<BQD>(sq, 64 * wg, kk), desc_k<kBK>(tk, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<kBK>(dp, desc_k<BQD>(sdo, 64 * wg, kk), desc_k<kBK>(tv, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      const bool masked = j0 + kBK - 1 > wrow0 || !uniform;
      smap.apply_cap(sc);
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int r = (i >> 1) & 1;
        float p = fast_exp2(fmaf(sc[i], smap.mul, -lse2[r]));
        if (masked) {
          const int row = row_a + 8 * r;
          const int key = j0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          if (key > row || (sb && sb[min(key, s - 1)] != qseg[r])) p = 0.f;
        }
        float ds = p * (dp[i] - dlt[r]) * scale;
        if (smap.capped) ds *= smap.dcap(sc[i]);
        dp[i] = ds;
      }
      uint32_t da[kBK / 16][4];  // formed before the first product
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) acc_to_a(dp, kk, da[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) wgmma_rs<HD>(acc, da[kk], desc_mn<kBK>(tk, kk, 0), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    cur = next_tile(cur + 1);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= s) continue;
    bf16* orow = dq + qoff + static_cast<size_t>(row) * qstride + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) = pack_bf16(acc[4 * j + 2 * r],
                                                             acc[4 * j + 2 * r + 1]);
  }
}

template <class T>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const int* seg,
                      const void* dout, const float* lse, const float* delta, void* dq, int b,
                      int s, int hq, int hkv, float scale, float cap, cudaStream_t stream) {
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T>, T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(hq, b, (s + T::BQ - 1) / T::BQ);
  flash_bwd_dq_kernel<T><<<grid, T::THREADS, T::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), seg,
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), s, hq, hkv, scale, cap);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const int* seg,
                       const void* dout, const float* lse, const float* delta, void* dk, void* dv,
                       int b, int s, int hq, int hkv, float scale, float cap,
                       cudaStream_t stream) {
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T>, T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(hkv * (T::HD / T::DO), b, (s + T::BKV - 1) / T::BKV);
  flash_bwd_dkv_kernel<T><<<grid, T::THREADS, T::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), seg,
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      s, hq, hkv, scale, cap);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dst

// q / dout [b, s, hq, hd], k / v [b, s, hkv, hd] bf16 contiguous; seg [b, s]
// int32 or null; lse [b, hq, s] and delta [b, s, hq] fp32; dq [b, s, hq, hd]
// bf16.  hd 64, 128 or 256, any hkv dividing hq.  cap <= 0 disables the
// soft cap.  Returns the launch's cudaGetLastError() (non-zero: nothing ran).
extern "C" int dst_flash_bwd_dq(const void* q, const void* k, const void* v, const int* seg,
                                const void* dout, const float* lse, const float* delta, void* dq,
                                int b, int s, int hq, int hkv, int hd, float scale, float cap,
                                void* stream) {
  if (hkv <= 0 || hq % hkv || b <= 0 || s <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return dst::launch_dq<dst::DqTiles<64>>(q, k, v, seg, dout, lse, delta, dq, b, s, hq, hkv, scale, cap, st);
    case 128: return dst::launch_dq<dst::DqTiles<128>>(q, k, v, seg, dout, lse, delta, dq, b, s, hq, hkv, scale, cap, st);
    case 256: return dst::launch_dq<dst::DqTiles<256>>(q, k, v, seg, dout, lse, delta, dq, b, s, hq, hkv, scale, cap, st);
    default: return cudaErrorInvalidValue;
  }
}

// The same inputs; dk / dv [b, s, hkv, hd] bf16, each summed over the g
// query heads of its kv head.
extern "C" int dst_flash_bwd_dkv(const void* q, const void* k, const void* v, const int* seg,
                                 const void* dout, const float* lse, const float* delta, void* dk,
                                 void* dv, int b, int s, int hq, int hkv, int hd, float scale,
                                 float cap, void* stream) {
  if (hkv <= 0 || hq % hkv || b <= 0 || s <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return dst::launch_dkv<dst::DkvTiles<64>>(q, k, v, seg, dout, lse, delta, dk, dv, b, s, hq, hkv, scale, cap, st);
    case 128: return dst::launch_dkv<dst::DkvTiles<128>>(q, k, v, seg, dout, lse, delta, dk, dv, b, s, hq, hkv, scale, cap, st);
    case 256: return dst::launch_dkv<dst::DkvTiles<256>>(q, k, v, seg, dout, lse, delta, dk, dv, b, s, hq, hkv, scale, cap, st);
    default: return cudaErrorInvalidValue;
  }
}
