// The tensor-core flash-attention bodies shared by the dense kernels
// (flash_fwd.cu, flash_bwd.cu) and the block-sparse ones (sparse_flash.cu):
// the forward with lse, the dq kernel and the dk/dv kernel.  Dense and
// block-sparse attention differ only in WHICH tiles a CTA visits, so each
// body is a template over a walk policy:
//   DenseWalk: the causal range.  A query CTA visits the key tiles from 0 to
//              its diagonal; a key CTA the query tiles from its diagonal to s.
//   TableWalk: a layout's tables (ops/kernels/sparse_attention.py
//              SparsePlan).  A query CTA visits the active key blocks of its
//              query block (`tbl` / `cnt`, ascending, so the diagonal block
//              comes last), a key CTA the active query blocks of its key
//              block (`tblT` / `cntT`, the diagonal first), each block cut
//              into the kernel's own tiles; in the diagonal block only the
//              tiles the CTA's rows can see.  CTAs start in `perm` / `permT`
//              order, the blocks with the most work first.  A layout block
//              (a multiple of 128) holds whole tiles, so the causal mask
//              bites only in the diagonal block; blocks off the tables are
//              never loaded.
// Segments: qseg holds the query rows' ids, kseg the keys' (JAX's
// kv_segment_ids); the dense kernels pass their one `seg` as both.  A pair
// of tiles whose id ranges do not meet is skipped (tc_common.cuh seg_range);
// the mask stays exact.  Masked entries and zero-filled rows beyond s carry
// p = ds = 0, so they add nothing.
//
// The bodies (see flash_fwd.cu and flash_bwd.cu for what each computes and
// its bound): all products are wgmma from 128 B-swizzled shared memory fed
// by a 2-stage cp.async ring (tc_common.cuh), one CTA per query head (any
// group: the g heads of a kv head re-read its K / V through L2), fp32
// softmax and accumulators in registers.
#pragma once

#include "tc_common.cuh"

namespace dst {
namespace {

using namespace tc;

// ---------------------------------------------------------------------------
// tile shapes
// ---------------------------------------------------------------------------
// Forward at head dim HD: two consumer warpgroups own 64 query rows each;
// key tiles of BK keys stream through a ring of ST = 2 stages.  BK is 128
// (S is 64 floats a thread) unless the hd-256 O accumulator (128 floats)
// leaves room for 64.
template <int HD_>
struct Tiles {
  static constexpr int HD = HD_, NWG = 2, BK = HD == 256 ? 64 : 128, ST = 2;
  static constexpr int BQ = 64 * NWG, THREADS = 128 * NWG;
  static constexpr size_t SMEM = 1024 + sizeof(bf16) * (BQ * HD + 2 * ST * BK * HD);
};

// The backward.  hd 256 runs one warpgroup a CTA (its accumulators and
// tiles fill what two would share), 64 and 128 run two.  dk/dv: each
// warpgroup owns 64 keys; 64-row query tiles stream through a ring of
// ST = 2 stages.  At hd 256 a CTA owns 128 of the dk / dv columns (its two
// accumulators fill the registers).
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

// ---------------------------------------------------------------------------
// tile walks.  Rows<BQ, BK>: the key tiles of BK keys that a query CTA of BQ
// rows visits (forward, dq; grid (hq, b, ceil(s / BQ))).  Cols<BKV, BQ>: the
// query tiles of BQ rows that a key CTA of BKV keys visits for each query
// head (dk/dv; grid (hkv x column splits, b, ceil(s / BKV))).
// ---------------------------------------------------------------------------
struct DenseWalk {
  template <int BQ, int BK>
  struct Rows {
    int q0, kend, n;  // rows q0 .. kend - 1 (no row sees a key >= kend); n tiles
    __device__ Rows(const DenseWalk&, int s)
        : q0((gridDim.z - 1 - blockIdx.z) * BQ),  // the last (heaviest) rows first
          kend(min(s, q0 + BQ)),
          n((kend + BK - 1) / BK) {}
    __device__ int key0(int i) const { return i * BK; }
  };
  template <int BKV, int BQ>
  struct Cols {
    int k0, n;  // keys k0 ..; n query tiles a head
    __device__ Cols(const DenseWalk&, int s)
        : k0(blockIdx.z * BKV),  // key tile 0 (the most rows) first
          n((s - k0 + BQ - 1) / BQ) {}
    __device__ int row0(int i) const { return k0 + i * BQ; }
  };
};

// The layout's tables on the device: tbl [n, width] with cnt [n] and perm [n]
// (the forward and dq), or tblT / cntT / permT (dk/dv).  s is a multiple of
// `block`.
struct TableWalk {
  const int* tbl;
  const int* cnt;
  const int* perm;
  int block, width;

  template <int BQ, int BK>
  struct Rows {
    int q0, kend, n, block, tpb;
    const int* act;  // the active key blocks of the CTA's query block
    __device__ Rows(const TableWalk& w, int) {
      const int units = w.block / BQ;  // CTAs a query block
      const int ib = w.perm[blockIdx.z / units];
      block = w.block;
      tpb = w.block / BK;
      q0 = ib * w.block + (blockIdx.z % units) * BQ;
      kend = q0 + BQ;
      act = w.tbl + static_cast<size_t>(ib) * w.width;
      const int na = w.cnt[ib];  // >= 1: sparse_tables refuses an empty causal row
      // the diagonal block (last when active) only up to the CTA's last row
      n = (na - 1) * tpb + (act[na - 1] == ib ? (kend - ib * w.block + BK - 1) / BK : tpb);
    }
    __device__ int key0(int i) const { return act[i / tpb] * block + (i % tpb) * BK; }
  };
  template <int BKV, int BQ>
  struct Cols {
    int k0, n, block, tpb, ndiag, first;
    const int* act;  // the active query blocks of the CTA's key block
    __device__ Cols(const TableWalk& w, int) {
      const int units = w.block / BKV;  // CTAs a key block
      const int jb = w.perm[blockIdx.z / units];
      block = w.block;
      tpb = w.block / BQ;
      k0 = jb * w.block + (blockIdx.z % units) * BKV;
      act = w.tbl + static_cast<size_t>(jb) * w.width;
      const int na = w.cnt[jb];  // 0 for a column no row reads: dk = dv = 0
      // the diagonal block (first when active) from the CTA's first key on:
      // rows < k0 see none of its keys
      first = na > 0 && act[0] == jb ? 1 : 0;
      ndiag = first ? (jb * w.block + w.block - k0) / BQ : 0;
      n = ndiag + (na - first) * tpb;
    }
    __device__ int row0(int i) const {
      if (i < ndiag) return k0 + i * BQ;
      i -= ndiag;
      return act[first + i / tpb] * block + (i % tpb) * BQ;
    }
  };
};

// ---------------------------------------------------------------------------
// forward: o and lse
// ---------------------------------------------------------------------------
template <class T, class W>
__global__ void __launch_bounds__(T::THREADS, 1)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ qseg,
                 const int* __restrict__ kseg, bf16* __restrict__ o, float* __restrict__ lse,
                 int s, int hq, int hkv, float scale, float cap, W walk) {
  constexpr int HD = T::HD, BK = T::BK, ST = T::ST, kBQ = T::BQ, kThreads = T::THREADS;
  extern __shared__ unsigned char smem_raw[];
  bf16* sq = align_1024(smem_raw);
  bf16* sk = sq + kBQ * HD;      // [ST][BK][HD]
  bf16* sv = sk + ST * BK * HD;  // [ST][BK][HD]

  const typename W::template Rows<kBQ, BK> rows(walk, s);
  const int h = blockIdx.x, b = blockIdx.y, q0 = rows.q0, kend = rows.kend, ntk = rows.n;
  const int hk = h / (hq / hkv);
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const size_t qstride = static_cast<size_t>(hq) * HD, kstride = static_cast<size_t>(hkv) * HD;
  const bf16* qb = q + static_cast<size_t>(b) * s * qstride + static_cast<size_t>(h) * HD;
  const bf16* kb = k + static_cast<size_t>(b) * s * kstride + static_cast<size_t>(hk) * HD;
  const bf16* vb = v + static_cast<size_t>(b) * s * kstride + static_cast<size_t>(hk) * HD;
  const int* qsb = qseg ? qseg + static_cast<size_t>(b) * s : nullptr;
  const int* ksb = kseg ? kseg + static_cast<size_t>(b) * s : nullptr;

  const int wrow0 = q0 + 64 * wg;                 // this warpgroup's rows
  const int wrow_last = min(wrow0 + 63, s - 1);   // < wrow0: no live row
  const int row_a = wrow0 + (threadIdx.x % 128) / 32 * 16 + lane / 4;  // rows row_a, row_a + 8

  int cmin = 0, cmax = 0, wmin = 0, wmax = 0, own[2] = {0, 0};
  if (qsb) {
    seg_range(qsb, q0, kend, &cmin, &cmax);
    seg_range(qsb, wrow0, wrow_last + 1, &wmin, &wmax);
    own[0] = row_a < s ? qsb[row_a] : -1;
    own[1] = row_a + 8 < s ? qsb[row_a + 8] : -1;
  }
  // the next key tile from `jt` on whose ids meet the CTA's rows'
  // (warp-uniform: every warp scans the same ids)
  auto next_tile = [&](int jt) {
    for (; ksb && jt < ntk; ++jt) {
      const int j0 = rows.key0(jt);
      int mn, mx;
      seg_range(ksb, j0, min(j0 + BK, kend), &mn, &mx);
      if (mx >= cmin && mn <= cmax) break;
    }
    return jt;
  };
  auto load_kv = [&](int jt, int stage) {
    const int j0 = rows.key0(jt);
    load_tile<BK, HD, kThreads>(sk + stage * BK * HD, kb, kstride, j0, s - j0);
    load_tile<BK, HD, kThreads>(sv + stage * BK * HD, vb, kstride, j0, s - j0);
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

    const int j0 = rows.key0(cur);
    bool live = wrow0 < s && j0 <= wrow_last;
    bool uniform = true;
    if (live && ksb) {
      int kmin, kmax;
      seg_range(ksb, j0, min(j0 + BK, kend), &kmin, &kmax);
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
          if (key > row || (ksb && ksb[min(key, s - 1)] != own[r])) sc[i] = -INFINITY;
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

// ---------------------------------------------------------------------------
// backward: dk / dv (one CTA per key tile, kv head and batch row, summing
// the g query heads of its group in registers)
// ---------------------------------------------------------------------------
template <class T, class W>
__global__ void __launch_bounds__(T::THREADS, 1)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ qseg,
                     const int* __restrict__ kseg, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int s, int hq, int hkv,
                     float scale, float cap, W walk) {
  constexpr int HD = T::HD, NT = T::THREADS, BKV = T::BKV, kBQ = T::BQ, DO = T::DO, ST = T::ST;
  constexpr int SPLIT = HD / DO;
  extern __shared__ unsigned char smem_raw[];
  bf16* sk = align_1024(smem_raw);
  bf16* sv = sk + BKV * HD;
  bf16* sq = sv + BKV * HD;        // [ST][kBQ][HD]
  bf16* sdo = sq + ST * kBQ * HD;  // [ST][kBQ][HD]
  float* slse = reinterpret_cast<float*>(sdo + ST * kBQ * HD);  // [ST][kBQ]
  float* sdelta = slse + ST * kBQ;                              // [ST][kBQ]

  const typename W::template Cols<BKV, kBQ> cols(walk, s);
  const int hk = blockIdx.x / SPLIT, c0 = (blockIdx.x % SPLIT) * DO;
  const int b = blockIdx.y, k0 = cols.k0, nqt = cols.n;
  const int g = hq / hkv;
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const size_t qstride = static_cast<size_t>(hq) * HD, kstride = static_cast<size_t>(hkv) * HD;
  const bf16* qb = q + static_cast<size_t>(b) * s * qstride;
  const bf16* dob = dout + static_cast<size_t>(b) * s * qstride;
  const int* qsb = qseg ? qseg + static_cast<size_t>(b) * s : nullptr;
  const int* ksb = kseg ? kseg + static_cast<size_t>(b) * s : nullptr;
  const size_t kvoff = static_cast<size_t>(b) * s * kstride + static_cast<size_t>(hk) * HD;

  const int wkey0 = k0 + 64 * wg;                 // this warpgroup's keys
  const int wkey_last = min(wkey0 + 63, s - 1);   // < wkey0: no live key
  const int key_a = wkey0 + (threadIdx.x % 128) / 32 * 16 + lane / 4;  // keys key_a, key_a + 8
  const int nitems = g * nqt;                     // (head, query tile), head outer

  int cmin = 0, cmax = 0, wmin = 0, wmax = 0, own[2] = {0, 0};
  if (ksb) {
    seg_range(ksb, k0, min(k0 + BKV, s), &cmin, &cmax);
    seg_range(ksb, wkey0, wkey_last + 1, &wmin, &wmax);
    own[0] = key_a < s ? ksb[key_a] : -1;
    own[1] = key_a + 8 < s ? ksb[key_a + 8] : -1;
  }
  auto next_item = [&](int it) {
    for (; qsb && it < nitems; ++it) {
      const int r0 = cols.row0(it % nqt);
      int mn, mx;
      seg_range(qsb, r0, min(r0 + kBQ, s), &mn, &mx);
      if (mx >= cmin && mn <= cmax) break;
    }
    return it;
  };
  auto load_item = [&](int it, int stage) {
    const int hh = hk * g + it / nqt, r0 = cols.row0(it % nqt);
    load_tile<kBQ, HD, NT>(sq + stage * kBQ * HD, qb + hh * HD, qstride, r0, s - r0);
    load_tile<kBQ, HD, NT>(sdo + stage * kBQ * HD, dob + hh * HD, qstride, r0, s - r0);
    load_floats<NT>(slse + stage * kBQ, lse + (static_cast<size_t>(b) * hq + hh) * s + r0, 1, kBQ,
                    s - r0);
    load_floats<NT>(sdelta + stage * kBQ, delta + (static_cast<size_t>(b) * s + r0) * hq + hh,
                    hq, kBQ, s - r0);
  };

  // the ring, as in the forward: item `fetch` is the next to load, `cur`
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

    const int r0 = cols.row0(cur % nqt);
    const int rlast = min(r0 + kBQ, s) - 1;
    bool live = wkey0 < s && rlast >= wkey0;
    bool uniform = true;
    if (live && qsb) {
      int rmin, rmax;
      seg_range(qsb, r0, rlast + 1, &rmin, &rmax);
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
            if (key > row || row >= s || (qsb && qsb[row] != own[e >> 1])) p = 0.f;
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

// ---------------------------------------------------------------------------
// backward: dq (one CTA per query tile, query head and batch row)
// ---------------------------------------------------------------------------
template <class T, class W>
__global__ void __launch_bounds__(T::THREADS, 1)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ qseg,
                    const int* __restrict__ kseg, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int s, int hq, int hkv, float scale, float cap,
                    W walk) {
  constexpr int HD = T::HD, NT = T::THREADS, BQD = T::BQ, kBK = T::BK, ST = T::ST;
  extern __shared__ unsigned char smem_raw[];
  bf16* sq = align_1024(smem_raw);
  bf16* sdo = sq + BQD * HD;
  bf16* sk = sdo + BQD * HD;      // [ST][kBK][HD]
  bf16* sv = sk + ST * kBK * HD;  // [ST][kBK][HD]

  const typename W::template Rows<BQD, kBK> rows(walk, s);
  const int h = blockIdx.x, b = blockIdx.y, q0 = rows.q0, kend = rows.kend, ntk = rows.n;
  const int hk = h / (hq / hkv);
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const size_t qstride = static_cast<size_t>(hq) * HD, kstride = static_cast<size_t>(hkv) * HD;
  const size_t qoff = static_cast<size_t>(b) * s * qstride + static_cast<size_t>(h) * HD;
  const bf16* kb = k + static_cast<size_t>(b) * s * kstride + static_cast<size_t>(hk) * HD;
  const bf16* vb = v + static_cast<size_t>(b) * s * kstride + static_cast<size_t>(hk) * HD;
  const int* qsb = qseg ? qseg + static_cast<size_t>(b) * s : nullptr;
  const int* ksb = kseg ? kseg + static_cast<size_t>(b) * s : nullptr;

  const int wrow0 = q0 + 64 * wg;
  const int wrow_last = min(wrow0 + 63, s - 1);
  const int row_a = wrow0 + (threadIdx.x % 128) / 32 * 16 + lane / 4;  // rows row_a, row_a + 8

  float lse2[2], dlt[2];
  int own[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    const bool ok = row < s;
    lse2[r] = ok ? lse[(static_cast<size_t>(b) * hq + h) * s + row] * kLog2e : 0.f;
    dlt[r] = ok ? delta[(static_cast<size_t>(b) * s + row) * hq + h] : 0.f;
    if (qsb) own[r] = ok ? qsb[row] : -1;
  }
  int cmin = 0, cmax = 0, wmin = 0, wmax = 0;
  if (qsb) {
    seg_range(qsb, q0, kend, &cmin, &cmax);
    seg_range(qsb, wrow0, wrow_last + 1, &wmin, &wmax);
  }
  auto next_tile = [&](int jt) {
    for (; ksb && jt < ntk; ++jt) {
      const int j0 = rows.key0(jt);
      int mn, mx;
      seg_range(ksb, j0, min(j0 + kBK, kend), &mn, &mx);
      if (mx >= cmin && mn <= cmax) break;
    }
    return jt;
  };
  auto load_kv = [&](int jt, int stage) {
    const int j0 = rows.key0(jt);
    load_tile<kBK, HD, NT>(sk + stage * kBK * HD, kb, kstride, j0, s - j0);
    load_tile<kBK, HD, NT>(sv + stage * kBK * HD, vb, kstride, j0, s - j0);
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

    const int j0 = rows.key0(cur);
    bool live = wrow0 < s && j0 <= wrow_last;
    bool uniform = true;
    if (live && ksb) {
      int kmin, kmax;
      seg_range(ksb, j0, min(j0 + kBK, kend), &kmin, &kmax);
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
          if (key > row || (ksb && ksb[min(key, s - 1)] != own[r])) p = 0.f;
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

// ---------------------------------------------------------------------------
// launches: one per call, on the caller's stream; the result is the
// launch's cudaGetLastError() (non-zero: nothing ran).  hd 64, 128 or 256.
// ---------------------------------------------------------------------------
struct Attn {
  const bf16 *q, *k, *v;
  const int *qseg, *kseg;
  int b, s, hq, hkv;
  float scale, cap;
  cudaStream_t stream;
};

template <class T, class W>
cudaError_t launch_fwd(const Attn& a, void* o, float* lse, W walk) {
  cudaError_t err = allow_smem(flash_fwd_kernel<T, W>, T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.hq, a.b, (a.s + T::BQ - 1) / T::BQ);
  flash_fwd_kernel<T, W><<<grid, T::THREADS, T::SMEM, a.stream>>>(
      a.q, a.k, a.v, a.qseg, a.kseg, static_cast<bf16*>(o), lse, a.s, a.hq, a.hkv, a.scale,
      a.cap, walk);
  return cudaGetLastError();
}

template <class T, class W>
cudaError_t launch_dq(const Attn& a, const void* dout, const float* lse, const float* delta,
                      void* dq, W walk) {
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, W>, T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.hq, a.b, (a.s + T::BQ - 1) / T::BQ);
  flash_bwd_dq_kernel<T, W><<<grid, T::THREADS, T::SMEM, a.stream>>>(
      a.q, a.k, a.v, a.qseg, a.kseg, static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq), a.s, a.hq, a.hkv, a.scale, a.cap, walk);
  return cudaGetLastError();
}

template <class T, class W>
cudaError_t launch_dkv(const Attn& a, const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, W walk) {
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T, W>, T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.hkv * (T::HD / T::DO), a.b, (a.s + T::BKV - 1) / T::BKV);
  flash_bwd_dkv_kernel<T, W><<<grid, T::THREADS, T::SMEM, a.stream>>>(
      a.q, a.k, a.v, a.qseg, a.kseg, static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), a.s, a.hq, a.hkv, a.scale, a.cap, walk);
  return cudaGetLastError();
}

template <class W>
cudaError_t attn_fwd(const Attn& a, int hd, void* o, float* lse, W walk) {
  switch (hd) {
    case 64: return launch_fwd<Tiles<64>>(a, o, lse, walk);
    case 128: return launch_fwd<Tiles<128>>(a, o, lse, walk);
    case 256: return launch_fwd<Tiles<256>>(a, o, lse, walk);
    default: return cudaErrorInvalidValue;
  }
}

template <class W>
cudaError_t attn_bwd_dq(const Attn& a, int hd, const void* dout, const float* lse,
                        const float* delta, void* dq, W walk) {
  switch (hd) {
    case 64: return launch_dq<DqTiles<64>>(a, dout, lse, delta, dq, walk);
    case 128: return launch_dq<DqTiles<128>>(a, dout, lse, delta, dq, walk);
    case 256: return launch_dq<DqTiles<256>>(a, dout, lse, delta, dq, walk);
    default: return cudaErrorInvalidValue;
  }
}

template <class W>
cudaError_t attn_bwd_dkv(const Attn& a, int hd, const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv, W walk) {
  switch (hd) {
    case 64: return launch_dkv<DkvTiles<64>>(a, dout, lse, delta, dk, dv, walk);
    case 128: return launch_dkv<DkvTiles<128>>(a, dout, lse, delta, dk, dv, walk);
    case 256: return launch_dkv<DkvTiles<256>>(a, dout, lse, delta, dk, dv, walk);
    default: return cudaErrorInvalidValue;
  }
}

// The arguments every entry shares; false where they are not a shape the
// kernels take (hkv must divide hq; b, s >= 1).
inline bool make_attn(const void* q, const void* k, const void* v, const int* qseg,
                      const int* kseg, int b, int s, int hq, int hkv, float scale, float cap,
                      void* stream, Attn* a) {
  if (hkv <= 0 || hq % hkv || b <= 0 || s <= 0) return false;
  *a = Attn{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), qseg, kseg, b, s, hq, hkv, scale, cap,
            static_cast<cudaStream_t>(stream)};
  return true;
}

}  // namespace
}  // namespace dst
