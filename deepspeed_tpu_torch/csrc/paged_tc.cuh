// The tensor-core bodies of the paged attentions: packed-suffix attention
// over cached context pages plus the pack's own causal keys (K3,
// ctx_attention.cu) and one-token decode over the paged KV pool (K2,
// paged_decode.cu), each in its normal mode (normalized bf16 rows) and its
// partial mode (the unnormalized fp32 triple (acc, m, l) of seq-sharded
// serving).
//
// Keys: a unit of work attends the keys of one segment (K3) or slot (K2)
// for one kv head: (a) its cached context, positions [0, len) read through
// its table row (table[pos / bs] * bs + pos % bs): each key row of a 64-key
// tile is gathered by its own 16-byte cp.asyncs, so a tile may span pages
// or part of one, at any block size; a key that is not here (past len, a
// table id outside [0, nb), another shard's page) is zero-filled and
// masked, and a tile with no key here is neither loaded nor multiplied.
// Decode's normal mode instead clamps an id to [0, nb) as the TPU kernel
// does, so an idle slot (len 1, all -1) gives a finite row.  (b) K3 only:
// the segment's own keys in the pack, at or before the row (include_pack:
// always in the normal mode, shard 0's in the partial mode).  K / V tiles
// stream through a cp.async ring (`Ring`); the key rows of a tile (its page
// ids read from the table) are computed one iteration before its load is
// issued, so the table's latency hides behind the products.
//
// Products, fp32 online softmax in base 2 in registers:
//   K3 (`ctx_attn_kernel`): 64 (row, query head) PAIRS of one kv head, pair
//     p = r g + j, are the M of S = Q K^T (wgmma SS) and O += P V (wgmma RS,
//     P from the accumulator in bf16, V read MN-major) -- flash_tc.cuh's
//     forward step; a verify segment's 5 rows x g heads share one tile;
//   K2 (`decode_kernel`): a slot has one row, so the operands are swapped:
//     the 64 keys of a tile are the M of S^T = K Q^T (wgmma SS, N = the
//     unit's query heads padded to 8 / 16 / 64) and the head dim is the M of
//     O^T += V^T P^T (wgmma SS, V read as a transposed A, P^T through shared
//     memory): no warp idles at g = 1, and a tile costs NQ / 64 of the
//     pair form's products and exponentials.  The key-wise max crosses the
//     four warps once a tile (shared memory); the sum is reduced at the end.
//
// Split: a unit's key tiles (context, then pack) are dealt round-robin to
// the CS CTAs of one thread-block cluster (tile i to rank i % CS), so a long
// context is spread over CS SMs.  With CS > 1 each rank stores its (acc, m,
// l) shares into the owners' shared memory (rank k owns the 4-column
// vectors c4 = k, k + CS, ... of the unit's rows; remote stores do not
// wait), and after a cluster barrier every rank merges its own columns in
// rank order (`merge_out`): deterministic, no scratch in device memory, one
// launch.  CS comes from the shapes (units, the table's width), never from
// lengths, so a tick can be captured by a CUDA graph.
//
// K3's units: a segment (a contiguous run of pack rows with one id in
// [1, N]) of `rows` rows makes ceil(rows g / 64) units a kv head; the grid
// has ceil(T g / 64) + min(N, T) - 1 unit slots, enough for any segment
// layout.  A CTA finds its unit in one pass over the T ids (each segment's
// first row and end, then a warp scan of the units a segment), and writes
// the pad rows (ids outside [1, N]) of its share of the pack: exactly 0, or
// (0, -1e30, 0) in the partial mode.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "tc_common.cuh"

namespace dst {
namespace {

using namespace tc;
namespace cg = cooperative_groups;

constexpr float kEmptyMax = -1e30f;  // the partial triple's m where no key was met
constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr int kBK = 64;              // keys a tile
constexpr int kNT = 128;             // threads a CTA: one warpgroup

// The merge buffers reuse the ring: every rank's share of this rank's
// columns (at most HD / 4 + CS - 1 vectors of 4 for each of 64 rows) and
// every rank's m, l and weight a row.
template <int HD>
constexpr size_t merge_bytes() {
  return sizeof(float4) * 64 * (HD / 4 + kMaxCluster - 1) + sizeof(float) * 3 * kMaxCluster * 64;
}

// K3's shapes at head dim HD: 64 pairs x 64 keys a tile.  The ring depth
// keeps 2 CTAs on an SM at hd 128 (3 at hd 64).
template <int HD_>
struct CtxTiles {
  static constexpr int HD = HD_, ST = HD == 64 ? 4 : 2;
  static constexpr size_t RING = sizeof(bf16) * 2 * ST * kBK * HD;
  static constexpr size_t SMEM = 1024 + sizeof(bf16) * 64 * HD + RING;
  static_assert(merge_bytes<HD>() <= RING, "merge buffers");
};

// K2's shapes: a unit is up to kDecodeHeads query heads of one kv head (16
// at hd 256, where O^T's accumulator is largest), NQ of them (8, 16 or 64)
// in the products; the ring keeps 2 CTAs on an SM at hd 128 and NQ <= 16.
template <int HD>
constexpr int kDecodeHeads = HD == 256 ? 16 : 64;
template <int HD_, int NQ_>
struct DecodeTiles {
  static constexpr int HD = HD_, NQ = NQ_;
  static constexpr int ST = HD == 64 ? 4 : 3;
  static constexpr size_t RING = sizeof(bf16) * 2 * ST * kBK * HD;
  static constexpr size_t SMEM = 1024 + RING + sizeof(bf16) * NQ * (HD + kBK);
  static_assert(merge_bytes<HD>() <= RING, "merge buffers");
};

struct PagedArgs {
  const bf16* q;      // [B | T, hq, hd]
  const bf16* k;      // K3: the pack's keys and values [T, hkv, hd]
  const bf16* v;
  const int* seg;     // K3: segment ids [T]
  const bf16* kpool;  // [nb, bs, hkv, hd]
  const bf16* vpool;
  const int* tables;  // [B | N, P]
  const int* lens;    // [B | N]
  bf16* o;            // the normal mode's rows
  float* acc;         // the partial mode's triple
  float* m;
  float* l;
  int T, hq, hkv, nb, bs, N, P, include_pack;
  int mtiles;  // decode: units a (slot, kv head)
  float scale, cap;
};

// The keys of a unit dealt to one CTA: its j-th tile is tile rank + j CS of
// the unit's context tiles (nct of them), then of its pack tiles.
struct Keys {
  const int* trow;  // the unit's table row
  int kcols;        // positions the row covers (P bs)
  int bs, nb, rank, cs;
  int ctx_len, nct, row0, kend, nmine;
  bool clamp;  // decode's normal mode: clamp ids to the pool instead of skipping them

  __device__ Keys(const int* trow_, int P, int bs_, int nb_, bool clamp_)
      : trow(trow_), kcols(P * bs_), bs(bs_), nb(nb_), rank(blockIdx.x), cs(gridDim.x),
        ctx_len(0), nct(0), row0(0), kend(0), nmine(0), clamp(clamp_) {}
  // the context's length and the pack keys row0_ .. kend_ - 1
  __device__ void set(int len, int row0_, int kend_) {
    ctx_len = max(0, min(len, kcols));
    nct = (ctx_len + kBK - 1) / kBK;
    row0 = row0_;
    kend = kend_;
    const int npt = (kend - row0 + kBK - 1) / kBK;
    nmine = max(0, (nct + npt - rank + cs - 1) / cs);
  }
  // key t of tile j: the table id to read, independent of the length, so
  // it is issued beside the length's own load
  __device__ int id(int j, int t) const {
    const int pos = (rank + j * cs) * kBK + t;
    return pos < kcols ? __ldg(trow + pos / bs) : 0;
  }
  // ... and its key row in the pool (context) or the pack, -1 if not here
  __device__ int row(int j, int t, int id) const {
    const int ti = rank + j * cs;
    if (j >= nmine) return -1;
    if (ti < nct) {
      const int pos = ti * kBK + t;
      if (pos >= ctx_len) return -1;
      if (clamp) {
        id = min(max(id, 0), nb - 1);  // the TPU kernel's clamp
      } else if (id < 0 || id >= nb) {
        return -1;  // another shard's page, or padding
      }
      return id * bs + pos % bs;
    }
    const int r = row0 + (ti - nct) * kBK + t;
    return r < kend ? r : -1;
  }
  __device__ bool pool(int j) const { return rank + j * cs < nct; }
};

// The K / V ring: ST stages of 64 key rows, and the key rows of ST + 1
// tiles (one further ahead) with their validity ballot.
template <int HD, int ST>
struct Ring {
  static constexpr int KR = ST + 1, G = HD / 8;
  static_assert((kBK * G) % kNT == 0 && kNT % G == 0, "tile not a whole number of passes");
  int krow[KR][kBK];
  unsigned valid[KR][2];

  // threads 0 .. 63 (warps 0 and 1): the key rows of tile j
  __device__ void put(int j, int kr) {
    krow[j % KR][threadIdx.x] = kr;
    const unsigned bits = __ballot_sync(kFull, kr >= 0);
    if (threadIdx.x % 32 == 0) valid[j % KR][threadIdx.x / 32] = bits;
  }
  __device__ bool live(int j) const { return (valid[j % KR][0] | valid[j % KR][1]) != 0u; }
  // tile j's rows into stage `stage` (zero-filled where not here)
  __device__ void load(int j, int stage, const Keys& keys, bf16* sk, bf16* sv,
                       const PagedArgs& a, int h) const {
    const bool pool = keys.pool(j);
    const bf16* kb = pool ? a.kpool : a.k;
    const bf16* vb = pool ? a.vpool : a.v;
    const int* rows = krow[j % KR];
    bf16* dk = sk + stage * kBK * HD;
    bf16* dv = sv + stage * kBK * HD;
    const int r0 = threadIdx.x / G, gcol = threadIdx.x % G;
#pragma unroll
    for (int i = 0; i < kBK * G / kNT; ++i) {
      const int r = r0 + i * (kNT / G);
      const int kr = rows[r];
      const size_t off = (static_cast<size_t>(max(kr, 0)) * a.hkv + h) * HD + gcol * 8;
      cp_async16(smem_u32(dk + swz<kBK>(r, gcol)), kb + off, kr >= 0);
      cp_async16(smem_u32(dv + swz<kBK>(r, gcol)), vb + off, kr >= 0);
    }
  }
  // every thread: the first ST - 1 tiles in flight (after the first rows'
  // barrier); the q tile's copies, issued before, join the first group
  __device__ void start(const Keys& keys, bf16* sk, bf16* sv, const PagedArgs& a, int h) {
#pragma unroll
    for (int j = 0; j < ST - 1; ++j) {
      if (live(j)) load(j, j, keys, sk, sv, a, h);
      cp_async_commit();
    }
  }
  // every thread, top of iteration `it`: tile `it` has landed and every warp
  // is done with tile it - 1, whose stage takes tile it + ST - 1
  __device__ void next(int it, const Keys& keys, bf16* sk, bf16* sv, const PagedArgs& a, int h) {
    cp_async_wait<ST - 2>();
    fence_async_smem();
    __syncthreads();
    const int jn = it + ST - 1;
    if (live(jn)) load(jn, jn % ST, keys, sk, sv, a, h);
    cp_async_commit();
  }
};

// Merges a unit's rows across the cluster once every rank's shares are in
// place: recv [CS][64][vown] float4 (this rank's 4-column vectors), recv_m /
// recv_l [CS][64] (base-2 maxima and sums).  Rows 0 .. live - 1 are written,
// row i at m / l index idx_of(i) and o / acc offset idx_of(i) * HD.
template <int HD, bool PARTIAL, class Idx>
__device__ void merge_out(const float4* recv, const float* recv_m, const float* recv_l,
                          float* s_w, int vown, int live, const PagedArgs& a, Idx idx_of) {
  const int tid = threadIdx.x, rank = blockIdx.x, CS = gridDim.x;
  if (tid < 64) {  // row tid: each rank's weight, in rank order
    float mm = -INFINITY;
    for (int k = 0; k < CS; ++k) mm = fmaxf(mm, recv_m[k * 64 + tid]);
    float lsum = 0.f;
    for (int k = 0; k < CS; ++k) {
      const float w = mm == -INFINITY ? 0.f : fast_exp2(recv_m[k * 64 + tid] - mm);
      s_w[k * 64 + tid] = w;
      lsum += w * recv_l[k * 64 + tid];
    }
    if (!PARTIAL) {
      const float inv = lsum > 0.f ? 1.f / lsum : 0.f;  // no key at all: 0
      for (int k = 0; k < CS; ++k) s_w[k * 64 + tid] *= inv;
    } else if (rank == 0 && tid < live) {
      const size_t idx = idx_of(tid);
      a.m[idx] = mm == -INFINITY ? kEmptyMax : mm * kLn2;  // natural-log units
      a.l[idx] = lsum;
    }
  }
  __syncthreads();
  for (int e = tid; e < max(live, 0) * vown; e += kNT) {
    const int pi = e / vown, v = e % vown, c4 = rank + v * CS;
    if (c4 >= HD / 4) continue;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < CS; ++k) {
      const float w = s_w[k * 64 + pi];
      const float4 x = recv[(k * 64 + pi) * vown + v];
      sum.x += w * x.x;
      sum.y += w * x.y;
      sum.z += w * x.z;
      sum.w += w * x.w;
    }
    const size_t off = idx_of(pi) * HD + 4 * c4;
    if constexpr (PARTIAL) {
      *reinterpret_cast<float4*>(a.acc + off) = sum;
    } else {
      *reinterpret_cast<uint2*>(a.o + off) =
          make_uint2(pack_bf16(sum.x, sum.y), pack_bf16(sum.z, sum.w));
    }
  }
}

// The merge buffers in a ring of `ring` (its tiles consumed): recv, recv_m,
// recv_l, s_w.
struct MergeBufs {
  float4* recv;
  float *m, *l, *w;
  int vown;
  float inv_cs;  // c4 / CS as (c4 + 0.5) * inv_cs: exact for these small ints
  __device__ MergeBufs(void* ring, int hd) {
    const int cs = gridDim.x;
    vown = (hd / 4 + cs - 1) / cs;
    inv_cs = 1.f / cs;
    recv = reinterpret_cast<float4*>(ring);
    m = reinterpret_cast<float*>(recv + cs * 64 * vown);
    l = m + cs * 64;
    w = l + cs * 64;
  }
  // where one row's column `col` goes in its owner's recv, and the owner
  __device__ float* slot(int row, int col, int* owner) const {
    const int c4 = col >> 2, q = static_cast<int>((c4 + 0.5f) * inv_cs);
    *owner = c4 - q * static_cast<int>(gridDim.x);
    return reinterpret_cast<float*>(recv + (blockIdx.x * 64 + row) * vown + q) + (col & 3);
  }
  // one row's value of column `col`, into its owner's recv
  __device__ void put(cg::cluster_group& cluster, int row, int col, float x) const {
    int owner;
    float* dst = slot(row, col, &owner);
    *cluster.map_shared_rank(dst, owner) = x;
  }
  // ... two adjacent columns (col even)
  __device__ void put2(cg::cluster_group& cluster, int row, int col, float x, float y) const {
    int owner;
    float* dst = slot(row, col, &owner);
    *reinterpret_cast<float2*>(cluster.map_shared_rank(dst, owner)) = make_float2(x, y);
  }
  // one row's m and l into every rank's recv_m / recv_l
  __device__ void put_ml(cg::cluster_group& cluster, int row, float mv, float lv) const {
    for (int k = 0; k < static_cast<int>(gridDim.x); ++k) {
      *cluster.map_shared_rank(m + blockIdx.x * 64 + row, k) = mv;
      *cluster.map_shared_rank(l + blockIdx.x * 64 + row, k) = lv;
    }
  }
};

// K3: the unit of slot z of the grid.  Returns in `work` the segment (table
// row, -1: no unit), its first row, its rows, the unit's index in it, and
// the count of `pads`: the pad rows i (ids outside [1, N]) with
// i % stride == me, this CTA's share (at most 65: stride >= T / 64).
// scratch: 3 N + 128 ints of shared memory.
template <int NT>
__device__ void find_unit(const int* seg, int T, int N, int g, int z, int me, int stride,
                          int* scratch, int* work) {
  int* first = scratch;
  int* end = first + N;
  int* pre = end + N;  // units before segment n
  int* pads = pre + N;
  for (int i = threadIdx.x; i < N; i += NT) {
    first[i] = 0;
    end[i] = 0;
  }
  if (threadIdx.x == 0) work[4] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < T; i += NT) {
    const int id = seg[i];
    if (id >= 1 && id <= N) {
      if (i == 0 || seg[i - 1] != id) first[id - 1] = i;
      if (i == T - 1 || seg[i + 1] != id) end[id - 1] = i + 1;
    } else if (i % stride == me) {
      pads[atomicAdd(work + 4, 1)] = i;
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int carry = 0;
    for (int base = 0; base < N; base += 32) {
      const int i = base + lane;
      const int units = i < N ? (max(end[i] - first[i], 0) * g + 63) / 64 : 0;
      int incl = units;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += y;
      }
      if (i < N) pre[i] = carry + incl - units;
      carry += __shfl_sync(kFull, incl, 31);
    }
    __syncwarp();
    if (lane == 0) {
      int n = -1;
      if (z < carry) {  // the last segment whose units start at or before z
        int lo = 0, hi = N - 1;
        while (lo < hi) {
          const int mid = (lo + hi + 1) / 2;
          if (pre[mid] <= z) lo = mid;
          else hi = mid - 1;
        }
        n = lo;
      }
      work[0] = n;
      work[1] = n >= 0 ? first[n] : 0;
      work[2] = n >= 0 ? end[n] - first[n] : 0;
      work[3] = n >= 0 ? z - pre[n] : 0;
    }
  }
  __syncthreads();
}

// K3.  grid (CS, hkv, unit slots), cluster (CS, 1, 1).
template <int HD, bool PARTIAL>
__global__ void __launch_bounds__(kNT, 1) ctx_attn_kernel(const PagedArgs a) {
  using Tl = CtxTiles<HD>;
  constexpr int BK = kBK, ST = Tl::ST, KR = ST + 1, NT = kNT, G = HD / 8;
  extern __shared__ unsigned char smem_raw[];
  bf16* sq = align_1024(smem_raw);  // [64][HD]
  bf16* sk = sq + 64 * HD;          // [ST][BK][HD]
  bf16* sv = sk + ST * BK * HD;     // [ST][BK][HD]
  __shared__ Ring<HD, ST> ring;
  __shared__ int s_work[5];

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rank = blockIdx.x, CS = gridDim.x;
  const int g = a.hq / a.hkv, h = blockIdx.y;
  int* scratch = reinterpret_cast<int*>(sk);
  find_unit<NT>(a.seg, a.T, a.N, g, blockIdx.z, blockIdx.z * CS + rank, gridDim.z * CS, scratch,
                s_work);
  // this CTA's share of the pad rows of kv head h's query heads
  const int* pads = scratch + 3 * a.N;
  for (int pi = 0; pi < s_work[4]; ++pi) {
    const size_t row = pads[pi], base = (row * a.hq + h * g) * HD;
    for (int e = tid; e < g * HD / 4; e += NT) {
      if constexpr (PARTIAL) {
        reinterpret_cast<float4*>(a.acc + base)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        reinterpret_cast<uint2*>(a.o + base)[e] = make_uint2(0u, 0u);
      }
    }
    if constexpr (PARTIAL) {
      for (int e = tid; e < g; e += NT) {
        a.m[row * a.hq + h * g + e] = kEmptyMax;
        a.l[row * a.hq + h * g + e] = 0.f;
      }
    }
  }
  const int n = s_work[0], row0 = s_work[1], nrows = s_work[2], mt = s_work[3];
  if (n < 0) return;  // the whole cluster: its ranks share blockIdx.z
  __syncthreads();    // the scratch is read: the ring may fill

  const int npairs = nrows * g, p0 = mt * 64;
  Keys keys(a.tables + static_cast<size_t>(n) * a.P, a.P, a.bs, a.nb, false);
  int ids[ST];
  if (tid < BK) {
#pragma unroll
    for (int j = 0; j < ST; ++j) ids[j] = keys.id(j, tid);
  }
  {  // the unit's q rows (zero past its pairs), in the first cp.async group
    const int r0 = tid / G, gcol = tid % G;
#pragma unroll
    for (int i = 0; i < 64 * G / NT; ++i) {
      const int r = r0 + i * (NT / G), pp = p0 + r;
      const bool ok = pp < npairs;
      const size_t off =
          ok ? (static_cast<size_t>(row0 + pp / g) * a.hq + h * g + pp % g) * HD + gcol * 8 : 0;
      cp_async16(smem_u32(sq + swz<64>(r, gcol)), a.q + off, ok);
    }
  }
  keys.set(a.lens[n], row0,
           a.include_pack ? row0 + min(npairs - 1, p0 + 63) / g + 1 : row0);
  if (tid < BK) {
#pragma unroll
    for (int j = 0; j < ST; ++j) ring.put(j, keys.row(j, tid, ids[j]));
  }
  __syncthreads();  // the first key rows
  ring.start(keys, sk, sv, a, h);
  const int nmine = keys.nmine;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const ScoreMap smap(a.scale, a.cap);
  const int row_a = warp * 16 + lane / 4;  // this thread's pairs: row_a, row_a + 8
  int prow[2];                             // ... and their pack rows
#pragma unroll
  for (int r = 0; r < 2; ++r) prow[r] = row0 + (p0 + row_a + 8 * r) / g;

  for (int it = 0; it < nmine; ++it) {
    const int ahead = tid < BK ? keys.id(it + ST, tid) : 0;
    ring.next(it, keys, sk, sv, a, h);
    const unsigned v0 = ring.valid[it % KR][0], v1 = ring.valid[it % KR][1];
    if (v0 | v1) {  // uniform: a tile with no key here is skipped whole
      const bf16* tk = sk + (it % ST) * BK * HD;
      const bf16* tv = sv + (it % ST) * BK * HD;
      float sc[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<BK>(sc, desc_k<64>(sq, 0, kk), desc_k<BK>(tk, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      const int ti = rank + it * CS;
      const bool pack = ti >= keys.nct;
      const int key0 = row0 + (ti - keys.nct) * BK;  // pack row of the tile's first key
      const bool masked = pack || (v0 & v1) != kFull;
      smap.apply_cap(sc);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        if (masked) {
          const int c = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          bool ok = (((i >> 2) < 4 ? v0 >> c : v1 >> (c - 32)) & 1u) != 0u;
          if (pack) ok = ok && key0 + c <= prow[(i >> 1) & 1];
          if (!ok) sc[i] = -INFINITY;
        }
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      }
      // m is in base-2 logits: p = 2^(sc * mul - m)
      float base[2], corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mnew = fmaxf(m[r], quad_max(mx[r]) * smap.mul);
        base[r] = mnew == -INFINITY ? 0.f : mnew;  // a pair with no key yet: p = 0
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
    if (tid < BK) ring.put(it + ST, keys.row(it + ST, tid, ahead));
  }
  cp_async_wait<0>();
  const int live_pairs = min(64, npairs - p0);
  auto idx_of = [&](int pi) {
    const int pp = p0 + pi;
    return static_cast<size_t>(row0 + pp / g) * a.hq + h * g + pp % g;
  };
  if (CS == 1) {  // one CTA a unit: its state is the unit's, written from registers
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int pi = row_a + 8 * r;
      const float lr = quad_sum(l[r]);
      if (pi >= live_pairs) continue;
      const size_t idx = idx_of(pi), off = idx * HD + 2 * (lane & 3);
      if constexpr (PARTIAL) {
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<float2*>(a.acc + off + 8 * j) =
              make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
        if ((lane & 3) == 0) {
          a.m[idx] = m[r] == -INFINITY ? kEmptyMax : m[r] * kLn2;  // natural-log units
          a.l[idx] = lr;
        }
      } else {
        const float inv = lr > 0.f ? 1.f / lr : 0.f;  // no key at all: 0
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<uint32_t*>(a.o + off + 8 * j) =
              pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
      }
    }
    return;
  }
  cluster.sync();  // every rank is done with its ring: the merge buffers take it over
  const MergeBufs mb(sk, HD);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      mb.put2(cluster, row, 8 * j + 2 * (lane & 3), acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    const float lr = quad_sum(l[r]);
    if ((lane & 3) == 0) mb.put_ml(cluster, row, m[r], lr);
  }
  cluster.sync();  // every share is in place
  merge_out<HD, PARTIAL>(mb.recv, mb.m, mb.l, mb.w, mb.vown, live_pairs, a, idx_of);
}

// K2.  grid (CS, hkv * mtiles, B), cluster (CS, 1, 1).  A unit: slot b's
// query heads hq0 .. hq0 + nh - 1 of kv head h, NQ of them in the products.
// S^T's accumulator: thread (w, l) holds key row 16 w + l / 4 + 8 r of the
// tile and head column 8 j + 2 (l % 4) + c at [4 j + 2 r + c]; O^T's chunk
// mc: hd row 64 mc + 16 w + l / 4 + 8 r, head column likewise.
template <int HD, int NQ, bool PARTIAL>
__global__ void __launch_bounds__(kNT, 1) decode_kernel(const PagedArgs a) {
  using Tl = DecodeTiles<HD, NQ>;
  constexpr int BK = kBK, ST = Tl::ST, NT = kNT, G = HD / 8, MC = HD / 64, NC = NQ / 4;
  extern __shared__ unsigned char smem_raw[];
  bf16* sk = align_1024(smem_raw);  // [ST][BK][HD]
  bf16* sv = sk + ST * BK * HD;     // [ST][BK][HD]
  bf16* sq = sv + ST * BK * HD;     // [NQ][HD]
  bf16* sp = sq + NQ * HD;          // [NQ][BK]: P^T, O^T's B operand (K-major)
  __shared__ Ring<HD, ST> ring;
  __shared__ float s_red[4][NQ];    // a column statistic of each warp's 16 keys

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int CS = gridDim.x;
  const int g = a.hq / a.hkv, h = blockIdx.y / a.mtiles, b = blockIdx.z;
  const int hq0 = (blockIdx.y % a.mtiles) * kDecodeHeads<HD>;
  const int nh = min(g - hq0, kDecodeHeads<HD>);  // the unit's live heads
  const size_t qrow0 = static_cast<size_t>(b) * a.hq + h * g + hq0;

  Keys keys(a.tables + static_cast<size_t>(b) * a.P, a.P, a.bs, a.nb, !PARTIAL);
  int ids[ST];
  if (tid < BK) {
#pragma unroll
    for (int j = 0; j < ST; ++j) ids[j] = keys.id(j, tid);
  }
  for (int idx = tid; idx < NQ * G; idx += NT) {  // q rows, zero past nh
    const int r = idx / G, gcol = idx % G;
    const bool ok = r < nh;
    cp_async16(smem_u32(sq + swz<NQ>(r, gcol)), a.q + (ok ? (qrow0 + r) * HD + gcol * 8 : 0),
               ok);
  }
  keys.set(a.lens[b], b, b);
  if (tid < BK) {
#pragma unroll
    for (int j = 0; j < ST; ++j) ring.put(j, keys.row(j, tid, ids[j]));
  }
  __syncthreads();  // the first key rows
  ring.start(keys, sk, sv, a, h);

  float acc[MC][NQ / 2];
#pragma unroll
  for (int mc = 0; mc < MC; ++mc)
#pragma unroll
    for (int i = 0; i < NQ / 2; ++i) acc[mc][i] = 0.f;
  float m[NC], l[NC];  // head column 8 j + 2 (l % 4) + c at [2 j + c]
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  const ScoreMap smap(a.scale, a.cap);
  const int key_a = warp * 16 + lane / 4;  // this thread's keys: key_a, key_a + 8

  for (int it = 0; it < keys.nmine; ++it) {
    const int ahead = tid < BK ? keys.id(it + ST, tid) : 0;
    ring.next(it, keys, sk, sv, a, h);
    const unsigned v0 = ring.valid[it % (ST + 1)][0], v1 = ring.valid[it % (ST + 1)][1];
    if (v0 | v1) {  // uniform: a tile with no key here is skipped whole
      const bf16* tk = sk + (it % ST) * BK * HD;
      const bf16* tv = sv + (it % ST) * BK * HD;
      float sc[NQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<NQ>(sc, desc_k<BK>(tk, 0, kk), desc_k<NQ>(sq, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      smap.apply_cap(sc);
      const unsigned vw = warp < 2 ? v0 : v1;  // this warp's 16 keys' bits
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!((vw >> ((key_a + 8 * r) & 31)) & 1u)) {
#pragma unroll
          for (int j = 0; j < NQ / 8; ++j) {
            sc[4 * j + 2 * r] = -INFINITY;
            sc[4 * j + 2 * r + 1] = -INFINITY;
          }
        }
      }
      // each head's max over the tile's keys: 2 here, 8 lanes, 4 warps
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = fmaxf(sc[4 * j + c], sc[4 * j + 2 + c]);
          x = fmaxf(x, __shfl_xor_sync(kFull, x, 4));
          x = fmaxf(x, __shfl_xor_sync(kFull, x, 8));
          x = fmaxf(x, __shfl_xor_sync(kFull, x, 16));
          if (lane < 4) s_red[warp][8 * j + 2 * lane + c] = x;
        }
      }
      __syncthreads();
      float base[NC], corr[NC];
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + 2 * (lane & 3) + c, i = 2 * j + c;
          const float x = fmaxf(fmaxf(s_red[0][col], s_red[1][col]),
                                fmaxf(s_red[2][col], s_red[3][col]));
          const float mnew = fmaxf(m[i], x * smap.mul);
          base[i] = mnew == -INFINITY ? 0.f : mnew;  // a head with no key yet: p = 0
          corr[i] = fast_exp2(m[i] - base[i]);
          m[i] = mnew;
          l[i] *= corr[i];
        }
      }
      // p, this thread's part of each head's sum, and P^T into shared memory
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int key = key_a + 8 * r;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = 8 * j + 2 * (lane & 3) + c, i = 2 * j + c;
            const float p = fast_exp2(fmaf(sc[4 * j + 2 * r + c], smap.mul, -base[i]));
            l[i] += p;
            sp[swz<NQ>(col, key >> 3) + (key & 7)] = __float2bfloat16(p);
          }
        }
      }
#pragma unroll
      for (int mc = 0; mc < MC; ++mc)
#pragma unroll
        for (int i = 0; i < NQ / 2; ++i) acc[mc][i] *= corr[2 * (i >> 2) + (i & 1)];
      fence_async_smem();
      __syncthreads();  // P^T complete
      wgmma_fence();
#pragma unroll
      for (int mc = 0; mc < MC; ++mc)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_ss<NQ, 1>(acc[mc], desc_mn<BK>(tv, kk, mc), desc_k<NQ>(sp, 0, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int mc = 0; mc < MC; ++mc) fence_regs(acc[mc]);
    }
    if (tid < BK) ring.put(it + ST, keys.row(it + ST, tid, ahead));
  }
  cp_async_wait<0>();

  // each head's sum over the 64 key rows: 8 lanes, then 4 warps
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    float x = l[i];
    x += __shfl_xor_sync(kFull, x, 4);
    x += __shfl_xor_sync(kFull, x, 8);
    x += __shfl_xor_sync(kFull, x, 16);
    if (lane < 4) s_red[warp][8 * (i >> 1) + 2 * lane + (i & 1)] = x;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int col = 8 * (i >> 1) + 2 * (lane & 3) + (i & 1);
    l[i] = s_red[0][col] + s_red[1][col] + s_red[2][col] + s_red[3][col];
  }
  auto idx_of = [&](int col) { return qrow0 + col; };
  if (CS == 1) {  // one CTA a unit: written from registers
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int col = 8 * (i >> 1) + 2 * (lane & 3) + (i & 1);
      if (col >= nh) continue;
      const size_t idx = idx_of(col);
      const float inv = PARTIAL ? 1.f : (l[i] > 0.f ? 1.f / l[i] : 0.f);  // no key at all: 0
#pragma unroll
      for (int mc = 0; mc < MC; ++mc) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int d = 64 * mc + key_a + 8 * r;
          const float x = acc[mc][4 * (i >> 1) + 2 * r + (i & 1)] * inv;
          if constexpr (PARTIAL) {
            a.acc[idx * HD + d] = x;
          } else {
            a.o[idx * HD + d] = __float2bfloat16(x);
          }
        }
      }
      if (PARTIAL && warp == 0 && lane < 4) {
        a.m[idx] = m[i] == -INFINITY ? kEmptyMax : m[i] * kLn2;  // natural-log units
        a.l[idx] = l[i];
      }
    }
    return;
  }
  cluster.sync();  // every rank is done with its ring: the merge buffers take it over
  const MergeBufs mb(sk, HD);
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int col = 8 * (i >> 1) + 2 * (lane & 3) + (i & 1);
#pragma unroll
    for (int mc = 0; mc < MC; ++mc)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        mb.put(cluster, col, 64 * mc + key_a + 8 * r, acc[mc][4 * (i >> 1) + 2 * r + (i & 1)]);
    if (warp == 0 && lane < 4) mb.put_ml(cluster, col, m[i], l[i]);
  }
  cluster.sync();  // every share is in place
  merge_out<HD, PARTIAL>(mb.recv, mb.m, mb.l, mb.w, mb.vown, nh, a, idx_of);
}

// CTAs a unit is split over: at most one wave of the CTAs the card holds at
// once (`per_sm` an SM; a CTA's fixed costs -- the prologue's loads, the
// cluster barriers -- make a second wave dearer than longer CTAs), at most
// kMaxCluster, and never more than a unit's most key tiles.  From shapes
// only.
inline int split_for(long units, long max_tiles, int per_sm) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long target = static_cast<long>(std::max(per_sm, 1)) * std::max(sms, 1);
  const long cs = std::min({target / std::max(units, 1L), static_cast<long>(kMaxCluster),
                            max_tiles});
  return static_cast<int>(std::max(cs, 1L));
}

template <class Kernel>
cudaError_t launch_split(Kernel kernel, size_t smem, const PagedArgs& a, int units_y,
                         int units_z, long max_tiles, int* per_sm, cudaStream_t stream) {
  if (*per_sm < 0) {  // once a kernel: its shared memory, and the CTAs an SM holds
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kNT, smem);
    if (err != cudaSuccess) return err;
  }
  const int cs = split_for(static_cast<long>(units_y) * units_z, max_tiles, *per_sm);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, units_y, units_z);
  cfg.blockDim = dim3(kNT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int HD, int NQ, bool PARTIAL>
cudaError_t launch_decode(const PagedArgs& a, int B, cudaStream_t stream) {
  static int per_sm = -1;
  const long max_tiles = (static_cast<long>(a.P) * a.bs + kBK - 1) / kBK;
  return launch_split(decode_kernel<HD, NQ, PARTIAL>, DecodeTiles<HD, NQ>::SMEM, a,
                      a.hkv * a.mtiles, B, max_tiles, &per_sm, stream);
}

// NQ: the unit's heads rounded up to 8, 16 or 64.
template <int HD, bool PARTIAL>
cudaError_t decode_hd(const PagedArgs& a, int B, cudaStream_t stream) {
  const int heads = std::min(a.hq / a.hkv, kDecodeHeads<HD>);
  if (heads <= 8) return launch_decode<HD, 8, PARTIAL>(a, B, stream);
  if (heads <= 16) return launch_decode<HD, 16, PARTIAL>(a, B, stream);
  if constexpr (kDecodeHeads<HD> > 16) return launch_decode<HD, 64, PARTIAL>(a, B, stream);
  return cudaErrorInvalidValue;
}

// Decode: a unit per (slot, kv head, kDecodeHeads query heads).
template <bool PARTIAL>
cudaError_t paged_decode(const PagedArgs& a, int B, int hd, cudaStream_t stream) {
  PagedArgs d = a;
  const int g = a.hq / a.hkv;
  switch (hd) {
    case 64:
      d.mtiles = (g + kDecodeHeads<64> - 1) / kDecodeHeads<64>;
      return decode_hd<64, PARTIAL>(d, B, stream);
    case 128:
      d.mtiles = (g + kDecodeHeads<128> - 1) / kDecodeHeads<128>;
      return decode_hd<128, PARTIAL>(d, B, stream);
    case 256:
      d.mtiles = (g + kDecodeHeads<256> - 1) / kDecodeHeads<256>;
      return decode_hd<256, PARTIAL>(d, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int HD, bool PARTIAL>
cudaError_t launch_ctx(const PagedArgs& a, int units, long max_tiles, cudaStream_t stream) {
  static int per_sm = -1;
  return launch_split(ctx_attn_kernel<HD, PARTIAL>, CtxTiles<HD>::SMEM, a, a.hkv, units,
                      max_tiles, &per_sm, stream);
}

// Packed context: unit slots for any segment layout of T rows.
template <bool PARTIAL>
cudaError_t ctx_attention(const PagedArgs& a, int hd, cudaStream_t stream) {
  const int g = a.hq / a.hkv;
  const long slots = (static_cast<long>(a.T) * g + 63) / 64 + std::min(a.N, a.T) - 1;
  const long max_tiles = (static_cast<long>(a.P) * a.bs + kBK - 1) / kBK + (a.T + kBK - 1) / kBK;
  if (slots < 1 || slots > 65535) return cudaErrorInvalidValue;
  const int units = static_cast<int>(slots);
  switch (hd) {
    case 64: return launch_ctx<64, PARTIAL>(a, units, max_tiles, stream);
    case 128: return launch_ctx<128, PARTIAL>(a, units, max_tiles, stream);
    case 256: return launch_ctx<256, PARTIAL>(a, units, max_tiles, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace dst
