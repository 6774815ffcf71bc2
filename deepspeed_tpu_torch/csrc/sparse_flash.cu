// Block-sparse causal flash attention, forward and backward, with packed
// segments, GQA and soft cap: three kernels, no atomics.
//
// Replaces: deepspeed_tpu/ops/pallas/flash_kernel.py `_fwd_sparse` (:587,
// the `pl.pallas_call` at :613) and `_bwd_sparse` (:638: the dq
// `pl.pallas_call` at :662, the dk/dv one at :687).
//
// What it computes: the functions of flash_fwd.cu (o and lse) and
// flash_bwd.cu (dq, dk, dv) with every block outside a layout masked: query
// row i of block I attends key j of block J only where the layout holds
// (I, J), j <= i and the segments of i and j agree.  The layout arrives as
// tables built once on the host (ops/kernels/sparse_attention.py):
//   tbl [n, max_a], cnt [n]:   the active key blocks J <= I of query block I;
//   tblT [n, max_t], cntT [n]: the active query blocks I >= J of key block J;
//   perm, permT [n]:           the blocks by work, heaviest first.
// Blocks off the tables are never read.  lse is in capped scaled-score
// units, as flash_fwd.cu writes it; delta = rowsum(dO * o) comes from one
// PyTorch reduction, as in JAX (:644).  dk / dv of a kv head sum over its g
// query heads in one CTA, where JAX repeats k / v and sums afterwards
// (:720-727): only the summation order differs.
//
// Bound on H100: 4 * hd flops per active causal (query, key, q-head) pair
// forward, 6 * hd for dq and 8 * hd for dk/dv (each recomputes q.k and
// dO.v) -- compute-bound at training shapes.  Design: the dense kernels'
// CUDA-core fp32 tiles (attn_common.cuh; no tensor cores yet: simple and
// right first), with the loop over keys (forward, dq) or query rows (dk/dv)
// walking the table's blocks instead of the causal triangle.  The layout
// block (128 to 1024, a multiple of 128) is the unit skipped; inside an
// active block the kernels walk their own 32-key / 32-pair tiles, and the
// causal mask bites only in the diagonal block.  A CTA's rows (forward: a
// power of two <= 64 / g rows, dq: <= 32 / g) or keys (dk/dv: 32) lie in one
// layout block.  The grid is (hkv, b, units) with the units in perm order,
// so the heaviest units of every head and batch row start first: the
// column counts of a `fixed` layout run from 1 to 29 at s 4096 (a global
// column is read by every later row).  A tile in which no key shares a
// segment with a row that may see it is skipped, as in the dense kernels;
// masked entries carry p = ds = 0 exactly and zero-filled rows.
#include "attn_common.cuh"

namespace dst {

constexpr int kFwdPPW = 16;                  // (row, head) pairs per warp, forward
constexpr int kFwdPairs = kWarps * kFwdPPW;  // 64
constexpr int kDqPPW = 8;
constexpr int kDqPairs = kWarps * kDqPPW;    // 32
constexpr int kKvPPW = 8;                    // keys per warp, dk/dv
constexpr int kKvKeys = kWarps * kKvPPW;     // 32 keys per dk/dv CTA
constexpr int kPairTile = 32;                // (row, head) pairs per dk/dv tile

// Query rows per CTA: the largest power of two r with r * g <= pairs (so it
// divides every layout block).
__host__ __device__ __forceinline__ int rows_per_cta(int pairs, int g) {
  int r = 1;
  while (2 * r * g <= pairs) r *= 2;
  return r;
}

// Threads 0..31 look at key j0 + t (< kend): record its segment in kseg_s
// and say whether a row r >= j - row0 of the CTA's nrows rows shares it.
// Returns the block-wide OR (a barrier).  With no segments every key < kend
// is needed.
__device__ __forceinline__ bool key_tile_needed(int j0, int kend, int row0, int nrows,
                                                const int* ksb, const int* qseg_s,
                                                int* kseg_s) {
  int need = 0;
  if (threadIdx.x < kKeyTile) {
    const int j = j0 + threadIdx.x;
    const int ks = (ksb && j < kend) ? ksb[j] : 0;
    kseg_s[threadIdx.x] = ks;
    if (j < kend) {
      if (!ksb) {
        need = 1;
      } else {
        for (int r = max(j - row0, 0); r < nrows; ++r) {
          if (qseg_s[r] == ks) {
            need = 1;
            break;
          }
        }
      }
    }
  }
  return __syncthreads_or(need);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
sparse_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ qseg,
                  const int* __restrict__ kseg, bf16* __restrict__ o, float* __restrict__ lse,
                  const int* __restrict__ tbl, const int* __restrict__ cnt,
                  const int* __restrict__ perm, int s, int hq, int hkv, int block, int max_a,
                  float scale, float cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int qseg_s[kFwdPairs];
  __shared__ int kseg_s[kKeyTile];
  const Smem<HD> sm(smem_raw, kFwdPairs);
  const int g = hq / hkv;
  const int bm = rows_per_cta(kFwdPairs, g);
  const int units = block / bm;  // CTAs per query block
  const int ib = perm[blockIdx.z / units];
  const int row0 = ib * block + (blockIdx.z % units) * bm;
  const int h = blockIdx.x, b = blockIdx.y;
  const int npairs = bm * g;
  const size_t qstride = static_cast<size_t>(hq) * HD;
  const size_t kstride = static_cast<size_t>(hkv) * HD;
  const bf16* qb = q + static_cast<size_t>(b) * s * qstride;
  const bf16* kb = k + static_cast<size_t>(b) * s * kstride + h * HD;
  const bf16* vb = v + static_cast<size_t>(b) * s * kstride + h * HD;
  bf16* ob = o + static_cast<size_t>(b) * s * qstride;
  const int* qsb = qseg ? qseg + static_cast<size_t>(b) * s : nullptr;
  const int* ksb = kseg ? kseg + static_cast<size_t>(b) * s : nullptr;
  auto pair_off = [&](int p) { return (row0 + p / g) * qstride + (h * g + p % g) * HD; };

  load_q<HD>(sm.q, npairs, scale, [&](int p) { return qb + pair_off(p); });
  for (int r = threadIdx.x; r < bm; r += blockDim.x) qseg_s[r] = qsb ? qsb[row0 + r] : 0;

  PairState<HD, kFwdPPW> st;
  st.init();
  const int* row_tbl = tbl + static_cast<size_t>(ib) * max_a;
  const int n_act = cnt[ib];
  const int last = row0 + bm;  // causal: no row of this CTA sees a key >= last
  for (int a = 0; a < n_act; ++a) {
    const int k_lo = row_tbl[a] * block;
    const int kend = min(k_lo + block, last);
    for (int j0 = k_lo; j0 < kend; j0 += kKeyTile) {
      __syncthreads();  // previous tile consumed; q / qseg written on the first pass
      if (!key_tile_needed(j0, kend, row0, bm, ksb, qseg_s, kseg_s)) continue;
      load_tile<HD>(sm, [&](int t, const bf16** kp, const bf16** vp) {
        const int j = j0 + t;
        if (j >= kend) return false;
        *kp = kb + j * kstride;
        *vp = vb + j * kstride;
        return true;
      });
      __syncthreads();
      attend_tile<HD>(sm, npairs, cap, st, [&](int p, int t) {
        const int r = p / g;
        return j0 + t <= row0 + r && (!ksb || kseg_s[t] == qseg_s[r]);
      });
    }
  }
  store_out<HD>(st, npairs, [&](int p) { return ob + pair_off(p); });
  if (threadIdx.x % 32 == 0) {
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int i = 0; i < kFwdPPW; ++i) {
      const int p = warp + kWarps * i;
      if (p >= npairs) break;
      const int head = h * g + p % g;
      lse[(static_cast<size_t>(b) * hq + head) * s + row0 + p / g] =
          st.m[i] + logf(fmaxf(st.l[i], 1e-30f));
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
sparse_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ qseg,
                     const int* __restrict__ kseg, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dq, const int* __restrict__ tbl,
                     const int* __restrict__ cnt, const int* __restrict__ perm, int s, int hq,
                     int hkv, int block, int max_a, float scale, float cap) {
  constexpr int kVpl = HD / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int qseg_s[kDqPairs];
  __shared__ int kseg_s[kKeyTile];
  __shared__ float lse_s[kDqPairs];
  __shared__ float delta_s[kDqPairs];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* dos = qs + kDqPairs * HD;
  bf16* kt = reinterpret_cast<bf16*>(dos + kDqPairs * HD);
  bf16* vt = kt + kKeyTile * (HD + 8);

  const int g = hq / hkv;
  const int bm = rows_per_cta(kDqPairs, g);
  const int units = block / bm;
  const int ib = perm[blockIdx.z / units];
  const int row0 = ib * block + (blockIdx.z % units) * bm;
  const int h = blockIdx.x, b = blockIdx.y;
  const int npairs = bm * g;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t qstride = static_cast<size_t>(hq) * HD;
  const size_t kstride = static_cast<size_t>(hkv) * HD;
  const bf16* qb = q + static_cast<size_t>(b) * s * qstride;
  const bf16* dob = dout + static_cast<size_t>(b) * s * qstride;
  const bf16* kb = k + static_cast<size_t>(b) * s * kstride + h * HD;
  const bf16* vb = v + static_cast<size_t>(b) * s * kstride + h * HD;
  const int* qsb = qseg ? qseg + static_cast<size_t>(b) * s : nullptr;
  const int* ksb = kseg ? kseg + static_cast<size_t>(b) * s : nullptr;
  auto pair_off = [&](int p) { return (row0 + p / g) * qstride + (h * g + p % g) * HD; };

  load_q<HD>(qs, npairs, scale, [&](int p) { return qb + pair_off(p); });
  load_q<HD>(dos, npairs, 1.f, [&](int p) { return dob + pair_off(p); });
  for (int p = threadIdx.x; p < npairs; p += blockDim.x) {
    const int row = row0 + p / g, head = h * g + p % g;
    lse_s[p] = lse[(static_cast<size_t>(b) * hq + head) * s + row];
    delta_s[p] = delta[(static_cast<size_t>(b) * s + row) * hq + head];
  }
  for (int r = threadIdx.x; r < bm; r += blockDim.x) qseg_s[r] = qsb ? qsb[row0 + r] : 0;

  float acc[kDqPPW][kVpl];
#pragma unroll
  for (int i = 0; i < kDqPPW; ++i)
#pragma unroll
    for (int c = 0; c < kVpl; ++c) acc[i][c] = 0.f;

  const int* row_tbl = tbl + static_cast<size_t>(ib) * max_a;
  const int n_act = cnt[ib];
  const int last = row0 + bm;
  for (int a = 0; a < n_act; ++a) {
    const int k_lo = row_tbl[a] * block;
    const int kend = min(k_lo + block, last);
    for (int j0 = k_lo; j0 < kend; j0 += kKeyTile) {
      __syncthreads();  // previous tile consumed; rows / qseg written on the first pass
      if (!key_tile_needed(j0, kend, row0, bm, ksb, qseg_s, kseg_s)) continue;
      load_rows_bf16<HD>(kt, kKeyTile, [&](int t) {
        return j0 + t < kend ? kb + (j0 + t) * kstride : nullptr;
      });
      load_rows_bf16<HD>(vt, kKeyTile, [&](int t) {
        return j0 + t < kend ? vb + (j0 + t) * kstride : nullptr;
      });
      __syncthreads();
      const bf16* krow = kt + lane * (HD + 8);
      const bf16* vrow = vt + lane * (HD + 8);
#pragma unroll
      for (int i = 0; i < kDqPPW; ++i) {
        const int p = warp + kWarps * i;
        if (p >= npairs) break;  // uniform across the warp
        const int r = p / g;
        const float sraw = dot_f32_bf16<HD>(qs + p * HD, krow);
        const float dp = dot_f32_bf16<HD>(dos + p * HD, vrow);
        const bool ok = j0 + lane <= row0 + r && (!ksb || kseg_s[lane] == qseg_s[r]);
        float ds;
        prob_and_ds(sraw, ok, lse_s[p], dp, delta_s[p], scale, cap, &ds);
#pragma unroll 8
        for (int t = 0; t < kKeyTile; ++t) {
          const float dst_ = __shfl_sync(kFull, ds, t);
          float kv[kVpl];
          load_bf16<kVpl>(kt + t * (HD + 8) + lane * kVpl, kv);
#pragma unroll
          for (int c = 0; c < kVpl; ++c) acc[i][c] += dst_ * kv[c];
        }
      }
    }
  }
  bf16* dqb = dq + static_cast<size_t>(b) * s * qstride;
#pragma unroll
  for (int i = 0; i < kDqPPW; ++i) {
    const int p = warp + kWarps * i;
    if (p >= npairs) break;
    bf16* out = dqb + pair_off(p) + lane * kVpl;
#pragma unroll
    for (int c = 0; c < kVpl; ++c) out[c] = __float2bfloat16(acc[i][c]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
sparse_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const int* __restrict__ qseg,
                      const int* __restrict__ kseg, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv,
                      const int* __restrict__ tblT, const int* __restrict__ cntT,
                      const int* __restrict__ permT, int s, int hq, int hkv, int block,
                      int max_t, float scale, float cap) {
  constexpr int kVpl = HD / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int kseg_s[kKvKeys];
  __shared__ int row_t[kPairTile];
  __shared__ int qseg_t[kPairTile];
  __shared__ float lse_t[kPairTile];
  __shared__ float delta_t[kPairTile];
  float* kf = reinterpret_cast<float*>(smem_raw);
  float* vf = kf + kKvKeys * HD;
  bf16* qt = reinterpret_cast<bf16*>(vf + kKvKeys * HD);
  bf16* dot = qt + kPairTile * (HD + 8);

  const int g = hq / hkv;
  const int units = block / kKvKeys;  // CTAs per key block
  const int jb = permT[blockIdx.z / units];
  const int k0 = jb * block + (blockIdx.z % units) * kKvKeys;
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t qstride = static_cast<size_t>(hq) * HD;
  const size_t kstride = static_cast<size_t>(hkv) * HD;
  const bf16* qb = q + static_cast<size_t>(b) * s * qstride;
  const bf16* dob = dout + static_cast<size_t>(b) * s * qstride;
  const bf16* kb = k + static_cast<size_t>(b) * s * kstride + h * HD;
  const bf16* vb = v + static_cast<size_t>(b) * s * kstride + h * HD;
  const int* qsb = qseg ? qseg + static_cast<size_t>(b) * s : nullptr;
  const int* ksb = kseg ? kseg + static_cast<size_t>(b) * s : nullptr;

  load_q<HD>(kf, kKvKeys, scale, [&](int j) { return kb + (k0 + j) * kstride; });
  load_q<HD>(vf, kKvKeys, 1.f, [&](int j) { return vb + (k0 + j) * kstride; });
  for (int j = threadIdx.x; j < kKvKeys; j += blockDim.x) kseg_s[j] = ksb ? ksb[k0 + j] : 0;

  float acc_k[kKvPPW][kVpl], acc_v[kKvPPW][kVpl];
#pragma unroll
  for (int i = 0; i < kKvPPW; ++i)
#pragma unroll
    for (int c = 0; c < kVpl; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int* col_tbl = tblT + static_cast<size_t>(jb) * max_t;
  const int n_act = cntT[jb];  // 0 for a column no row reads: dk = dv = 0
  for (int a = 0; a < n_act; ++a) {
    const int ib = col_tbl[a];
    const int r_lo = max(ib * block, k0);  // causal: rows < k0 see none of these keys
    // (row, head) pairs of rows r_lo.. in the block, head inner: pair P is
    // row r_lo + P / g
    const int npq = (ib * block + block - r_lo) * g;
    for (int p0 = 0; p0 < npq; p0 += kPairTile) {
      __syncthreads();  // previous tile consumed; kseg written on the first pass
      int need = 0;
      if (threadIdx.x < kPairTile) {
        const int pp = p0 + threadIdx.x;
        int row = -1;
        if (pp < npq) {
          row = r_lo + pp / g;
          const int head = h * g + pp % g;
          lse_t[threadIdx.x] = lse[(static_cast<size_t>(b) * hq + head) * s + row];
          delta_t[threadIdx.x] = delta[(static_cast<size_t>(b) * s + row) * hq + head];
          const int qsg = qsb ? qsb[row] : 0;
          qseg_t[threadIdx.x] = qsg;
          if (!ksb) {
            need = 1;  // every row >= k0 sees key k0
          } else {
            for (int j = 0; j < kKvKeys && k0 + j <= row; ++j) {
              if (kseg_s[j] == qsg) {
                need = 1;
                break;
              }
            }
          }
        }
        row_t[threadIdx.x] = row;
      }
      if (!__syncthreads_or(need)) continue;  // no shared segment: the tile adds nothing
      auto pair_row = [&](const bf16* base, int t) -> const bf16* {
        const int pp = p0 + t;
        return row_t[t] >= 0 ? base + row_t[t] * qstride + (h * g + pp % g) * HD : nullptr;
      };
      load_rows_bf16<HD>(qt, kPairTile, [&](int t) { return pair_row(qb, t); });
      load_rows_bf16<HD>(dot, kPairTile, [&](int t) { return pair_row(dob, t); });
      __syncthreads();
      const bf16* qrow = qt + lane * (HD + 8);
      const bf16* dorow = dot + lane * (HD + 8);
      const int row = row_t[lane];
#pragma unroll
      for (int i = 0; i < kKvPPW; ++i) {
        const int j = warp + kWarps * i;
        const float sraw = dot_f32_bf16<HD>(kf + j * HD, qrow);
        const float dp = dot_f32_bf16<HD>(vf + j * HD, dorow);
        const bool ok = row >= k0 + j && (!ksb || qseg_t[lane] == kseg_s[j]);
        float ds;
        const float pr = prob_and_ds(sraw, ok, lse_t[lane], dp, delta_t[lane], scale, cap, &ds);
#pragma unroll 8
        for (int t = 0; t < kPairTile; ++t) {
          const float pt = __shfl_sync(kFull, pr, t);
          const float dst_ = __shfl_sync(kFull, ds, t);
          float qv[kVpl], dv_[kVpl];
          load_bf16<kVpl>(qt + t * (HD + 8) + lane * kVpl, qv);
          load_bf16<kVpl>(dot + t * (HD + 8) + lane * kVpl, dv_);
#pragma unroll
          for (int c = 0; c < kVpl; ++c) {
            acc_k[i][c] += dst_ * qv[c];
            acc_v[i][c] += pt * dv_[c];
          }
        }
      }
    }
  }
  const size_t obase = static_cast<size_t>(b) * s * kstride + h * HD;
#pragma unroll
  for (int i = 0; i < kKvPPW; ++i) {
    const int j = warp + kWarps * i;
    bf16* ok_ = dk + obase + (k0 + j) * kstride + lane * kVpl;
    bf16* ov_ = dv + obase + (k0 + j) * kstride + lane * kVpl;
#pragma unroll
    for (int c = 0; c < kVpl; ++c) {
      ok_[c] = __float2bfloat16(acc_k[i][c]);
      ov_[c] = __float2bfloat16(acc_v[i][c]);
    }
  }
}

// The grid of a kernel whose units are `unit_rows` rows (or keys) of a
// layout block: (hkv, b, s / unit_rows); false where it does not fit.
inline bool unit_grid(int b, int s, int hkv, int unit_rows, dim3* grid) {
  const int units = s / unit_rows;
  if (units > 65535 || b > 65535) return false;
  *grid = dim3(hkv, b, units);
  return true;
}

template <int HD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const int* qseg,
                       const int* kseg, void* o, float* lse, const int* tbl, const int* cnt,
                       const int* perm, int b, int s, int hq, int hkv, int block, int max_a,
                       float scale, float cap, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD, kFwdPPW>();
  cudaError_t err = allow_smem(sparse_fwd_kernel<HD>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid;
  if (!unit_grid(b, s, hkv, rows_per_cta(kFwdPairs, hq / hkv), &grid)) return cudaErrorInvalidValue;
  sparse_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), qseg,
      kseg, static_cast<bf16*>(o), lse, tbl, cnt, perm, s, hq, hkv, block, max_a, scale, cap);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const int* qseg,
                      const int* kseg, const void* dout, const float* lse, const float* delta,
                      void* dq, const int* tbl, const int* cnt, const int* perm, int b, int s,
                      int hq, int hkv, int block, int max_a, float scale, float cap,
                      cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * kDqPairs * HD + sizeof(bf16) * 2 * kKeyTile * (HD + 8);
  cudaError_t err = allow_smem(sparse_bwd_dq_kernel<HD>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid;
  if (!unit_grid(b, s, hkv, rows_per_cta(kDqPairs, hq / hkv), &grid)) return cudaErrorInvalidValue;
  sparse_bwd_dq_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), qseg,
      kseg, static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), tbl, cnt, perm, s,
      hq, hkv, block, max_a, scale, cap);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const int* qseg,
                       const int* kseg, const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, const int* tblT, const int* cntT, const int* permT,
                       int b, int s, int hq, int hkv, int block, int max_t, float scale,
                       float cap, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * kKvKeys * HD + sizeof(bf16) * 2 * kPairTile * (HD + 8);
  cudaError_t err = allow_smem(sparse_bwd_dkv_kernel<HD>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid;
  if (!unit_grid(b, s, hkv, kKvKeys, &grid)) return cudaErrorInvalidValue;
  sparse_bwd_dkv_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), qseg,
      kseg, static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), tblT, cntT, permT, s, hq, hkv, block, max_t, scale, cap);
  return cudaGetLastError();
}

// Shape rules shared by the three entries: GQA groups of at most 32 query
// heads, a layout block that is a multiple of 128 dividing s, and segment
// ids for both queries and keys or for neither.
inline bool shapes_ok(const int* qseg, const int* kseg, int s, int hq, int hkv, int block,
                      int width) {
  return hkv > 0 && hq % hkv == 0 && hq / hkv <= kDqPairs && block > 0 && block % 128 == 0 &&
         s % block == 0 && width > 0 && (qseg == nullptr) == (kseg == nullptr);
}

}  // namespace dst

// q [b, s, hq, hd], k / v [b, s, hkv, hd] bf16 contiguous; qseg / kseg
// [b, s] int32 (the query rows' and the keys' segment ids) or both null;
// o [b, s, hq, hd] bf16; lse [b, hq, s] fp32; tbl [s / block, max_a],
// cnt / perm [s / block] int32 on the device.  cap <= 0 disables the soft
// cap.  Returns the launch's cudaGetLastError() (non-zero: nothing ran).
extern "C" int dst_sparse_fwd(const void* q, const void* k, const void* v, const int* qseg,
                              const int* kseg, void* o, float* lse, const int* tbl, const int* cnt,
                              const int* perm, int b, int s, int hq, int hkv, int hd, int block,
                              int max_a, float scale, float cap, void* stream) {
  if (!dst::shapes_ok(qseg, kseg, s, hq, hkv, block, max_a)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return dst::launch_fwd<64>(q, k, v, qseg, kseg, o, lse, tbl, cnt, perm, b, s, hq, hkv, block, max_a, scale, cap, st);
    case 128: return dst::launch_fwd<128>(q, k, v, qseg, kseg, o, lse, tbl, cnt, perm, b, s, hq, hkv, block, max_a, scale, cap, st);
    default: return cudaErrorInvalidValue;
  }
}

// The forward's inputs, with dout [b, s, hq, hd] bf16, lse [b, hq, s] and
// delta [b, s, hq] fp32; dq [b, s, hq, hd] bf16.  tbl / cnt / perm as for
// the forward.
extern "C" int dst_sparse_bwd_dq(const void* q, const void* k, const void* v, const int* qseg,
                                 const int* kseg, const void* dout, const float* lse,
                                 const float* delta, void* dq, const int* tbl, const int* cnt,
                                 const int* perm, int b, int s, int hq, int hkv, int hd, int block,
                                 int max_a, float scale, float cap, void* stream) {
  if (!dst::shapes_ok(qseg, kseg, s, hq, hkv, block, max_a)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return dst::launch_dq<64>(q, k, v, qseg, kseg, dout, lse, delta, dq, tbl, cnt, perm, b, s, hq, hkv, block, max_a, scale, cap, st);
    case 128: return dst::launch_dq<128>(q, k, v, qseg, kseg, dout, lse, delta, dq, tbl, cnt, perm, b, s, hq, hkv, block, max_a, scale, cap, st);
    default: return cudaErrorInvalidValue;
  }
}

// The same inputs with the transposed tables tblT [s / block, max_t],
// cntT / permT [s / block]; dk / dv [b, s, hkv, hd] bf16, each summed over
// the g query heads of its kv head.
extern "C" int dst_sparse_bwd_dkv(const void* q, const void* k, const void* v, const int* qseg,
                                  const int* kseg, const void* dout, const float* lse,
                                  const float* delta, void* dk, void* dv, const int* tblT,
                                  const int* cntT, const int* permT, int b, int s, int hq,
                                  int hkv, int hd, int block, int max_t, float scale, float cap,
                                  void* stream) {
  if (!dst::shapes_ok(qseg, kseg, s, hq, hkv, block, max_t)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return dst::launch_dkv<64>(q, k, v, qseg, kseg, dout, lse, delta, dk, dv, tblT, cntT, permT, b, s, hq, hkv, block, max_t, scale, cap, st);
    case 128: return dst::launch_dkv<128>(q, k, v, qseg, kseg, dout, lse, delta, dk, dv, tblT, cntT, permT, b, s, hq, hkv, block, max_t, scale, cap, st);
    default: return cudaErrorInvalidValue;
  }
}
