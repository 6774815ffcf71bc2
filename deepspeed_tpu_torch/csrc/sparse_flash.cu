// Block-sparse causal flash attention, forward and backward, with packed
// segments, GQA and soft cap, on Hopper's tensor cores (wgmma): three
// kernels, no atomics, so dq, dk and dv are deterministic.
//
// Replaces: deepspeed_tpu/ops/pallas/flash_kernel.py `_fwd_sparse` (:587,
// the `pl.pallas_call` at :613) and `_bwd_sparse` (:638: the dq
// `pl.pallas_call` at :662, the dk/dv one at :687).
//
// What it computes: the functions of flash_fwd.cu (o and lse) and
// flash_bwd.cu (dq, dk, dv) with every block outside a layout masked: query
// row i of block I attends key j of block J only where the layout holds
// (I, J), j <= i and qseg[i] == kseg[j].  The layout arrives as tables built
// once on the host (ops/kernels/sparse_attention.py):
//   tbl [n, max_a], cnt [n]:   the active key blocks J <= I of query block I;
//   tblT [n, max_t], cntT [n]: the active query blocks I >= J of key block J;
//   perm, permT [n]:           the blocks by work, heaviest first.
// lse is in capped scaled-score units, as flash_fwd.cu writes it; delta =
// rowsum(dO * o) comes from one PyTorch reduction, as in JAX (:644).  dk / dv
// of a kv head sum over its g query heads in one CTA, where JAX repeats
// k / v and sums afterwards (:720-727): only the summation order differs.
//
// Bound on H100: 4 * hd flops per active causal (query, key, q-head) pair
// forward, 6 * hd for dq and 8 * hd for dk/dv (each recomputes q.k and
// dO.v) on the bf16 tensor cores (989 TFLOP/s) -- operation-bound at
// training shapes (b 8, s 4096, hq 8, hd 128, fixed(128, 4, 1): 0.096 ms
// forward, 0.24 ms for the backward pair).  Design: the dense kernels'
// bodies (flash_tc.cuh: every product a wgmma from 128 B-swizzled shared
// memory, a 2-stage cp.async ring, a CTA per query head, so head_dim 64 /
// 128 / 256 and any query group) walked over the layout's tables
// (TableWalk) instead of the causal range:
//   forward: a CTA owns 128 query rows of one head and visits the active
//            key blocks of its query block in 128-key tiles (64 at hd 256),
//            in the diagonal block only up to its last row;
//   dk/dv:   a CTA per (key tile, kv head, batch row) visits the active
//            query blocks of its key block in 64-row tiles, from its own
//            keys on in the diagonal block, for each of the g query heads;
//   dq:      a CTA per (query tile, query head, batch row) visits the
//            active key blocks in 64-key tiles.
// Blocks off the tables are never loaded; the causal mask runs only in the
// diagonal block, the segment mask only on tiles of mixed ids, and a tile
// whose key ids miss the rows' ids (kseg against qseg) is skipped.  A
// layout block (128 to 1024, a multiple of 128) holds block / 128 forward
// CTAs; CTAs start in perm / permT order, so the columns a `fixed` layout's
// later rows all read (up to 29 of 32 query blocks at s 4096) start first.
#include "flash_tc.cuh"

namespace dst {
namespace {

// The shape rules of the three entries on top of make_attn's: a layout block
// that is a multiple of 128 dividing s, non-empty tables, and segment ids
// for both queries and keys or for neither.
bool sparse_ok(const int* qseg, const int* kseg, int s, int block, int width) {
  return block > 0 && block % 128 == 0 && s % block == 0 && width > 0 &&
         (qseg == nullptr) == (kseg == nullptr);
}

}  // namespace
}  // namespace dst

// q [b, s, hq, hd], k / v [b, s, hkv, hd] bf16 contiguous; qseg / kseg
// [b, s] int32 (the query rows' and the keys' segment ids) or both null;
// o [b, s, hq, hd] bf16; lse [b, hq, s] fp32; tbl [s / block, max_a],
// cnt / perm [s / block] int32 on the device.  hd 64, 128 or 256, any hkv
// dividing hq.  cap <= 0 disables the soft cap.  Returns the launch's
// cudaGetLastError() (non-zero: nothing ran).
extern "C" int dst_sparse_fwd(const void* q, const void* k, const void* v, const int* qseg,
                              const int* kseg, void* o, float* lse, const int* tbl, const int* cnt,
                              const int* perm, int b, int s, int hq, int hkv, int hd, int block,
                              int max_a, float scale, float cap, void* stream) {
  dst::Attn a;
  if (!dst::sparse_ok(qseg, kseg, s, block, max_a) ||
      !dst::make_attn(q, k, v, qseg, kseg, b, s, hq, hkv, scale, cap, stream, &a))
    return cudaErrorInvalidValue;
  return dst::attn_fwd(a, hd, o, lse, dst::TableWalk{tbl, cnt, perm, block, max_a});
}

// The forward's inputs, with dout [b, s, hq, hd] bf16, lse [b, hq, s] and
// delta [b, s, hq] fp32; dq [b, s, hq, hd] bf16.  tbl / cnt / perm as for
// the forward.
extern "C" int dst_sparse_bwd_dq(const void* q, const void* k, const void* v, const int* qseg,
                                 const int* kseg, const void* dout, const float* lse,
                                 const float* delta, void* dq, const int* tbl, const int* cnt,
                                 const int* perm, int b, int s, int hq, int hkv, int hd, int block,
                                 int max_a, float scale, float cap, void* stream) {
  dst::Attn a;
  if (!dst::sparse_ok(qseg, kseg, s, block, max_a) ||
      !dst::make_attn(q, k, v, qseg, kseg, b, s, hq, hkv, scale, cap, stream, &a))
    return cudaErrorInvalidValue;
  return dst::attn_bwd_dq(a, hd, dout, lse, delta, dq,
                          dst::TableWalk{tbl, cnt, perm, block, max_a});
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
  dst::Attn a;
  if (!dst::sparse_ok(qseg, kseg, s, block, max_t) ||
      !dst::make_attn(q, k, v, qseg, kseg, b, s, hq, hkv, scale, cap, stream, &a))
    return cudaErrorInvalidValue;
  return dst::attn_bwd_dkv(a, hd, dout, lse, delta, dk, dv,
                           dst::TableWalk{tblT, cntT, permT, block, max_t});
}
