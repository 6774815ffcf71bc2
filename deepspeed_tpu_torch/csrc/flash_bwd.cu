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
// zero-filled rows beyond s carry p = ds = 0, so they add nothing.  The
// bodies are flash_tc.cuh's, shared with the block-sparse backward
// (sparse_flash.cu); this file walks them over the causal range (DenseWalk).
#include "flash_tc.cuh"

// q / dout [b, s, hq, hd], k / v [b, s, hkv, hd] bf16 contiguous; seg [b, s]
// int32 or null; lse [b, hq, s] and delta [b, s, hq] fp32; dq [b, s, hq, hd]
// bf16.  hd 64, 128 or 256, any hkv dividing hq.  cap <= 0 disables the
// soft cap.  Returns the launch's cudaGetLastError() (non-zero: nothing ran).
extern "C" int dst_flash_bwd_dq(const void* q, const void* k, const void* v, const int* seg,
                                const void* dout, const float* lse, const float* delta, void* dq,
                                int b, int s, int hq, int hkv, int hd, float scale, float cap,
                                void* stream) {
  dst::Attn a;
  if (!dst::make_attn(q, k, v, seg, seg, b, s, hq, hkv, scale, cap, stream, &a))
    return cudaErrorInvalidValue;
  return dst::attn_bwd_dq(a, hd, dout, lse, delta, dq, dst::DenseWalk{});
}

// The same inputs; dk / dv [b, s, hkv, hd] bf16, each summed over the g
// query heads of its kv head.
extern "C" int dst_flash_bwd_dkv(const void* q, const void* k, const void* v, const int* seg,
                                 const void* dout, const float* lse, const float* delta, void* dk,
                                 void* dv, int b, int s, int hq, int hkv, int hd, float scale,
                                 float cap, void* stream) {
  dst::Attn a;
  if (!dst::make_attn(q, k, v, seg, seg, b, s, hq, hkv, scale, cap, stream, &a))
    return cudaErrorInvalidValue;
  return dst::attn_bwd_dkv(a, hd, dout, lse, delta, dk, dv, dst::DenseWalk{});
}
