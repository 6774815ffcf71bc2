// Causal flash-attention forward with packed segments, GQA and soft cap, on
// Hopper's tensor cores (wgmma).
//
// Replaces: deepspeed_tpu/ops/pallas/flash_kernel.py `_fwd` (the
// `pl.pallas_call` at :279, entry `pallas_flash_attention` :796): the
// training forward (with lse) and serving's cold packed prefill
// (`model_runner.prefill_packed`, no lse).
//
// What it computes: o[b, i, h] = softmax_j(cap(q_i . k_j * scale)) v_j over
// keys j with j <= i and seg[b, j] == seg[b, i] (every key when seg is
// null), kv head h / (hq / hkv); fp32 softmax, bf16 in and out.  With a
// non-null `lse` it also writes lse[b, h, i] = m + log(l), the log-sum-exp of
// the capped scaled scores (flash_kernel.py:170), from which the backward
// (flash_bwd.cu) rebuilds the probabilities; serving passes null.
//
// Bound on H100: 4 * hd flops per causal in-segment (query, key, q-head) on
// the bf16 tensor cores (989 TFLOP/s) -- operation-bound for long segments
// (b 8, s 4096, hq 8, hd 128: 0.28 ms), byte-bound for the short segments of
// a serving pack.  Design:
//   - one CTA of two consumer warpgroups owns 128 query rows (64 each) of ONE
//     query head; its kv head is h / g, so any group size runs, and the g
//     heads of a group re-read the same K / V tiles from the 50 MB L2;
//   - S = Q K^T is wgmma m64nBKk16 with Q and K in shared memory; O += P V is
//     the register-A form, P converted to bf16 in registers, V [key][hd]
//     read MN-major (transposed B); the online softmax (m, l) stays in fp32
//     registers, row max and sum over the accumulator's quad lanes;
//   - K / V tiles of BK keys stream through a 2-stage cp.async ring into the
//     128 B-swizzled layout the descriptors read (tc_common.cuh): the next
//     tile loads while this one is multiplied;
//   - key tiles above the causal diagonal are never loaded, and a tile whose
//     segment range misses the query tile's is skipped (a serving pack of
//     16 x 128 loads only its diagonal tiles); a warpgroup whose 64 rows see
//     none of a loaded tile skips its products; the mask is applied only on
//     diagonal tiles and on tiles of mixed segments;
//   - the heaviest query tiles (the last rows) are launched first.
// The body is flash_tc.cuh's, shared with the block-sparse forward
// (sparse_flash.cu); this file walks it over the causal range (DenseWalk).
#include "flash_tc.cuh"

// q [b, s, hq, hd], k/v [b, s, hkv, hd] bf16 contiguous; seg [b, s] int32 or
// null; o [b, s, hq, hd] bf16; lse [b, hq, s] fp32 or null.  hd 64, 128 or
// 256, any hkv dividing hq, any s >= 1.  cap <= 0 disables the soft cap.
// Returns the launch's cudaGetLastError() (non-zero: nothing ran).
extern "C" int dst_flash_fwd(const void* q, const void* k, const void* v, const int* seg, void* o,
                             float* lse, int b, int s, int hq, int hkv, int hd, float scale,
                             float cap, void* stream) {
  dst::Attn a;
  if (!dst::make_attn(q, k, v, seg, seg, b, s, hq, hkv, scale, cap, stream, &a))
    return cudaErrorInvalidValue;
  return dst::attn_fwd(a, hd, o, lse, dst::DenseWalk{});
}
