// One-token decode attention over the paged KV pool.
//
// Replaces: deepspeed_tpu/ops/pallas/paged_attention.py
// `paged_attention_decode_kernel` (the `pl.pallas_call` at :291), reached
// from every decode tick (`model_runner.decode_step` ->
// `paged.paged_attention_decode`), and, at HD = 64, `_paged_decode_packed`
// (:225, `pl.pallas_call` at :239: K2p).  The TPU packs the kv heads side
// by side on its 128-wide lanes with a block-diagonal q because a page
// slice of one hd-64 head is narrower than a lane tile; here a page row of
// one kv head is HD bf16 read as 16-byte vectors, so HD = 64 is the same
// kernel with no packing.
//
// What it computes: for slot b and query head hh, softmax over the first
// lens[b] positions of the slot's pages (block_table[b, pos / bs], row
// pos % bs) with the soft cap fused; fp32 softmax, bf16 out.  A -1 table
// entry is never dereferenced: it is clamped to page 0, as the TPU kernel
// does, so an inactive slot (len 1, all -1 row) still gives a finite row.
//
// Bound on H100: bytes.  Every live key and value row is read once:
// 2 * len * hkv * hd * 2 bytes per slot, a few flops per byte.  Design
// (attn_common.cuh): one CTA per (kv head, slot) serves the g query heads
// of that kv head, so each page row is read once for the group; the loop
// runs over ceil(len / bs) pages only, never over the table's width.  With
// one CTA per (slot, kv head) and pages fetched one 32-key tile at a time
// without prefetch, a short context leaves the memory system underused:
// the simple first version.  A warp owns the pairs p = warp + 4 i, so at
// g < 4 (MHA: g = 1, one pair) warps g..3 only load tiles and wait: at g = 1
// one warp does the dot products of a CTA.
#include "attn_common.cuh"

namespace dst {

constexpr int kPPW = 4;  // one row of g query heads per CTA
constexpr int kMaxPairs = kWarps * kPPW;

template <int HD>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kpool,
                    const bf16* __restrict__ vpool, const int* __restrict__ tables,
                    const int* __restrict__ lens, bf16* __restrict__ o, int hq, int hkv, int nb,
                    int bs, int P, float scale, float cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<HD> sm(smem_raw, kMaxPairs);
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = hq / hkv;
  const size_t qbase = (static_cast<size_t>(b) * hq + h * g) * HD;
  load_q<HD>(sm.q, g, scale, [&](int p) { return q + qbase + p * HD; });

  const int len = min(lens[b], P * bs);
  const int* row = tables + static_cast<size_t>(b) * P;
  PairState<HD, kPPW> st;
  st.init();
  for (int j0 = 0; j0 < len; j0 += kKeyTile) {
    __syncthreads();  // previous tile consumed; q written on the first pass
    load_tile<HD>(sm, [&](int t, const bf16** kp, const bf16** vp) {
      const int pos = j0 + t;
      if (pos >= len) return false;  // rows past the length are never read
      const int page = min(max(row[pos / bs], 0), nb - 1);
      const size_t off = ((static_cast<size_t>(page) * bs + pos % bs) * hkv + h) * HD;
      *kp = kpool + off;
      *vp = vpool + off;
      return true;
    });
    __syncthreads();
    attend_tile<HD>(sm, g, cap, st, [&](int, int t) { return j0 + t < len; });
  }
  store_out<HD>(st, g, [&](int p) { return o + qbase + p * HD; });
}

template <int HD>
cudaError_t launch(const void* q, const void* kpool, const void* vpool, const int* tables,
                   const int* lens, void* o, int B, int hq, int hkv, int nb, int bs, int P,
                   float scale, float cap, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD, kPPW>();
  cudaError_t err = allow_smem(paged_decode_kernel<HD>, smem);
  if (err != cudaSuccess) return err;
  paged_decode_kernel<HD><<<dim3(hkv, B), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kpool),
      static_cast<const bf16*>(vpool), tables, lens, static_cast<bf16*>(o), hq, hkv, nb, bs, P,
      scale, cap);
  return cudaGetLastError();
}

}  // namespace dst

// q [B, hq, hd]; pools [nb, bs, hkv, hd] bf16; tables [B, P] int32 (-1 pad);
// lens [B] int32 (including the current token); o [B, hq, hd] bf16.
extern "C" int dst_paged_decode(const void* q, const void* kpool, const void* vpool,
                                const int* tables, const int* lens, void* o, int B, int hq,
                                int hkv, int hd, int nb, int bs, int P, float scale, float cap,
                                void* stream) {
  if (hkv <= 0 || hq % hkv || hq / hkv > dst::kMaxPairs) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return dst::launch<64>(q, kpool, vpool, tables, lens, o, B, hq, hkv, nb, bs, P, scale, cap, st);
    case 128:
      return dst::launch<128>(q, kpool, vpool, tables, lens, o, B, hq, hkv, nb, bs, P, scale, cap, st);
    default:
      return cudaErrorInvalidValue;
  }
}
