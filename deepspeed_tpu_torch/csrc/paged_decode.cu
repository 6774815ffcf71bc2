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
// The partial mode (PARTIAL = true) is the seq-sharded decode's per-shard
// body, `deepspeed_tpu/inference/paged.py:558
// _paged_attention_decode_partial`, which JAX computes with jnp (no
// pallas_call): the same loop over one shard's slice of the pool, with the
// block table translated to that slice.  A table id outside [0, nb) is
// another shard's page (or padding) and is SKIPPED, never clamped -- a
// clamp would count page 0's keys on every shard -- and a key tile with no
// page of this shard is skipped whole.  It writes the unnormalized fp32
// triple (acc, m, l) for the log-sum-exp merge across shards; a slot with
// no key on this shard writes (0, -1e30, 0).
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

// Where a CTA writes: the normalized bf16 rows (o), or the partial triple.
struct DecodeOut {
  bf16* o;
  float* acc;
  float* m;
  float* l;
};

template <int HD, bool PARTIAL>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kpool,
                    const bf16* __restrict__ vpool, const int* __restrict__ tables,
                    const int* __restrict__ lens, DecodeOut out, int hq, int hkv, int nb,
                    int bs, int P, float scale, float cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int kpage[kKeyTile];
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
    int page = -1;  // -1: the key does not exist here
    if (threadIdx.x < kKeyTile && j0 + threadIdx.x < len) {
      page = row[(j0 + threadIdx.x) / bs];
      if (PARTIAL) {
        if (page >= nb) page = -1;  // another shard's page: skipped
      } else {
        page = min(max(page, 0), nb - 1);
      }
    }
    if (threadIdx.x < kKeyTile) kpage[threadIdx.x] = page;
    if (PARTIAL) {
      if (!__syncthreads_or(page >= 0)) continue;  // no key of this tile lives here
    } else {
      __syncthreads();
    }
    load_tile<HD>(sm, [&](int t, const bf16** kp, const bf16** vp) {
      const int pg = kpage[t];
      if (pg < 0) return false;  // rows past the length are never read
      const size_t off = ((static_cast<size_t>(pg) * bs + (j0 + t) % bs) * hkv + h) * HD;
      *kp = kpool + off;
      *vp = vpool + off;
      return true;
    });
    __syncthreads();
    attend_tile<HD>(sm, g, cap, st, [&](int, int t) { return kpage[t] >= 0; });
  }
  if (PARTIAL) {
    const size_t mbase = static_cast<size_t>(b) * hq + h * g;
    store_partial<HD>(st, g, [&](int p) { return out.acc + qbase + p * HD; }, out.m, out.l,
                      [&](int p) { return mbase + p; });
  } else {
    store_out<HD>(st, g, [&](int p) { return out.o + qbase + p * HD; });
  }
}

template <int HD, bool PARTIAL>
cudaError_t launch(const void* q, const void* kpool, const void* vpool, const int* tables,
                   const int* lens, DecodeOut out, int B, int hq, int hkv, int nb, int bs, int P,
                   float scale, float cap, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD, kPPW>();
  cudaError_t err = allow_smem(paged_decode_kernel<HD, PARTIAL>, smem);
  if (err != cudaSuccess) return err;
  paged_decode_kernel<HD, PARTIAL><<<dim3(hkv, B), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kpool),
      static_cast<const bf16*>(vpool), tables, lens, out, hq, hkv, nb, bs, P, scale, cap);
  return cudaGetLastError();
}

template <bool PARTIAL>
int dispatch(const void* q, const void* kpool, const void* vpool, const int* tables,
             const int* lens, DecodeOut out, int B, int hq, int hkv, int hd, int nb, int bs,
             int P, float scale, float cap, void* stream) {
  if (hkv <= 0 || hq % hkv || hq / hkv > kMaxPairs) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch<64, PARTIAL>(q, kpool, vpool, tables, lens, out, B, hq, hkv, nb, bs, P,
                                 scale, cap, st);
    case 128:
      return launch<128, PARTIAL>(q, kpool, vpool, tables, lens, out, B, hq, hkv, nb, bs, P,
                                  scale, cap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace dst

// q [B, hq, hd]; pools [nb, bs, hkv, hd] bf16; tables [B, P] int32 (-1 pad);
// lens [B] int32 (including the current token); o [B, hq, hd] bf16.
extern "C" int dst_paged_decode(const void* q, const void* kpool, const void* vpool,
                                const int* tables, const int* lens, void* o, int B, int hq,
                                int hkv, int hd, int nb, int bs, int P, float scale, float cap,
                                void* stream) {
  const dst::DecodeOut out{static_cast<dst::bf16*>(o), nullptr, nullptr, nullptr};
  return dst::dispatch<false>(q, kpool, vpool, tables, lens, out, B, hq, hkv, hd, nb, bs, P,
                              scale, cap, stream);
}

// The partial mode: tables translated to this shard's pool slice (ids
// outside [0, nb) are skipped); acc [B, hq, hd], m [B, hq], l [B, hq] fp32.
extern "C" int dst_paged_decode_partial(const void* q, const void* kpool, const void* vpool,
                                        const int* tables, const int* lens, float* acc, float* m,
                                        float* l, int B, int hq, int hkv, int hd, int nb, int bs,
                                        int P, float scale, float cap, void* stream) {
  const dst::DecodeOut out{nullptr, acc, m, l};
  return dst::dispatch<true>(q, kpool, vpool, tables, lens, out, B, hq, hkv, hd, nb, bs, P,
                             scale, cap, stream);
}
