// One-token decode attention over the paged KV pool, on Hopper's tensor
// cores (wgmma).
//
// Replaces: deepspeed_tpu/ops/pallas/paged_attention.py
// `paged_attention_decode_kernel` (:270, the `pl.pallas_call` at :291),
// reached from every decode tick (`model_runner.decode_step` ->
// `paged.paged_attention_decode`), and, at HD = 64, `_paged_decode_packed`
// (:225, `pl.pallas_call` at :239: K2p).  The TPU packs the kv heads side
// by side on its 128-wide lanes with a block-diagonal q because a page
// slice of one hd-64 head is narrower than a lane tile; here a page row of
// one kv head is gathered as 16-byte vectors, so HD = 64 is the same kernel
// with no packing.
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
// pallas_call): the same kernel over one shard's slice of the pool, with the
// block table translated to that slice.  A table id outside [0, nb) is
// another shard's page (or padding) and is SKIPPED, never clamped -- a
// clamp would count page 0's keys on every shard -- and a key tile with no
// page of this shard is skipped whole.  It writes the unnormalized fp32
// triple (acc, m, l) for the log-sum-exp merge across shards; a slot with
// no key on this shard writes (0, -1e30, 0).
//
// Bound on H100: bytes.  Every live key and value row is read once:
// 2 * len * hkv * hd * 2 bytes per slot against 4 * hd flops per (query
// head, key) -- far under the tensor cores' 295 flops a byte.  Design
// (paged_tc.cuh `decode_kernel`, beside K3's body): a unit is one slot's
// query heads of one kv head (up to 64, 16 at hd 256), so a page row is read
// once for its group.  One row a slot leaves nothing for a wgmma's M = 64 in
// the (row, head) form, so the operands are swapped: the 64 keys of a tile
// are M in S^T = K Q^T and the head dim is M in O^T += V^T P^T, with the
// heads as N (8, 16 or 64): at g = 1 every warp multiplies, and a tile
// costs an eighth of the products and exponentials of the pair form.  K / V
// tiles of 64 keys are gathered row by row from their pages by cp.async
// into a ring, so tiles are in flight while one is multiplied; each unit's
// tiles are dealt over a cluster of CTAs (flash-decoding's split, sized from
// B, hkv and the table's width to one wave) and merged through distributed
// shared memory, so the longest slot no longer sets the time alone.
#include "paged_tc.cuh"

namespace {

dst::PagedArgs decode_args(const void* q, const void* kpool, const void* vpool,
                           const int* tables, const int* lens, int hq, int hkv, int nb, int bs,
                           int P, float scale, float cap) {
  dst::PagedArgs a = {};
  a.q = static_cast<const dst::bf16*>(q);
  a.kpool = static_cast<const dst::bf16*>(kpool);
  a.vpool = static_cast<const dst::bf16*>(vpool);
  a.tables = tables;
  a.lens = lens;
  a.hq = hq;
  a.hkv = hkv;
  a.nb = nb;
  a.bs = bs;
  a.P = P;
  a.scale = scale;
  a.cap = cap;
  return a;
}

bool shapes_ok(int B, int hq, int hkv, int nb, int bs, int P) {
  return hkv > 0 && hq % hkv == 0 && B > 0 && B <= 65535 && nb > 0 && bs > 0 && P > 0;
}

}  // namespace

// q [B, hq, hd]; pools [nb, bs, hkv, hd] bf16; tables [B, P] int32 (-1 pad);
// lens [B] int32 (including the current token); o [B, hq, hd] bf16.  hd 64,
// 128 or 256, any hkv dividing hq.
extern "C" int dst_paged_decode(const void* q, const void* kpool, const void* vpool,
                                const int* tables, const int* lens, void* o, int B, int hq,
                                int hkv, int hd, int nb, int bs, int P, float scale, float cap,
                                void* stream) {
  if (!shapes_ok(B, hq, hkv, nb, bs, P)) return cudaErrorInvalidValue;
  dst::PagedArgs a = decode_args(q, kpool, vpool, tables, lens, hq, hkv, nb, bs, P, scale, cap);
  a.o = static_cast<dst::bf16*>(o);
  return dst::paged_decode<false>(a, B, hd, static_cast<cudaStream_t>(stream));
}

// The partial mode: tables translated to this shard's pool slice (ids
// outside [0, nb) are skipped); acc [B, hq, hd], m [B, hq], l [B, hq] fp32.
extern "C" int dst_paged_decode_partial(const void* q, const void* kpool, const void* vpool,
                                        const int* tables, const int* lens, float* acc, float* m,
                                        float* l, int B, int hq, int hkv, int hd, int nb, int bs,
                                        int P, float scale, float cap, void* stream) {
  if (!shapes_ok(B, hq, hkv, nb, bs, P)) return cudaErrorInvalidValue;
  dst::PagedArgs a = decode_args(q, kpool, vpool, tables, lens, hq, hkv, nb, bs, P, scale, cap);
  a.acc = acc;
  a.m = m;
  a.l = l;
  return dst::paged_decode<true>(a, B, hd, static_cast<cudaStream_t>(stream));
}
