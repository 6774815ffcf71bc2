"""Seq-sharded long-context serving in the port against the JAX package, on
the CPU: the striped allocator, the partial modes of the packed-context and
decode kernels (their plain versions), the log-sum-exp merge, and the
engine with ``seq_shards`` on one device.

- The striped ``BlockedAllocator`` hands out the same chains as JAX's
  through a seeded allocate / extend / register / free / evict storm, and
  the striped ``StateManager`` the same block ids through admissions with
  prefix hits, growth, copy-on-write and truncation.
- K3 ``partial=True``'s plain version against JAX ``_packed_ctx_partial``
  (``inference/paged.py:384``) and the decode partial's against JAX
  ``_paged_attention_decode_partial`` (``:558``), on each shard's slice of
  the pool with its translated table; fp32, atol 1e-5 (the same products
  summed in another order).  The JAX Pallas K3 does not run on this JAX
  (``pl.load``), so the jnp body is the oracle.  JAX's jnp body lets pad
  rows attend each other; the port keeps the Pallas kernel's rule (pad rows
  exactly ``(0, -1e30, 0)``), so only live rows are compared.
- The ``S`` partials folded by the port's merge equal the non-partial plain
  version on the unsplit pool (atol 1e-5), with slots that own no key on
  some shard.
- ``InferenceEngineV2(grid=initialize_mesh(devices=["cpu"] * S, seq=S),
  seq_shards=S)`` on ``tiny`` in fp32 is token-identical to the JAX
  single-pool engine on the shared-prefix workload (prefix caching, chunked
  prefill), with int8 weights, with speculation and at S = 4.
- The admission contract, the refusals, and the wrappers' group-size and
  head-dim checks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import paged as jpaged
from deepspeed_tpu.inference import ragged as jr
from deepspeed_tpu.inference.engine_v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.sampling import SamplingParams as JSampling
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.models.transformer import init_params as j_init
from deepspeed_tpu.parallel.topology import initialize_mesh as j_initialize_mesh
from deepspeed_tpu_torch.inference import paged as tpaged
from deepspeed_tpu_torch.inference import ragged as tr
from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.sampling import SamplingParams
from deepspeed_tpu_torch.inference.scheduler import REJECT_POOL_IMPOSSIBLE
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.models.transformer import params_from_numpy
from deepspeed_tpu_torch.ops.kernels import ctx_attention as K3
from deepspeed_tpu_torch.ops.kernels import flash_attention as K1
from deepspeed_tpu_torch.ops.kernels import paged_attention as K2
from deepspeed_tpu_torch.ops.kernels import sparse_attention as K7
from deepspeed_tpu_torch.parallel.topology import Grid, MeshSpec, initialize_mesh
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

ATOL = 1e-5


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# the striped allocator and state manager, against JAX's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stripes", [2, 4])
def test_allocator_striping_storm_matches_jax(stripes):
    """``tests/test_seq_shard.py``'s storm run on both allocators side by
    side: identical chains and ``stripe_of`` at every step, chain position
    ``i`` on stripe ``i % S``, ``can_allocate`` an exact oracle, both audits
    green, and a full drain leaks nothing."""
    rng = np.random.default_rng(0)
    allocs = [jr.BlockedAllocator(32, stripes=stripes),
              tr.BlockedAllocator(32, stripes=stripes)]
    chains = {}
    next_uid = 0
    for step in range(400):
        op = rng.integers(0, 3)
        if op == 0:  # start or extend a chain
            if chains and rng.integers(0, 2):
                uid = int(rng.choice(list(chains)))
            else:
                uid = next_uid = next_uid + 1
                chains.setdefault(uid, [])
            chain = chains[uid]
            n = int(rng.integers(1, 5))
            oks = [a.can_allocate(n, first_pos=len(chain)) for a in allocs]
            assert oks[0] == oks[1]
            if not oks[0]:
                for a in allocs:
                    with pytest.raises(RuntimeError):
                        a.allocate(n, first_pos=len(chain))
                continue
            runs = [a.allocate(n, first_pos=len(chain)) for a in allocs]
            assert runs[0] == runs[1]
            chain.extend(runs[0])
        elif op == 1 and chains:  # retire a chain, caching a keyed prefix
            uid = int(rng.choice(list(chains)))
            chain = chains.pop(uid)
            for i in range(int(rng.integers(0, len(chain) + 1))):
                for a in allocs:
                    a.register(chain[i], key=("storm", uid, i),
                               parent=chain[i - 1] if i else None)
            for a in allocs:
                a.free(chain)
        elif op == 2 and chains:  # share then release (refcount > 1 path)
            b = chains[int(rng.choice(list(chains)))][0]
            for a in allocs:
                a.ref(b)
                a.free([b])
        for chain in chains.values():
            for i, b in enumerate(chain):
                assert allocs[0].stripe_of(b) == allocs[1].stripe_of(b) == i % stripes
        assert allocs[0]._free == allocs[1]._free
        assert list(allocs[0]._lru) == list(allocs[1]._lru)
        assert allocs[0].evictions == allocs[1].evictions
        if step % 25 == 0:
            for a in allocs:
                a.audit()
    assert allocs[1].evictions > 0  # the per-stripe evict path ran
    for chain in chains.values():
        for a in allocs:
            a.free(chain)
    for a in allocs:
        a.audit()
        assert a.available_blocks == a.total_blocks


def test_allocator_round_robin_contract():
    """A chain grown over several calls round-robins from its CHAIN position,
    and the stripes must divide the pool."""
    alloc = tr.BlockedAllocator(12, stripes=3)
    chain = alloc.allocate(2, first_pos=0)
    chain += alloc.allocate(4, first_pos=2)
    chain += alloc.allocate(1, first_pos=6)
    assert [alloc.stripe_of(b) for b in chain] == [0, 1, 2, 0, 1, 2, 0]
    with pytest.raises(ValueError):
        tr.BlockedAllocator(10, stripes=3)
    # a stripe-impure free list fails the audit
    bad = tr.BlockedAllocator(8, stripes=2)
    bad._free[0].append(bad._free[1].pop())
    with pytest.raises(RuntimeError, match="free list"):
        bad.audit()


@pytest.mark.parametrize("seed", [0, 1])
def test_state_manager_stripes_match_jax(seed):
    """Admissions with prefix hits, growth, copy-on-write, truncation and
    release on a 2-stripe manager: the same block ids as JAX's at every
    step (so every allocation site passes the chain position), and every
    chain keeps position ``i`` on stripe ``i % 2``."""
    bs, nb, slots, S = 4, 24, 4, 2
    rng = np.random.default_rng(seed)
    mgrs = [jr.StateManager(nb, bs, slots, enable_prefix_caching=True, seq_shards=S),
            tr.StateManager(nb, bs, slots, enable_prefix_caching=True, seq_shards=S)]
    cows = [[], []]
    for m, log in zip(mgrs, cows):
        m.cow_hook = lambda src, dst, log=log: log.append((src, dst))
    prefix = rng.integers(1, 50, 3 * bs).tolist()
    uid = 0
    for _ in range(150):
        op = rng.choice(["admit", "admit", "grow", "release", "cow", "cow", "truncate"])
        live = sorted(mgrs[0].seqs)
        if op == "admit" and mgrs[0].free_slots:
            uid += 1
            toks = prefix[:int(rng.choice([0, bs, 3 * bs]))] \
                + rng.integers(1, 50, int(rng.integers(1, 9))).tolist()
            outcomes = []
            for m in mgrs:
                ok = m.can_admit_all([len(toks)], token_lists=[toks])
                if ok:
                    s = m.admit(uid, toks)
                    m.ensure_capacity(s, 0)
                    s.seen_tokens = len(toks)
                    m.update_hashes(s)
                outcomes.append(ok)
            assert outcomes[0] == outcomes[1]
        elif op == "grow" and live:
            u = live[int(rng.integers(len(live)))]
            new = rng.integers(1, 50, int(rng.integers(1, 6))).tolist()
            res = []
            for m in mgrs:
                s = m.seqs[u]
                try:
                    m.ensure_capacity(s, len(new))
                    s.tokens.extend(new)
                    s.seen_tokens = s.cur_len
                    m.update_hashes(s)
                    res.append("ok")
                except RuntimeError:
                    res.append("full")
            assert res[0] == res[1]
        elif op == "release" and live:
            u = live[int(rng.integers(len(live)))]
            for m in mgrs:
                m.release(u)
        elif op == "cow" and live:
            u = live[int(rng.integers(len(live)))]
            pos = int(rng.integers(0, max(mgrs[0].seqs[u].cur_len, 1)))
            res = []
            for m in mgrs:
                try:
                    m.ensure_writable(m.seqs[u], pos)
                    res.append("ok")
                except RuntimeError:
                    res.append("full")
            assert res[0] == res[1]
        elif op == "truncate" and live:
            u = live[int(rng.integers(len(live)))]
            n = int(rng.integers(0, mgrs[0].seqs[u].cur_len + 1))
            assert mgrs[0].truncate_to_length(mgrs[0].seqs[u], n) == \
                mgrs[1].truncate_to_length(mgrs[1].seqs[u], n)
        for a, b in zip(mgrs[0].seqs.values(), mgrs[1].seqs.values()):
            assert (a.uid, a.blocks, a.cached_tokens) == (b.uid, b.blocks, b.cached_tokens)
            assert [mgrs[1].allocator.stripe_of(x) for x in b.blocks] == \
                [i % S for i in range(len(b.blocks))]
        assert cows[0] == cows[1]
    assert cows[1] and mgrs[1].cached_prompt_tokens > 0  # prefix hits and clones ran
    for m in mgrs:
        for u in list(m.seqs):
            m.release(u)
        m.allocator.audit()


# ---------------------------------------------------------------------------
# the partial modes' plain versions, against the JAX bodies
# ---------------------------------------------------------------------------
def _striped_tables(ctx_lens, P, nb, S, bs, seed):
    """Block tables whose page ``i`` lives on stripe ``i % S`` of an
    ``nb``-block pool (what the striped allocator hands out); -1 tails."""
    rng = np.random.default_rng(seed)
    nbl = nb // S
    free = [list(rng.permutation(np.arange(s * nbl, (s + 1) * nbl))) for s in range(S)]
    tables = np.full((len(ctx_lens), P), -1, np.int32)
    for r, c in enumerate(ctx_lens):
        for i in range(-(-c // bs)):
            tables[r, i] = free[i % S].pop()
    return tables


def _ctx_case(hq, hkv, hd, S, bs=8, nb=32, P=8, ctx=(19, 0, 40, 8, 13),
              sfx=(5, 8, 3, 4, 0), seed=0):
    """A pack: segments page-aligned (pad rows between them), one slot
    with no suffix, contexts ending mid-page, striped over ``S`` shards."""
    n = len(ctx)
    seg = []
    for r, m in enumerate(sfx):
        if m:
            seg += [r + 1] * m + [0] * (-m % bs)
    seg = np.asarray(seg + [0] * bs, np.int32)  # trailing pad rows
    t = len(seg)
    return dict(q=_np((t, hq, hd), seed), k=_np((t, hkv, hd), seed + 1),
                v=_np((t, hkv, hd), seed + 2), segment_ids=seg,
                cache_k=_np((nb, bs, hkv, hd), seed + 3),
                cache_v=_np((nb, bs, hkv, hd), seed + 4),
                ctx_tables=_striped_tables(ctx, P, nb, S, bs, seed + 5),
                ctx_lens=np.asarray(ctx, np.int32)), n


def _shard(case, s, S, table_key):
    """Shard ``s``'s view: its pool slice and its translated table."""
    out = dict(case)
    nbl = case["cache_k"].shape[0] // S
    out["cache_k"] = case["cache_k"][s * nbl:(s + 1) * nbl]
    out["cache_v"] = case["cache_v"][s * nbl:(s + 1) * nbl]
    bt = case[table_key]
    out[table_key] = np.where(bt >= 0, bt - s * nbl, -1).astype(np.int32)
    return out


def _torch(case):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in case.items()}


def _jax(case):
    """The case's arrays in their (positional) order, for the JAX bodies."""
    return [jnp.asarray(v) for v in case.values()]


# (hq, hkv, hd): tiny's heads, a narrow hd-128 GQA-4:1 shape, and the shapes
# the tensor-core K2 / K3 take on the card: head_dim 256, a group of 16 and
# one above 16
PARTIAL_SHAPES = [(4, 2, 16), (4, 1, 128), (4, 2, 256), (16, 1, 64), (32, 1, 64)]


@pytest.mark.parametrize("hq,hkv,hd", PARTIAL_SHAPES)
@pytest.mark.parametrize("shard", [0, 1])
@pytest.mark.parametrize("include_pack", [True, False])
@pytest.mark.parametrize("cap", [None, 5.0])
def test_ctx_partial_plain_matches_jax(hq, hkv, hd, shard, include_pack, cap):
    case, _ = _ctx_case(hq, hkv, hd, S=2)
    sh = _shard(case, shard, 2, "ctx_tables")
    acc, m, l = K3.paged_attention_packed_ctx_partial_plain(
        **_torch(sh), include_pack=include_pack, logits_soft_cap=cap)
    ja, jm, jl = jpaged._packed_ctx_partial(*_jax(sh), include_pack=include_pack,
                                            logits_soft_cap=cap)
    live = case["segment_ids"] > 0
    _close(acc.numpy()[live], np.asarray(ja)[live])
    _close(m.numpy()[live], np.asarray(jm)[live])
    _close(l.numpy()[live], np.asarray(jl)[live])
    # pad rows: the kernel's rule, exactly (0, -1e30, 0)
    assert (acc.numpy()[~live] == 0).all() and (l.numpy()[~live] == 0).all()
    assert (m.numpy()[~live] == np.float32(-1e30)).all()
    if not include_pack and shard == 1:
        # slot 3 (ctx 8: one page, on stripe 0) has no key on shard 1
        rows = case["segment_ids"] == 4
        assert (l.numpy()[rows] == 0).all() and (m.numpy()[rows] == np.float32(-1e30)).all()


def _decode_case(hq, hkv, hd, S, bs=8, nb=32, P=6, lens=(1, 9, 24, 41, 3, 17), seed=0):
    b = len(lens)
    tables = _striped_tables(lens, P, nb, S, bs, seed + 3)
    tables[0] = -1  # an inactive slot: len 1, an all -1 row
    return dict(q=_np((b, hq, hd), seed), cache_k=_np((nb, bs, hkv, hd), seed + 1),
                cache_v=_np((nb, bs, hkv, hd), seed + 2), block_table=tables,
                seq_lens=np.asarray(lens, np.int32))


@pytest.mark.parametrize("hq,hkv,hd", PARTIAL_SHAPES)
@pytest.mark.parametrize("shard", [0, 1])
@pytest.mark.parametrize("cap", [None, 5.0])
def test_decode_partial_plain_matches_jax(hq, hkv, hd, shard, cap):
    sh = _shard(_decode_case(hq, hkv, hd, S=2), shard, 2, "block_table")
    got = K2.paged_attention_decode_partial_plain(**_torch(sh), logits_soft_cap=cap)
    want = jpaged._paged_attention_decode_partial(*_jax(sh), logits_soft_cap=cap)
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w))
    assert float(got[2][0].abs().max()) == 0 and bool((got[1][0] == -1e30).all())


def test_lse_merge_packed_matches_jax():
    parts = []
    for seed in range(3):
        acc = _np((5, 4, 16), seed)
        m = _np((5, 4), seed + 10)
        l = np.abs(_np((5, 4), seed + 20)) + 0.5
        m[0], l[0], acc[0] = -1e30, 0.0, 0.0  # a row with no key on this shard
        parts.append(np.concatenate([acc, m[..., None], l[..., None]], -1))
    parts[1][1, :, -2:] = [-1e30, 0.0]  # one-sided empty row
    parts[1][1, :, :-2] = 0.0
    for a, b in ((parts[0], parts[1]), (parts[1], parts[2]), (parts[2], parts[0])):
        got = tpaged._lse_merge_packed(torch.from_numpy(a), torch.from_numpy(b))
        _close(got.numpy(), np.asarray(jpaged._lse_merge_packed(jnp.asarray(a),
                                                                 jnp.asarray(b))))
        assert got[0, :, -2].eq(-1e30).all() and got[0, :, -1].eq(0).all()


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("hq,hkv,hd", [(4, 2, 16), (8, 2, 64)])
def test_merged_partials_equal_the_full_attention(S, hq, hkv, hd):
    """The seq-sharded region (per-shard partials, the ring-order fold) on
    the CPU against the non-partial plain versions on the unsplit pool.  At
    S = 4 the one-page contexts leave shards 1-3 with no key for a slot."""
    ctx, _ = _ctx_case(hq, hkv, hd, S=S)
    c = _torch(ctx)
    got = tpaged.paged_attention_packed_ctx(*c.values(), logits_soft_cap=5.0, seq_shards=S)
    want = tpaged.paged_attention_packed_ctx(*c.values(), logits_soft_cap=5.0)
    _close(got.numpy(), want.numpy())
    assert got[c["segment_ids"] == 0].eq(0).all()

    dec = _torch(_decode_case(hq, hkv, hd, S=S))
    got = tpaged.paged_attention_decode(*dec.values(), seq_shards=S)
    want = tpaged.paged_attention_decode(*dec.values())
    # slot 0 is inactive (all -1): the full kernel clamps -1 to page 0, the
    # partials skip it and give 0
    _close(got.numpy()[1:], want.numpy()[1:])
    assert got[0].eq(0).all()
    # shard tables computed once per dispatch give the same result
    tabs = tpaged.seq_shard_tables(dec["block_table"], dec["cache_k"].shape[0], S)
    again = tpaged.paged_attention_decode(*dec.values(), seq_shards=S, shard_tables=tabs)
    assert torch.equal(again, got)


def test_include_pack_on_every_shard_is_caught():
    """Charging the pack's own keys on every shard (not shard 0 only)
    counts them S times: the merge-equals-full identity catches it."""
    case, _ = _ctx_case(4, 2, 16, S=2)
    c = _torch(case)
    nbl = c["cache_k"].shape[0] // 2
    tabs = tpaged.seq_shard_tables(c["ctx_tables"], c["cache_k"].shape[0], 2)
    parts = [K3.paged_attention_packed_ctx_partial_plain(
        c["q"], c["k"], c["v"], c["segment_ids"], c["cache_k"][s * nbl:(s + 1) * nbl],
        c["cache_v"][s * nbl:(s + 1) * nbl], tabs[s], c["ctx_lens"], include_pack=True)
        for s in range(2)]
    wrong = tpaged.merge_partials(parts, torch.float32)
    want = tpaged.paged_attention_packed_ctx(*c.values())
    assert float((wrong - want).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# the engine, against the JAX single-pool engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny():
    jcfg = j_preset("tiny", max_seq_len=128, dtype=jnp.float32)
    tcfg = get_preset("tiny", max_seq_len=128, dtype=torch.float32)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


# the shared-prefix workload of tests/test_seq_shard.py:202-226, with
# chunked prefill (11-token prompts in chunks of one page)
ENGINE_KW = dict(max_seqs=4, num_blocks=64, block_size=8, prefill_buckets=(16, 32),
                 enable_prefix_caching=True, prefill_chunk=8)
SHARED = [7, 3, 9, 1, 4, 6, 2, 8]
VARIANTS = {
    "plain": ({}, {u: SHARED + [10 + u, 20 + u, 30 + u] for u in (1, 2, 3)}),
    "int8": (dict(quantize_weights="int8"),
             {u: SHARED + [10 + u, 20 + u, 30 + u] for u in (1, 2, 3)}),
    # a periodic prompt drafts from its own history
    "spec": (dict(enable_speculation=True),
             {**{u: SHARED + [10 + u, 20 + u, 30 + u] for u in (1, 2, 3)},
              4: [5, 6, 7, 8] * 4 + [9, 3]}),
}
SHARED_STATS = ("prefill_tokens_dispatched", "prefill_dispatches", "decode_ticks",
                "decode_emitted", "spec_ticks", "spec_drafted", "spec_accepted")


def _serve(eng, prompts, sampling):
    sched = eng.scheduler
    for u, p in prompts.items():
        assert sched.try_submit(u, p, sampling).accepted
    sched.run(wait_for=list(prompts))
    out = {u: sched.pop_result(u) for u in prompts}
    stats = {k: eng.stats[k] for k in SHARED_STATS}
    chunks = sched.stats["prefill_chunks"]
    hits = eng.mgr.cached_prompt_tokens
    audit = eng.close()
    assert audit["blocks_in_use"] == 0, audit
    return out, stats, chunks, hits


@pytest.fixture(scope="module")
def jax_single_pool(tiny):
    """The JAX single-pool engine's results per variant, run once each."""
    jcfg, jp, _, _ = tiny
    cache = {}

    def get(variant):
        if variant not in cache:
            extra, prompts = VARIANTS[variant]
            cache[variant] = _serve(JEngine(jp, jcfg, **ENGINE_KW, **extra), prompts,
                                    JSampling(temperature=0.0, max_new_tokens=8))
        return cache[variant]

    return get


@pytest.mark.parametrize("variant,S", [("plain", 2), ("int8", 2), ("spec", 2), ("plain", 4)])
def test_engine_token_identity_with_jax_single_pool(tiny, jax_single_pool, variant, S):
    _, _, tcfg, tp = tiny
    extra, prompts = VARIANTS[variant]
    eng = InferenceEngineV2(tp, tcfg, device="cpu",
                            grid=initialize_mesh(devices=["cpu"] * S, seq=S), seq_shards=S,
                            **ENGINE_KW, **extra)
    assert eng.mgr.allocator.stripes == S
    got, stats, chunks, hits = _serve(eng, prompts, SamplingParams(temperature=0.0,
                                                                    max_new_tokens=8))
    want, jstats, jchunks, jhits = jax_single_pool(variant)
    assert got == want
    assert stats == jstats and chunks == jchunks and hits == jhits
    assert chunks > len(prompts) and hits > 0  # chunked prefill and prefix hits ran
    if variant == "spec":
        assert stats["spec_ticks"] > 0 and stats["spec_accepted"] > 0


# ---------------------------------------------------------------------------
# admission: the over-one-pool contract
# ---------------------------------------------------------------------------
LONG_PROMPT = [(i * 7 + 3) % 50 + 1 for i in range(80)]  # 10 blocks of 8
ADMIT_KW = dict(max_seqs=2, block_size=8, prefill_buckets=(32, 64, 128), max_seq_len=120)


def test_over_one_pool_prompt_rejected_by_one_slice(tiny):
    _, _, tcfg, tp = tiny
    eng = InferenceEngineV2(tp, tcfg, device="cpu", num_blocks=8, **ADMIT_KW)
    res = eng.scheduler.try_submit(1, LONG_PROMPT, SamplingParams(max_new_tokens=8))
    assert not res.accepted and res.reason == REJECT_POOL_IMPOSSIBLE
    assert res.budget_blocks == 8 and res.budget_scope == "replica_pool"
    assert eng.close()["blocks_in_use"] == 0


def test_over_one_pool_prompt_served_at_s2(tiny):
    """The same slice size with a seq axis to borrow from: 16 blocks over
    two shards serve the 80-token prompt to the end, leak-free."""
    _, _, tcfg, tp = tiny
    eng = InferenceEngineV2(tp, tcfg, device="cpu", num_blocks=16,
                            grid=initialize_mesh(devices=["cpu"] * 2, seq=2), seq_shards=2,
                            **ADMIT_KW)
    sched = eng.scheduler
    res = sched.try_submit(1, LONG_PROMPT, SamplingParams(max_new_tokens=8))
    assert res.accepted, res
    sched.run(wait_for=[1])
    assert sched.requests[1].state == "finished", sched.requests[1].error
    assert len(sched.pop_result(1)) == 8
    eng.mgr.allocator.audit()
    assert eng.close()["blocks_in_use"] == 0


def test_seq_sharded_verdict_matches_jax(tiny):
    """At S = 2 the budget is the aggregate pool, and the verdict says so in
    JAX's words."""
    jcfg, jp, tcfg, tp = tiny
    je = JEngine(jp, jcfg, num_blocks=8, grid=j_initialize_mesh(devices=jax.devices()[:2],
                                                                 seq=2),
                 seq_shards=2, **ADMIT_KW)
    te = InferenceEngineV2(tp, tcfg, device="cpu", num_blocks=8,
                           grid=initialize_mesh(devices=["cpu"] * 2, seq=2), seq_shards=2,
                           **ADMIT_KW)
    want = je.scheduler.try_submit(1, LONG_PROMPT, JSampling(max_new_tokens=8))
    got = te.scheduler.try_submit(1, LONG_PROMPT, SamplingParams(max_new_tokens=8))
    assert got.reason == want.reason == REJECT_POOL_IMPOSSIBLE
    assert (got.budget_blocks, got.budget_scope) == (want.budget_blocks, want.budget_scope)
    assert got.budget_scope == "replica_pool(aggregate over 2 seq shards)"
    je.close()
    te.close()


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------
def test_grid_refusals_name_item_7(tiny):
    _, _, tcfg, tp = tiny
    for kw in (dict(devices=["cpu"] * 2, model=2), dict(devices=["cpu"] * 2, batch=2),
               dict(devices=["cpu", "meta"], seq=2)):
        with pytest.raises(NotImplementedError, match="item 7"):
            initialize_mesh(**kw)
    grid = initialize_mesh(devices=["cpu"] * 2, seq=2)
    assert (grid.spec.seq, grid.spec.data, grid.spec.model) == (2, 1, 1)
    tp_grid = Grid(spec=MeshSpec(model=2), devices=[torch.device("cpu")] * 2)
    with pytest.raises(NotImplementedError, match="item 7"):
        InferenceEngineV2(tp, tcfg, device="cpu", num_blocks=8, grid=tp_grid)
    q, ck, cv, bt, lens = _torch(_decode_case(4, 2, 16, S=2)).values()
    with pytest.raises(NotImplementedError, match="item 7"):
        tpaged.paged_attention_decode(q, ck, cv, bt, lens, mesh=tp_grid, seq_shards=2)
    # the engine's own checks, as JAX's
    with pytest.raises(ValueError, match="seq axis"):
        InferenceEngineV2(tp, tcfg, device="cpu", num_blocks=8, seq_shards=4, grid=grid)
    with pytest.raises(ValueError, match="divide"):
        InferenceEngineV2(tp, tcfg, device="cpu", num_blocks=9, seq_shards=2, grid=grid)


# ---------------------------------------------------------------------------
# the wrappers' shape checks, reached on the CPU (before any device check)
# ---------------------------------------------------------------------------
def _z(*shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype)


def _i(*shape):
    return torch.zeros(shape, dtype=torch.int32)


def _flash(hq, hkv, hd):
    return K1.flash_attention_kernel(_z(1, 8, hq, hd), _z(1, 8, hkv, hd), _z(1, 8, hkv, hd))


def _flash_bwd(hq, hkv, hd):
    q, kv = _z(1, 8, hq, hd), _z(1, 8, hkv, hd)
    return K1.flash_attention_bwd_kernel(q, kv, kv, None, q, _z(1, hq, 8, dtype=torch.float32),
                                         q)


def _decode(fn):
    return lambda hq, hkv, hd: fn(_z(2, hq, hd), _z(4, 8, hkv, hd), _z(4, 8, hkv, hd),
                                  _i(2, 2), _i(2))


def _ctx(fn):
    return lambda hq, hkv, hd: fn(_z(8, hq, hd), _z(8, hkv, hd), _z(8, hkv, hd), _i(8),
                                  _z(4, 8, hkv, hd), _z(4, 8, hkv, hd), _i(2, 2), _i(2))


def _sparse(hq, hkv, hd):
    q, kv = _z(1, 128, hq, hd), _z(1, 128, hkv, hd)
    return K7.sparse_attention_kernel(q, kv, kv, None, None, None, 1.0, None)


def _sparse_bwd(hq, hkv, hd):
    q, kv = _z(1, 128, hq, hd), _z(1, 128, hkv, hd)
    return K7.sparse_attention_bwd_kernel(q, kv, kv, None, None, q, None, q, None, 1.0, None)


# every attention wrapper takes any query group and head_dim 64 / 128 / 256:
# K1's and K7's tensor-core kernels run a CTA per query head, K2's and K3's
# tile the (row, query head) pairs of a kv head
WRAPPERS = {
    "flash_fwd": _flash,
    "flash_bwd": _flash_bwd,
    "paged_decode": _decode(K2.paged_attention_decode_kernel),
    "paged_decode_partial": _decode(K2.paged_attention_decode_partial_kernel),
    "ctx_attention": _ctx(K3.paged_attention_packed_ctx_kernel),
    "ctx_attention_partial": _ctx(K3.paged_attention_packed_ctx_partial_kernel),
    "sparse_fwd": _sparse,
    "sparse_bwd": _sparse_bwd,
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrappers_refuse_unported_heads_with_queue_2(name):
    """head_dim 96 and 80 raise ``NotImplementedError`` naming ROADMAP queue 2
    before any launch (a CPU tensor reaches the check); falcon_7b's group of
    71 and head_dim 256 pass it and stop at the device check."""
    call = WRAPPERS[name]
    for hd in (96, 80):
        with pytest.raises(NotImplementedError, match=f"head_dim {hd}.*queue 2"):
            call(4, 2, hd)
    for hq, hkv, hd in ((71, 1, 64), (4, 2, 256)):
        with pytest.raises((ValueError, TypeError, AttributeError)):
            call(hq, hkv, hd)


def test_quantize_weights_message_lists_fp6(tiny):
    _, _, tcfg, tp = tiny
    with pytest.raises(ValueError, match=r"\(int8\|fp8\|fp6\)"):
        InferenceEngineV2(tp, tcfg, device="cpu", num_blocks=8, quantize_weights="int4")
