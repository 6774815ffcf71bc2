"""The port's speculative serving against the JAX package on the CPU:
prompt-lookup drafting, the verify acceptance rule, the spec engine and
scheduler (greedy token identity with the port's plain decode and with the
JAX spec engine on ``tiny`` and ``tiny_gpt2`` in fp32), allocator rollback,
and the verify pass (``write_spec_kv``, ``verify_packed_ctx``) with
mid-page starts.  Test by test this mirrors ``tests/test_speculative.py``.

Tolerances: the acceptance rule's probabilities and log-probs in fp32,
atol 1e-6 (the same softmax in two frameworks); the verify logits atol 1e-4
and rtol 1e-4 (fp32 matmuls over the tiny model in another summation
order); sampled distributions within 0.035 of the target over 4000 draws
(the JAX test's bound, about 4 standard errors of a probability near 0.5),
since ``torch.Generator`` and ``jax.random`` draw different numbers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import model_runner as jrunner
from deepspeed_tpu.inference import paged as jpaged
from deepspeed_tpu.inference import sampling as jsampling
from deepspeed_tpu.inference import speculative as jspec
from deepspeed_tpu.inference.engine_v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.sampling import SamplingParams as JSampling
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.models.transformer import init_params as j_init
from deepspeed_tpu_torch.inference import model_runner, paged
from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.ragged import StateManager
from deepspeed_tpu_torch.inference.sampling import (
    SamplingParams,
    filtered_log_probs,
    spec_verify_sample,
)
from deepspeed_tpu_torch.inference.speculative import propose
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.models.transformer import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

# the JAX oracles under jit, as its engine calls them (one compile each,
# not one per eager op)
J_INIT = jax.jit(j_init, static_argnums=(1, 2))
J_FILTERED = jax.jit(jsampling.filtered_log_probs, static_argnums=(3,))
J_SPEC_VERIFY = jax.jit(jsampling.spec_verify_sample, static_argnums=(5,))
J_VERIFY = jax.jit(jrunner.verify_packed_ctx, static_argnums=(1,))

SPEC_STATS = ("prefill_tokens_dispatched", "prefill_dispatches", "decode_ticks",
              "decode_emitted", "spec_ticks", "spec_seq_forwards", "spec_drafted",
              "spec_accepted", "spec_emitted", "spec_drafts_shed")


def _models(name):
    # fp32 so greedy parity cannot flip on near-ties
    jcfg = j_preset(name, max_seq_len=128, dtype=jnp.float32)
    tcfg = get_preset(name, max_seq_len=128, dtype=torch.float32)
    jp = J_INIT(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def tiny():
    return _models("tiny")


@pytest.fixture(scope="module")
def tiny_gpt2():
    return _models("tiny_gpt2")


def _engine(models, **kw):
    _, _, tcfg, tp = models
    kw.setdefault("max_seqs", 4)
    kw.setdefault("num_blocks", 64)
    kw.setdefault("block_size", 8)
    kw.setdefault("prefill_buckets", (16, 32, 64))
    return InferenceEngineV2(tp, tcfg, device="cpu", **kw)


def _spec_engine(models, **kw):
    kw.setdefault("enable_speculation", True)
    kw.setdefault("spec_max_draft", 4)
    return _engine(models, **kw)


# ---------------------------------------------------------------------------
# prompt-lookup drafter (pure function)
# ---------------------------------------------------------------------------
def test_prompt_lookup_proposes_continuation():
    # suffix (2, 3) recurs at index 1; the continuation was 9, 9, 1
    assert propose([1, 2, 3, 9, 9, 1, 2, 3], 2, 3) == [9, 9, 1]


def test_prompt_lookup_cycles_periodic_tail():
    assert propose([4, 7, 7, 7], 2, 5) == [7, 7, 7, 7, 7]
    assert propose([9, 5, 6, 5, 6, 5, 6], 2, 4) == [5, 6, 5, 6]


def test_prompt_lookup_no_match_and_window():
    assert propose([1, 2, 3, 4, 5], 2, 4) == []
    assert propose([1, 2], 2, 4) == []
    long = [1, 2] + [9] * 50 + [1, 2]
    assert propose(long, 2, 3, lookup_window=10) == []
    assert propose(long, 2, 3, lookup_window=200) == [9, 9, 9]


@pytest.mark.parametrize("seed", range(4))
def test_propose_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        toks = rng.integers(0, 4, rng.integers(1, 40)).tolist()
        mm, md, win = int(rng.integers(1, 4)), int(rng.integers(0, 6)), int(rng.integers(4, 64))
        assert propose(toks, mm, md, win) == jspec.propose(toks, mm, md, win)


# ---------------------------------------------------------------------------
# acceptance rule (device math)
# ---------------------------------------------------------------------------
def _logits_for(rows):
    """[K1] token ids -> logits [1, K1, 8] peaked at each id."""
    out = np.full((1, len(rows), 8), -5.0, np.float32)
    for i, t in enumerate(rows):
        out[0, i, t] = 5.0
    return torch.from_numpy(out)


def _greedy_verify(rows, draft, n):
    gen = torch.Generator().manual_seed(0)
    return spec_verify_sample(_logits_for(rows), torch.tensor([draft]), torch.tensor([n]),
                              0.0, 1.0, 0, gen)


def test_spec_verify_greedy_accept_reject_bonus():
    out, n = _greedy_verify([1, 2, 3, 4], [1, 2, 3], 3)  # all accepted + bonus
    assert int(n[0]) == 4 and out[0].tolist() == [1, 2, 3, 4]
    out, n = _greedy_verify([2, 2, 3, 4], [2, 7, 3], 3)  # rejected at position 1
    assert int(n[0]) == 2 and out[0, :2].tolist() == [2, 2]
    out, n = _greedy_verify([5, 0, 0, 0], [0, 0, 0], 0)  # no drafts: plain decode
    assert int(n[0]) == 1 and int(out[0, 0]) == 5


def test_spec_verify_preserves_sampling_distribution():
    """The first emitted token of a verify step is distributed as plain
    sampling from the target, whatever the draft proposes."""
    v, trials = 4, 4000
    logits = torch.tensor([[0.9, 0.1, 1.4, -0.3]])
    target = torch.softmax(logits[0] / 0.7, -1).numpy()
    l3 = logits[:, None, :].repeat(trials, 2, 1)
    for drafted in (0, 2):  # an unlikely draft and a likely one
        gen = torch.Generator().manual_seed(drafted)
        out, n = spec_verify_sample(
            l3, torch.full((trials, 1), drafted), torch.ones(trials, dtype=torch.int32),
            0.7, 1.0, 0, gen)
        emp = np.bincount(out[:, 0].numpy(), minlength=v) / trials
        assert np.abs(emp - target).max() < 0.035, (drafted, emp, target)


def test_spec_verify_top_p_masks_tail():
    # top_p 0.5 keeps only the top token: an out-of-nucleus draft is never
    # accepted and never resampled
    l3 = torch.tensor([[3.0, 0.0, -1.0, -1.0]])[:, None, :].repeat(1, 2, 1)
    gen = torch.Generator().manual_seed(0)
    for _ in range(64):
        out, n = spec_verify_sample(l3, torch.tensor([[3]]), torch.tensor([1]), 1.0, 0.5, 0, gen)
        assert int(n[0]) == 1 and int(out[0, 0]) == 0


@pytest.mark.parametrize("temp,top_p", [(0.7, 0.9), (1.3, 0.5), (1.0, 1.0), (0.0, 1.0)])
@pytest.mark.parametrize("top_k", [0, 3])
def test_filtered_log_probs_matches_jax(top_k, temp, top_p):
    """One (temperature, top_p) for the whole tick, as the engine passes
    it; JAX's per-row filter gets it broadcast to every row."""
    logits = np.random.default_rng(5).normal(size=(4, 3, 11)).astype(np.float32) * 2
    want = np.exp(np.asarray(J_FILTERED(
        jnp.asarray(logits), jnp.full(4, temp, jnp.float32), jnp.full(4, top_p, jnp.float32),
        top_k)))
    got = filtered_log_probs(torch.from_numpy(logits), temp, top_p, top_k).exp().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(got == 0, want == 0)  # the same tokens masked
    if temp == 0.0:  # greedy is JAX's one-hot argmax exactly
        np.testing.assert_array_equal(
            np.exp(filtered_log_probs(torch.from_numpy(logits), temp, top_p, top_k).numpy()),
            np.exp(np.asarray(jsampling._greedy_onehot(jnp.asarray(logits)))))


def test_spec_verify_greedy_matches_jax():
    """Greedy acceptance draws nothing that matters: the port's (out,
    n_out) equal JAX's on random logits, drafts that agree with the argmax
    for a random prefix, and rows with 0 drafts."""
    rng = np.random.default_rng(9)
    b, k, v = 6, 4, 13
    logits = rng.normal(size=(b, k + 1, v)).astype(np.float32)
    draft = logits[:, :k].argmax(-1).astype(np.int32)
    for i in range(b):
        cut = int(rng.integers(0, k + 1))
        draft[i, cut:] = (draft[i, cut:] + 1 + rng.integers(0, v - 1, k - cut)) % v
    n_draft = np.array([4, 3, 0, 2, 4, 1], np.int32)
    greedy, ones = np.zeros(b, np.float32), np.ones(b, np.float32)
    jo, jn = J_SPEC_VERIFY(
        jnp.asarray(logits), jnp.asarray(draft), jnp.asarray(n_draft), jnp.asarray(greedy),
        jnp.asarray(ones), 0, jax.random.PRNGKey(0))
    to, tn = spec_verify_sample(
        torch.from_numpy(logits), torch.from_numpy(draft), torch.from_numpy(n_draft),
        0.0, 1.0, 0, torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


# ---------------------------------------------------------------------------
# end-to-end greedy token identity
# ---------------------------------------------------------------------------
def test_greedy_spec_token_identity_and_accept_rate(tiny):
    samp = SamplingParams(max_new_tokens=24)
    prompt = [5, 6, 7, 8] * 4 + [9, 3]
    base = _engine(tiny).generate(prompt, samp)
    eng = _spec_engine(tiny)
    assert eng.generate(prompt, samp) == base
    st = eng.stats
    assert st["spec_ticks"] > 0 and st["spec_accepted"] > 0
    assert st["spec_drafted"] > st["spec_accepted"]  # mid-stream rejections
    seq_forwards = st["spec_seq_forwards"] + st["decode_emitted"]
    emitted = st["spec_emitted"] + st["decode_emitted"]
    assert emitted / seq_forwards > 1.0
    assert eng.close()["blocks_in_use"] == 0


def test_greedy_spec_identity_incompressible_prompt(tiny):
    samp = SamplingParams(max_new_tokens=16)
    prompt = [int(t) for t in np.random.default_rng(3).integers(1, 250, 20)]
    assert _spec_engine(tiny).generate(prompt, samp) == _engine(tiny).generate(prompt, samp)


def test_spec_tick_sheds_drafts_at_pool_exhaustion(tiny):
    """step() with speculation does not raise where plain decode fits: a
    sequence whose k + 1 reservation fails sheds its drafts."""
    samp = SamplingParams()
    prompt = [5, 6, 7, 8] * 4 + [9, 3]
    eng = _spec_engine(tiny, max_seqs=1, num_blocks=3)
    eng.put([1], [prompt])
    s = eng.mgr.seqs[1]
    while s.cur_len < 23:  # 3 blocks x 8 tokens: the pool is full at 24
        eng.step(samp)
    out = eng._spec_tick([s], samp, {1: [7, 8, 5, 6]})  # a forced 4-token draft
    assert len(out[1]) == 1 and len(s.blocks) == 3
    assert eng.stats["spec_drafts_shed"] == 1
    plain = _engine(tiny, max_seqs=1, num_blocks=3)
    plain.put([1], [prompt])
    s2 = plain.mgr.seqs[1]
    while s2.cur_len < 24:
        plain.step(samp)
    assert s.tokens == s2.tokens


def test_greedy_spec_identity_on_prefix_cache_hit(tiny):
    samp = SamplingParams(max_new_tokens=12)
    prefix = [int(t) for t in np.arange(3, 35)]  # 4 full blocks
    cold = _engine(tiny).generate(prefix + [9, 2, 4, 4], samp)
    eng = _spec_engine(tiny, enable_prefix_caching=True)
    eng.generate(prefix + [7, 7, 7, 7], samp)  # fills the block cache
    before = eng.stats["prefill_tokens_dispatched"]
    assert eng.generate(prefix + [9, 2, 4, 4], samp) == cold
    assert eng.stats["prefill_tokens_dispatched"] - before < len(prefix)  # a hit
    eng.mgr.allocator.audit()


def test_spec_stop_token_mid_run(tiny):
    """A stop token inside an accepted run ends the request exactly where
    plain decode stops, through the scheduler and through step()."""
    prompt = [5, 6, 7, 8] * 4 + [9, 3]
    free_run = _engine(tiny).generate(prompt, SamplingParams(max_new_tokens=24))
    stop = free_run[5]
    samp = SamplingParams(max_new_tokens=24, stop_token=stop)
    base = _engine(tiny).generate(prompt, samp)
    assert _spec_engine(tiny).generate(prompt, samp) == base
    # step(): a stop that first appears well after put()'s token
    k = next(i for i in range(3, 24) if free_run[i] not in free_run[:i])
    samp = SamplingParams(stop_token=free_run[k])
    eng = _spec_engine(tiny)
    eng.put([1], [prompt], samp)
    while not eng.mgr.seqs[1].done:
        eng.step(samp)
    assert eng.mgr.seqs[1].tokens[len(prompt):] == free_run[:k + 1]
    assert eng.stats["spec_accepted"] > 0


def test_spec_throttle_decays_probes_and_recovers(tiny):
    eng = _spec_engine(tiny)
    eng.put([1], [[5, 6] * 8])
    seq = eng.mgr.seqs[1]
    seq.tokens[-1] = seq.tokens[-3]  # keep the suffix periodic: lookup always drafts
    for tick in range(4):
        if seq.spec_draft_len == 0:
            break
        eng._spec_update_throttle(seq, n=4, n_acc=0)
    assert seq.spec_draft_len == 0 and tick <= 3
    assert seq.spec_cooldown == 8
    for _ in range(seq.spec_cooldown - 1):
        assert eng.plan_speculation([seq]) == {}
    probe = eng.plan_speculation([seq])
    assert list(map(len, probe.values())) == [1]
    for _ in range(6):
        n = max(1, seq.spec_draft_len)
        eng._spec_update_throttle(seq, n=n, n_acc=n)
    assert seq.spec_draft_len == eng.spec_max_draft


def test_spec_rejecting_sequence_stops_burning_drafts(tiny):
    eng = _spec_engine(tiny)
    prompt = [11, 12] * 8
    eng.put([1], [prompt])
    samp = SamplingParams(max_new_tokens=40)
    for _ in range(30):
        eng.step(samp)
    seq = eng.mgr.seqs[1]
    st = eng.stats
    if st["spec_accepted"] == 0 and st["spec_drafted"] > 0:
        assert st["spec_drafted"] < 30 * 2
    assert seq.cur_len >= len(prompt) + 30  # every tick emitted
    eng.mgr.allocator.audit()


def test_plan_speculation_budget_clamp(tiny):
    eng = _spec_engine(tiny, spec_max_draft=4)
    eng.put([1, 2], [[5, 6] * 6, [7, 8] * 6])
    seqs = [eng.mgr.seqs[1], eng.mgr.seqs[2]]
    for s in seqs:
        s.tokens[-1] = s.tokens[-3]
    assert sum(map(len, eng.plan_speculation(seqs).values())) > 3
    bounded = eng.plan_speculation(seqs, max_total_draft_tokens=3)
    assert 0 < sum(map(len, bounded.values())) <= 3
    capped = eng.plan_speculation(seqs, max_emit={1: 2, 2: 1})
    assert list(map(len, capped.values())) == [1]  # max_emit - 1 drafts; none at 1


def test_spec_sampled_tick_reads_the_tick_sampling(tiny):
    """A sampled (temperature > 0) run through the verify path: with a
    one-token nucleus (top_p 1e-6) every draw is the argmax, so the stream
    equals greedy decode, and drafts were accepted under the sampled rule."""
    prompt = [5, 6, 7, 8] * 4 + [9, 3]
    greedy = _engine(tiny).generate(prompt, SamplingParams(max_new_tokens=20))
    eng = _spec_engine(tiny)
    samp = SamplingParams(temperature=0.8, top_p=1e-6, max_new_tokens=20)
    assert eng.generate(prompt, samp) == greedy
    assert eng.stats["spec_ticks"] > 0 and eng.stats["spec_accepted"] > 0


# ---------------------------------------------------------------------------
# allocator invariants under speculative rollback
# ---------------------------------------------------------------------------
def test_allocator_rollback_matches_never_speculated_run():
    """Random draft / accept / reject ticks against a twin manager that
    never speculates: after every op both hold the same free-list and cache
    sizes, refcount multisets and prefix-hash token chains."""
    rng = np.random.default_rng(7)
    bs = 4

    def mk():
        m = StateManager(num_blocks=32, block_size=bs, max_seqs=4, enable_prefix_caching=True)
        m.cow_hook = lambda s, d: None
        return m

    spec_m, plain_m = mk(), mk()
    live, uid = [], 0

    def room_for(need):
        # keep LRU evictions in step across the twins (see the JAX test)
        if spec_m.allocator.available_blocks < need:
            return False
        for m in (spec_m, plain_m):
            a = m.allocator
            if a.free_blocks < need:
                a.free(a.allocate(need))
        return True

    def compare():
        for m in (spec_m, plain_m):
            m.allocator.audit()
        a, b = spec_m.allocator, plain_m.allocator
        assert (a.free_blocks, a.cached_blocks) == (b.free_blocks, b.cached_blocks)
        assert sorted(a._refs) == sorted(b._refs)
        for u in live:
            s, p = spec_m.seqs[u], plain_m.seqs[u]
            assert s.tokens == p.tokens and len(s.blocks) == len(p.blocks)
            assert [k[1] for k in s.hashes] == [k[1] for k in p.hashes]

    for _ in range(300):
        op = rng.choice(["admit", "spec_tick", "release"])
        if op == "admit" and spec_m.free_slots and len(live) < 3:
            uid += 1
            prompt = [int(t) for t in rng.integers(0, 3, rng.integers(2, 12))]
            if not spec_m.can_admit(len(prompt)) or not room_for(-(-len(prompt) // bs) + 1):
                continue
            for m in (spec_m, plain_m):
                seq = m.admit(uid, prompt)
                m.ensure_capacity(seq, 0)
                seq.seen_tokens = len(seq.tokens)
                m.update_hashes(seq)
            live.append(uid)
        elif op == "spec_tick" and live:
            u = int(rng.choice(live))
            n = int(rng.integers(0, 5))
            n_acc = int(rng.integers(0, n + 1))
            emitted = [int(t) for t in rng.integers(0, 3, n_acc + 1)]
            s, p = spec_m.seqs[u], plain_m.seqs[u]
            if not room_for(n + 4):
                continue
            try:
                spec_m.ensure_capacity(s, n + 1)
                plain_m.ensure_capacity(p, n_acc + 1)
            except RuntimeError:
                spec_m.truncate_to_length(s)
                plain_m.truncate_to_length(p)
                continue
            for pg in range((s.cur_len - 1) // bs, (s.cur_len - 1 + n) // bs + 1):
                spec_m.ensure_writable(s, pg * bs)
                if pg * bs < p.cur_len + n_acc:
                    plain_m.ensure_writable(p, pg * bs)
            for m, seq in ((spec_m, s), (plain_m, p)):
                seq.tokens.extend(emitted)
                seq.seen_tokens = seq.cur_len - 1
                m.truncate_to_length(seq)
                m.update_hashes(seq)
        elif op == "release" and live:
            u = int(rng.choice(live))
            live.remove(u)
            spec_m.release(u)
            plain_m.release(u)
        compare()
    for u in live:
        spec_m.release(u)
        plain_m.release(u)
    a = spec_m.allocator
    assert a.free_blocks + a.cached_blocks == a.total_blocks


def test_truncate_to_length_respects_shared_refcounts():
    mgr = StateManager(num_blocks=16, block_size=4, max_seqs=2, enable_prefix_caching=True)
    mgr.cow_hook = lambda s, d: None
    a = mgr.admit(1, [1, 2, 3, 4, 5, 6, 7, 8, 9])
    mgr.ensure_capacity(a, 0)
    a.seen_tokens = 9
    mgr.update_hashes(a)
    b = mgr.admit(2, [1, 2, 3, 4, 5, 6, 7, 8, 2])  # shares 2 full blocks
    mgr.ensure_capacity(b, 0)
    shared = b.blocks[1]
    assert mgr.allocator.refcount(shared) == 2
    assert mgr.truncate_to_length(b, 4) == 2
    assert mgr.allocator.refcount(shared) == 1  # a still owns it
    assert len(b.blocks) == 1 and len(b.hashes) == 1
    assert mgr.allocator.key_of(shared) is not None  # its cache entry stays
    mgr.allocator.audit()


def test_k_plus_1_reservation_matches_jax_manager():
    """A verify tick's reservation of k + 1 rows (``ensure_capacity``, then
    the copy-on-write guard over every page the pack writes) hands out the
    same blocks and refcounts in the port's manager as in JAX's, across a
    page boundary and a page shared through the prefix cache."""
    from deepspeed_tpu.inference.ragged import StateManager as JStateManager

    mgrs = [StateManager(num_blocks=16, block_size=4, max_seqs=2, enable_prefix_caching=True),
            JStateManager(num_blocks=16, block_size=4, max_seqs=2, enable_prefix_caching=True)]
    copies = [[], []]
    for m, c in zip(mgrs, copies):
        m.cow_hook = lambda src, dst, c=c: c.append((src, dst))
        a = m.admit(1, [1, 2, 3, 4, 5, 6, 7, 8, 9])
        m.ensure_capacity(a, 0)
        a.seen_tokens = 9
        m.update_hashes(a)
        b = m.admit(2, [1, 2, 3, 4, 5, 6, 7, 8, 3])  # shares blocks 0 and 1
        m.ensure_capacity(b, 0)
        for s, k in ((a, 4), (b, 3)):
            L = s.cur_len
            m.ensure_capacity(s, k + 1)
            for pg in range((L - 1) // 4, (L - 1 + k) // 4 + 1):
                m.ensure_writable(s, pg * 4)
        b.tokens = b.tokens[:6]  # roll b back into its shared block: COW on write
        m.truncate_to_length(b)
        m.ensure_capacity(b, 3)
        m.ensure_writable(b, 5)
    t, j = mgrs
    for u in (1, 2):
        assert t.seqs[u].blocks == j.seqs[u].blocks
    assert [t.allocator.refcount(x) for x in range(16)] == \
        [j.allocator.refcount(x) for x in range(16)]
    assert copies[0] == copies[1] and copies[0]  # the same clone happened
    assert t.allocator.free_blocks == j.allocator.free_blocks


def test_nonfinite_verify_row_fails_only_that_request(tiny, monkeypatch):
    """A verify row whose logits are non-finite commits nothing: that
    request fails with the verify error, its draft pages come back, and the
    other requests finish token-identical to a clean run."""
    from deepspeed_tpu_torch.inference import engine_v2

    prompts = {u: [5, 6, 7, 8] * 4 + [9, u] for u in (1, 2, 3)}
    samp = SamplingParams(max_new_tokens=16)
    clean = _spec_engine(tiny)
    for u, p in prompts.items():
        clean.scheduler.submit(u, p, samp)
    want = clean.scheduler.run()
    eng = _spec_engine(tiny)
    real = engine_v2.model_runner.verify_packed_ctx
    poisoned_slot = []

    def poison(params, cfg, tokens, seg, *a, **k):
        logits, kv = real(params, cfg, tokens, seg, *a, **k)
        if not poisoned_slot:  # the first verify tick: poison uid 2's rows
            slot = eng.mgr.seqs[2].slot
            poisoned_slot.append(slot)
            logits[torch.from_numpy(seg == slot + 1)] = float("nan")
        return logits, kv

    monkeypatch.setattr(engine_v2.model_runner, "verify_packed_ctx", poison)
    for u, p in prompts.items():
        eng.scheduler.submit(u, p, samp)
    got = eng.scheduler.run()
    assert poisoned_slot
    req = eng.scheduler.requests[2]
    assert req.state == "failed" and "verify" in req.error
    assert got[1] == want[1] and got[3] == want[3]
    assert eng.close()["blocks_in_use"] == 0


def test_scheduler_preempts_sequence_with_inflight_drafts(tiny):
    """Overload with speculation on: preemption fires while drafts are in
    flight, every request finishes token-identical to an unconstrained
    engine, and no block leaks."""
    eng = _spec_engine(tiny, max_seqs=3, num_blocks=8, prefill_buckets=(16, 32),
                       enable_prefix_caching=True)
    sched = eng.scheduler
    rng = np.random.default_rng(1)
    prompts = {u: [int(t) for t in rng.integers(1, 6, 14)] for u in range(1, 5)}
    samp = SamplingParams(max_new_tokens=24)
    for u, p in prompts.items():
        sched.submit(u, p, samp)
    res = sched.run()
    assert sched.stats["finished"] == 4
    assert sched.stats["preemptions"] >= 1
    assert eng.stats["spec_drafted"] > 0
    eng.mgr.allocator.audit()
    a = eng.mgr.allocator
    assert a.free_blocks + a.cached_blocks == a.total_blocks
    big = _engine(tiny, prefill_buckets=(16, 32))
    for u, p in prompts.items():
        assert res[u] == big.generate(p, samp), u


# ---------------------------------------------------------------------------
# the port against the JAX spec engine
# ---------------------------------------------------------------------------
def _repetitive_prompts(vocab, n_req, base_len, rep_len, seed=0):
    """The bench's repetitive-suffix workload: a random base + an 8-token
    pattern repeated (``bench.py`` ``_spec_serve_section``)."""
    rng = np.random.default_rng(seed)
    pattern = rng.integers(1, vocab, 8).tolist()
    return {u: rng.integers(1, vocab, base_len).tolist() + pattern * (rep_len // 8)
            for u in range(1, n_req + 1)}


TWIN_KW = dict(max_seqs=4, num_blocks=24, block_size=8, max_seq_len=128,
               prefill_buckets=(16, 32, 64), prefill_budget=64, prefill_chunk=32,
               enable_prefix_caching=True, spec_max_draft=4)


@pytest.fixture(scope="module", params=["tiny", "tiny_gpt2"])
def engine_twins(request):
    """The port's spec engine, the port's plain engine and ONE JAX spec
    engine (its compiles shared by both workloads) on ``request.param``,
    driven through the same two workloads: ``put`` of 3 prompts (2 packs)
    then 8 ``step``s, a flush, then the CPU lane of ``bench.py --serving
    --spec`` (4 repetitive-suffix requests through the scheduler with prefix
    caching and chunked prefill on a pool small enough to preempt)."""
    jcfg, jp, tcfg, tp = _models(request.param)
    engines = {"port": InferenceEngineV2(tp, tcfg, device="cpu", enable_speculation=True,
                                         **TWIN_KW),
               "plain": InferenceEngineV2(tp, tcfg, device="cpu", **TWIN_KW),
               "jax": JEngine(jp, jcfg, enable_speculation=True, **TWIN_KW)}
    put_prompts = [[5, 6, 7, 8] * 4 + [9, 3], [11, 12] * 8,
                   _repetitive_prompts(tcfg.vocab_size, 1, 9, 16, seed=4)[1]]
    sched_prompts = {10 + u: p for u, p in
                     _repetitive_prompts(tcfg.vocab_size, 4, 24, 16).items()}
    out = {}
    for key, eng in engines.items():
        samp = JSampling() if key == "jax" else SamplingParams()
        run = dict(first=eng.put([1, 2, 3], put_prompts, samp),
                   steps=[eng.step(samp) for _ in range(8)])
        run["tokens"] = {u: list(eng.mgr.seqs[u].tokens) for u in (1, 2, 3)}
        run["blocks"] = {u: list(eng.mgr.seqs[u].blocks) for u in (1, 2, 3)}
        run["stats"] = dict(eng.stats)
        eng.flush([1, 2, 3])
        samp = (JSampling if key == "jax" else SamplingParams)(max_new_tokens=16)
        for u, p in sched_prompts.items():
            eng.scheduler.submit(u, p, samp)
        run["results"] = eng.scheduler.run()
        run["sched_delta"] = {k: eng.stats[k] - run["stats"][k] for k in SPEC_STATS}
        run["sched_stats"] = dict(eng.scheduler.stats)
        run["close"] = eng.close()
        out[key] = run
    return out


def test_spec_scheduler_matches_jax_engine(engine_twins):
    """The scheduler workload: the port's greedy streams equal the JAX spec
    engine's and the port's plain engine's, and the dispatch and
    speculation counters equal JAX's."""
    port, plain, jax_run = engine_twins["port"], engine_twins["plain"], engine_twins["jax"]
    assert port["results"] == plain["results"] == jax_run["results"]
    assert all(len(r) == 16 for r in jax_run["results"].values())
    assert port["sched_delta"] == jax_run["sched_delta"]
    for k in ("preemptions", "drafts_shed", "prefill_chunks"):
        assert port["sched_stats"][k] == jax_run["sched_stats"][k], k
    assert port["sched_delta"]["spec_accepted"] > 0
    assert port["close"]["blocks_in_use"] == plain["close"]["blocks_in_use"] == 0
    assert jax_run["close"]["blocks_in_use"] == 0


def test_spec_put_step_matches_jax_engine(engine_twins):
    """put() then step() with speculation: each tick's newest token, the
    whole token history, the block lists and the counters equal JAX's."""
    port, jax_run = engine_twins["port"], engine_twins["jax"]
    assert port["first"] == jax_run["first"]
    assert port["steps"] == jax_run["steps"]
    assert port["tokens"] == jax_run["tokens"]
    assert port["blocks"] == jax_run["blocks"]
    assert {k: port["stats"][k] for k in SPEC_STATS} == \
        {k: jax_run["stats"][k] for k in SPEC_STATS}
    assert port["stats"]["spec_ticks"] > 0


def test_spec_over_int8_weights_matches_jax_engine(tiny):
    """Speculation over a quantized tree runs unchanged: an int8 spec
    engine's greedy stream equals JAX's int8 spec engine's."""
    jcfg, jp, tcfg, tp = tiny
    kw = dict(max_seqs=2, num_blocks=32, block_size=8, prefill_buckets=(32,),
              enable_speculation=True, quantize_weights="int8")
    prompt = [5, 6, 7, 8] * 4 + [9, 3]
    te = InferenceEngineV2(tp, tcfg, device="cpu", **kw)
    got = te.generate(prompt, SamplingParams(max_new_tokens=16))
    assert got == JEngine(jp, jcfg, **kw).generate(prompt, JSampling(max_new_tokens=16))
    assert te.stats["spec_ticks"] > 0


# ---------------------------------------------------------------------------
# the verify pass: mid-page KV writes and all-row logits
# ---------------------------------------------------------------------------
def _verify_pack(bs, nb, seen, n_drafts, vocab, K=3, seed=0):
    """A verify pack over N slots: slot i's committed length ``seen[i]``
    (ending mid-page) and ``n_drafts[i]`` drafts; rows slot * (K + 1) + j,
    pad rows segment 0 / page -1.  Pages come from one permutation."""
    rng = np.random.default_rng(seed)
    N, K1 = len(seen), K + 1
    P = -(-(max(seen) + K1) // bs)
    perm = rng.permutation(nb)
    tables = np.full((N, P), -1, np.int32)
    nxt = 0
    for i, L in enumerate(seen):
        pages = -(-(L + n_drafts[i] + 1) // bs)
        tables[i, :pages] = perm[nxt:nxt + pages]
        nxt += pages
    T = N * K1
    tok, seg, pos = (np.zeros(T, np.int32) for _ in range(3))
    dst_pages, dst_offs = np.full(T, -1, np.int32), np.zeros(T, np.int32)
    for i, L in enumerate(seen):
        for j in range(n_drafts[i] + 1):
            r, p = i * K1 + j, L + j
            tok[r], seg[r], pos[r] = rng.integers(1, vocab), i + 1, p
            dst_pages[r], dst_offs[r] = tables[i, p // bs], p % bs
    return tok, seg, pos, dst_pages, dst_offs, tables, np.asarray(seen, np.int32)


def test_write_spec_kv_matches_jax():
    nb, bs, hkv, hd = 12, 8, 2, 16
    _, _, _, pages, offs, _, _ = _verify_pack(bs, nb, [5, 13, 0, 22], [3, 0, 2, 1], 50)
    pool = np.random.default_rng(1).normal(size=(nb, bs, hkv, hd)).astype(np.float32)
    kv = np.random.default_rng(2).normal(size=(pages.shape[0], hkv, hd)).astype(np.float32)
    want = jpaged.write_spec_kv(jnp.asarray(pool), jnp.asarray(kv), jnp.asarray(pages),
                                jnp.asarray(offs))
    got = torch.from_numpy(pool.copy())
    paged.write_spec_kv(got, torch.from_numpy(kv), pages, offs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the rows before each mid-page start are untouched
    np.testing.assert_array_equal(got.numpy()[pages[0], :5], pool[pages[0], :5])


@pytest.mark.parametrize("name", ["tiny", "tiny_gpt2"])
def test_verify_packed_ctx_matches_jax(name, tiny, tiny_gpt2):
    """The port's verify pass against JAX's (whose packed-context attention
    runs its jnp dense body on the CPU) over context lengths that end
    mid-page and a slot with no drafts: every live row's logits, and the
    pools after the row-scatter writes."""
    jcfg, jp, tcfg, tp = tiny if name == "tiny" else tiny_gpt2
    nb, bs, L = 24, 8, jcfg.num_layers
    hkv, hd = jcfg.num_kv_heads, jcfg.head_dim or jcfg.hidden_size // jcfg.num_heads
    seen, n_drafts = [5, 13, 0, 22], [3, 0, 2, 1]
    tok, seg, pos, pages, offs, tables, lens = _verify_pack(bs, nb, seen, n_drafts,
                                                            jcfg.vocab_size)
    rng = np.random.default_rng(3)
    ck = [rng.normal(size=(nb, bs, hkv, hd)).astype(np.float32) for _ in range(L)]
    cv = [rng.normal(size=(nb, bs, hkv, hd)).astype(np.float32) for _ in range(L)]
    j_logits, (jck, jcv) = J_VERIFY(
        jp, jcfg, *(jnp.asarray(x) for x in (tok, seg, pos, pages, offs, tables, lens)),
        (tuple(map(jnp.asarray, ck)), tuple(map(jnp.asarray, cv))))
    kv = (tuple(torch.from_numpy(x.copy()) for x in ck),
          tuple(torch.from_numpy(x.copy()) for x in cv))
    t_logits, (tck, tcv) = model_runner.verify_packed_ctx(
        tp, tcfg, tok, seg, pos, pages, offs, tables, lens, kv)
    live = seg > 0
    assert t_logits.shape == (len(tok), jcfg.vocab_size)
    np.testing.assert_allclose(t_logits.numpy()[live], np.asarray(j_logits)[live],
                               atol=1e-4, rtol=1e-4)
    for a, b in zip(tck + tcv, jck + jcv):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
