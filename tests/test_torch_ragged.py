"""The port's ``BlockedAllocator`` / ``StateManager`` against the JAX
package's ``ragged.py`` (both host-side Python): a seeded sequence of
admissions with shared prefixes, growth, publication, copy-on-write,
truncation and release must hand out the same block ids with the same
refcounts, cache contents and copy-on-write calls at every step.
"""
import numpy as np
import pytest

from deepspeed_tpu.inference import ragged as jr
from deepspeed_tpu_torch.inference import ragged as tr

BS, NB, SLOTS = 4, 24, 5


def _state(mgr):
    a = mgr.allocator
    return dict(
        seqs={u: (s.slot, list(s.blocks), s.seen_tokens, s.cached_tokens, len(s.hashes))
              for u, s in mgr.seqs.items()},
        refs=[a.refcount(b) for b in range(NB)],
        free=a.free_blocks, cached=a.cached_blocks, evictions=a.evictions,
        registrations=a.registrations, lru=list(a._lru),
        hits=(mgr.prompt_tokens_total, mgr.cached_prompt_tokens),
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_blocks_and_refcounts_as_jax(seed):
    rng = np.random.default_rng(seed)
    mgrs = [jr.StateManager(NB, BS, SLOTS, enable_prefix_caching=True),
            tr.StateManager(NB, BS, SLOTS, enable_prefix_caching=True)]
    cows = [[], []]
    for m, log in zip(mgrs, cows):
        m.cow_hook = lambda src, dst, log=log: log.append((src, dst))
    prefix = rng.integers(1, 50, 3 * BS).tolist()
    next_uid = 1
    for _ in range(150):
        op = rng.choice(["admit", "admit", "grow", "release", "cow", "cow", "truncate",
                         "extend"])
        live = sorted(mgrs[0].seqs)
        if op == "admit" and mgrs[0].free_slots:
            shared = int(rng.choice([0, BS, len(prefix), len(prefix)]))
            toks = prefix[:shared] + rng.integers(1, 50, int(rng.integers(1, 9))).tolist()
            outcomes = []
            for m in mgrs:
                ok = m.can_admit_all([len(toks)], token_lists=[toks])
                if ok:
                    s = m.admit(next_uid, toks)
                    try:
                        m.ensure_capacity(s, 0)
                        s.seen_tokens = len(toks)
                        m.update_hashes(s)
                    except RuntimeError:
                        m.release(next_uid)
                        ok = "raised"
                outcomes.append(ok)
            assert outcomes[0] == outcomes[1]
            next_uid += 1
        elif op == "grow" and live:
            u = live[int(rng.integers(len(live)))]
            new = [int(t) for t in rng.integers(1, 50, int(rng.integers(1, 6)))]
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
        elif op == "extend" and live:
            u = live[int(rng.integers(len(live)))]
            for m in mgrs:
                m.extend_match(m.seqs[u])
        assert _state(mgrs[0]) == _state(mgrs[1]), op
        assert cows[0] == cows[1]
    assert cows[0] and mgrs[0].cached_prompt_tokens > 0  # the sequence hit both paths
    for m in mgrs:
        for u in list(m.seqs):
            m.release(u)
        m.allocator.audit()
    assert _state(mgrs[0]) == _state(mgrs[1])


def test_one_replica_one_stripe_only():
    """Replica partitioning is still refused (ROADMAP queue 1 item 7); seq-shard
    stripes are ported (tests/test_torch_seq_shard.py) and take the JAX
    module's argument checks."""
    with pytest.raises(NotImplementedError, match="item 7"):
        tr.StateManager(8, 4, 2, replicas=2)
    for make in (lambda m: m.BlockedAllocator(8, stripes=3),
                 lambda m: m.BlockedAllocator(8, stripes=0),
                 lambda m: m.StateManager(9, 4, 2, seq_shards=2)):
        for m in (jr, tr):
            with pytest.raises(ValueError):
                make(m)
    assert tr.StateManager(8, 4, 2, seq_shards=2).allocator.stripes == 2
