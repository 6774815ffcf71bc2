"""The port's model runner (deepspeed_tpu_torch/inference/model_runner.py)
against the JAX runner on the CPU: packed prefill, packed prefill over
cached context, and batched decode — logits and the written KV pools.

Both packages compute with the same weights (JAX ``init_params`` ->
``params_from_numpy``) in fp32.  Tolerance atol 1e-4, rtol 1e-4: logits of
order 1 after a few layers of fp32 matmuls whose sums the two frameworks
order differently.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import model_runner as jmr
from deepspeed_tpu.inference.paged import init_paged_cache as j_init_cache
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.models.transformer import init_params as j_init
from deepspeed_tpu_torch.inference import model_runner as tmr
from deepspeed_tpu_torch.inference.paged import init_paged_cache as t_init_cache
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.models.transformer import params_from_numpy

ATOL = RTOL = 1e-4

# the JAX runner under jit, as its engine calls it (cfg static)
J_PREFILL = jax.jit(jmr.prefill, static_argnums=(1,))
J_PACKED = jax.jit(jmr.prefill_packed, static_argnums=(1,))
J_PACKED_CTX = jax.jit(jmr.prefill_packed_ctx, static_argnums=(1,))
J_DECODE = jax.jit(jmr.decode_step, static_argnums=(1,))
BS, NB, N, P = 16, 24, 4, 6

NARROW = dict(num_layers=2, hidden_size=512, intermediate_size=1024, head_dim=128,
              num_heads=4, num_kv_heads=1, vocab_size=1024, max_seq_len=256)
CONFIGS = {"tiny": ("tiny", {}), "narrow_hd128": ("llama3_proxy_410m", NARROW)}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    name, over = CONFIGS[request.param]
    jcfg = j_preset(name, dtype=jnp.float32, **over)
    tcfg = get_preset(name, dtype=torch.float32, **over)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _caches(jcfg, tcfg):
    jkv = j_init_cache(jcfg.num_layers, NB, BS, jcfg.num_kv_heads, jcfg.hd, dtype=jnp.float32)
    tkv = t_init_cache(tcfg.num_layers, NB, BS, tcfg.num_kv_heads, tcfg.hd,
                       dtype=torch.float32, device="cpu")
    return jkv, tkv


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL, rtol=RTOL)


def _same_pools(jkv, tkv, lens):
    """Pools agree on every written LIVE row: slot -> length in ``lens``.
    Rows past a prompt's end inside its last page hold pad-token garbage
    that attention masks by length (the pad rows' own attention differs:
    the port's packed-context body returns 0 there)."""
    rows = [(pages[p // BS], p % BS) for slot, n in lens.items()
            for p in range(n) for pages in [PAGES[slot]]]
    idx = tuple(np.array(r) for r in zip(*rows))
    for j, t in zip(jkv[0] + jkv[1], tkv[0] + tkv[1]):
        _close(t.numpy()[idx], np.asarray(j)[idx])


def _pack(entries, t, vocab, seed):
    """entries [(slot, start, end, pages)] -> pack arrays (page-aligned)."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros(t, np.int32)
    seg = np.zeros(t, np.int32)
    pos = np.zeros(t, np.int32)
    pack_pages = np.full(t // BS, -1, np.int32)
    last_idx = np.full(N, -1, np.int32)
    cur = 0
    for slot, start, end, pages in entries:
        n = end - start
        tokens[cur:cur + n] = rng.integers(1, vocab, n)
        seg[cur:cur + n] = slot + 1
        pos[cur:cur + n] = np.arange(start, end)
        n_pages = -(-n // BS)
        pack_pages[cur // BS: cur // BS + n_pages] = pages[start // BS: start // BS + n_pages]
        last_idx[slot] = cur + n - 1
        cur += n_pages * BS
    return tokens, seg, pos, pack_pages, last_idx


PAGES = {0: [3, 7, 1, 12, 5], 2: [9, 2, 14, 4], 3: [20, 21]}


def test_prefill_packed_ctx_and_decode_match_jax(models):
    jcfg, jp, tcfg, tp = models
    jkv, tkv = _caches(jcfg, tcfg)

    # cold pack: two prompts (slots 0 and 2), the first prompt's first chunk
    args = _pack([(0, 0, 32, PAGES[0]), (2, 0, 37, PAGES[2])], 128, jcfg.vocab_size, 0)
    jl, jkv = J_PACKED(jp, jcfg, *(jnp.asarray(a) for a in args), jkv)
    tl, _ = tmr.prefill_packed(tp, tcfg, *args, tkv)
    _close(tl.numpy(), jl)
    _same_pools(jkv, tkv, {0: 32, 2: 37})

    # continuation pack over cached context: slot 0 resumes at 32 (page
    # aligned), slot 3 is a cold prompt riding the same context-aware pack
    args = _pack([(0, 32, 70, PAGES[0]), (3, 0, 20, PAGES[3])], 96, jcfg.vocab_size, 1)
    tables = np.full((N, P), -1, np.int32)
    for slot, pages in PAGES.items():
        tables[slot, :len(pages)] = pages
    lens = np.array([32, 0, 0, 0], np.int32)
    jl, jkv = J_PACKED_CTX(jp, jcfg, *(jnp.asarray(a) for a in args),
                                     jnp.asarray(tables), jnp.asarray(lens), jkv)
    tl, _ = tmr.prefill_packed_ctx(tp, tcfg, *args, tables, lens, tkv)
    _close(tl.numpy(), jl)
    _same_pools(jkv, tkv, {0: 70, 2: 37, 3: 20})

    # three decode ticks: slots 0 and 2 active, 1 and 3 idle
    rng = np.random.default_rng(2)
    seq_lens = np.array([70, 0, 37, 0], np.int32)
    active = np.array([True, False, True, False])
    for _ in range(3):
        toks = rng.integers(1, jcfg.vocab_size, N).astype(np.int32)
        jl, jkv = J_DECODE(jp, jcfg, jnp.asarray(toks), jnp.asarray(seq_lens),
                                  jnp.asarray(tables), jnp.asarray(active), jkv)
        tl, _ = tmr.decode_step(tp, tcfg, toks, seq_lens, tables, active, tkv)
        _close(tl.numpy()[active], np.asarray(jl)[active])
        seq_lens = seq_lens + active
        _same_pools(jkv, tkv, {0: int(seq_lens[0]), 2: int(seq_lens[2]), 3: 20})


def test_single_prompt_prefill_matches_jax(models):
    jcfg, jp, tcfg, tp = models
    jkv, tkv = _caches(jcfg, tcfg)
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, jcfg.vocab_size, 48).astype(np.int32)
    blocks = np.array([4, 11, -1], np.int32)  # 41-token prompt in 3 pages, last pad
    jl, jkv = J_PREFILL(jp, jcfg, jnp.asarray(tokens), jnp.int32(41),
                          jnp.asarray(blocks), jkv)
    tl, _ = tmr.prefill(tp, tcfg, tokens, 41, blocks, tkv)
    _close(tl.numpy(), jl)
    for j, t in zip(jkv[0] + jkv[1], tkv[0] + tkv[1]):  # the whole pool: no pad rows
        _close(t.numpy(), j)
