"""GPT-2 serving at head_dim 64 in the port, against the JAX package on the
CPU: the presets, the parameter tree (learned positions, LayerNorm scale and
bias, the tied head, no qkv bias), ``gpt2_small`` cut to 2 layers at full
width through the training forward and the serving runner (prefill, decode
at learned positions, the verify pass), the decode body at head_dim 64
against JAX's lane-packed TPU kernel K2p run in interpret mode, and the
engine on ``tiny_gpt2``.

Tolerances, fp32: logits atol 1e-4, rtol 1e-4 (fp32 matmuls of width 768
and 3072 summed in another order move logits of order 1 by ~1e-6); K2's
plain version atol 1e-5, rtol 1e-4 (the same products, einsum against a
blocked online softmax).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import model_runner as jmr
from deepspeed_tpu.inference.engine_v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.paged import init_paged_cache as j_init_cache
from deepspeed_tpu.inference.sampling import SamplingParams as JSampling
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.models.transformer import forward as j_forward
from deepspeed_tpu.models.transformer import init_params as j_init
from deepspeed_tpu.ops.pallas import paged_attention as jpk
from deepspeed_tpu_torch.inference import model_runner as tmr
from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.paged import init_paged_cache as t_init_cache
from deepspeed_tpu_torch.inference.sampling import SamplingParams
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.models.transformer import forward as t_forward
from deepspeed_tpu_torch.models.transformer import init_params as t_init
from deepspeed_tpu_torch.models.transformer import params_from_numpy
from deepspeed_tpu_torch.ops.kernels.paged_attention import paged_attention_decode
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

ATOL = RTOL = 1e-4
BS, NB = 16, 16
# the JAX runner under jit, as its engine calls it (cfg static)
J_PACKED = jax.jit(jmr.prefill_packed, static_argnums=(1,))
J_DECODE = jax.jit(jmr.decode_step, static_argnums=(1,))
J_VERIFY = jax.jit(jmr.verify_packed_ctx, static_argnums=(1,))


@pytest.fixture(scope="module")
def gpt2_2l():
    """gpt2_small at full width (d 768, 12 heads of 64, vocab 50257), 2 layers."""
    jcfg = j_preset("gpt2_small", num_layers=2, dtype=jnp.float32)
    tcfg = get_preset("gpt2_small", num_layers=2, dtype=torch.float32)
    jp = j_init(jax.random.PRNGKey(0), cfg=jcfg, dtype=jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _close(a, b, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=rtol)


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


@pytest.mark.parametrize("name", ["gpt2_small", "tiny_gpt2"])
def test_gpt2_presets_match_jax(name):
    j, t = j_preset(name), get_preset(name)
    shared = {f.name for f in dataclasses.fields(t)} & {f.name for f in dataclasses.fields(j)}
    shared.discard("dtype")
    assert {n: getattr(t, n) for n in shared} == {n: getattr(j, n) for n in shared}
    assert t.hd == 64 if name == "gpt2_small" else 16
    assert t.num_heads == t.num_kv_heads  # MHA: query group g = 1


@pytest.mark.parametrize("name", ["gpt2_small", "tiny_gpt2"])
def test_gpt2_tree_carries_across(name):
    """The JAX tree carried over by ``params_from_numpy`` has exactly the
    paths and shapes of the port's own ``init_params``: learned
    ``pos_embed``, LayerNorm scale and bias, no ``lm_head`` (tied), no qkv
    bias."""
    over = dict(num_layers=1) if name == "gpt2_small" else {}
    jcfg = j_preset(name, dtype=jnp.float32, **over)
    tcfg = get_preset(name, dtype=torch.float32, **over)
    # the JAX tree's paths, shapes and dtypes (zeros: only the structure is
    # compared)
    shapes = jax.eval_shape(lambda: j_init(jax.random.PRNGKey(0), cfg=jcfg))
    jp = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype), shapes)
    carried = _paths(params_from_numpy(jp, tcfg, device="cpu"))
    assert carried == _paths(t_init(tcfg, device="cpu"))
    assert carried["pos_embed/embedding"] == (tcfg.max_seq_len, tcfg.hidden_size)
    for p in ("final_norm/bias", "layers/attn_norm/bias", "layers/mlp_norm/bias"):
        assert p in carried
    assert not any(p.startswith("lm_head") or p.endswith("/bq") for p in carried)


def test_gpt2_small_two_layers_forward_matches_jax(gpt2_2l):
    jcfg, jp, tcfg, tp = gpt2_2l
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    want, _, _ = j_forward(jp, jnp.asarray(tokens), jcfg)
    got = t_forward(tp, torch.from_numpy(tokens).long(), tcfg)
    _close(got.detach(), want)


def test_gpt2_small_two_layers_serving_matches_jax(gpt2_2l):
    """Packed prefill of two prompts, two decode ticks at learned positions
    (one slot past a page boundary), then a verify pack that starts
    mid-page: logits and pools against the JAX runner."""
    jcfg, jp, tcfg, tp = gpt2_2l
    rng = np.random.default_rng(1)
    lens = (20, 31)
    T = 64
    tok, seg, pos = (np.zeros(T, np.int32) for _ in range(3))
    tok[:20], seg[:20], pos[:20] = rng.integers(0, jcfg.vocab_size, 20), 1, np.arange(20)
    tok[32:63], seg[32:63], pos[32:63] = rng.integers(0, jcfg.vocab_size, 31), 2, np.arange(31)
    pack_pages = np.array([3, 7, 1, 9], np.int32)
    last_idx = np.array([19, 62], np.int32)
    tables = np.full((2, 4), -1, np.int32)
    tables[0, :2], tables[1, :3] = (3, 7), (1, 9, 5)
    jkv = j_init_cache(2, NB, BS, 12, 64, dtype=jnp.float32)
    tkv = t_init_cache(2, NB, BS, 12, 64, dtype=torch.float32, device="cpu")
    args = (tok, seg, pos, pack_pages, last_idx)
    jl, jkv = J_PACKED(jp, jcfg, *map(jnp.asarray, args), jkv)
    tl, tkv = tmr.prefill_packed(tp, tcfg, *args, tkv)
    _close(tl, jl)
    seq_lens = np.array(lens, np.int32)
    active = np.ones(2, bool)
    for _ in range(2):
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
        jl, jkv = J_DECODE(jp, jcfg, jnp.asarray(nxt), jnp.asarray(seq_lens),
                           jnp.asarray(tables), jnp.asarray(active), jkv)
        tl, tkv = tmr.decode_step(tp, tcfg, nxt, seq_lens, tables, active, tkv)
        _close(tl, jl)
        seq_lens = seq_lens + 1
    # verify: slot 0 with 2 drafts from position 22, slot 1 with none at 33
    K1 = 3
    vt, vs, vp = (np.zeros(2 * K1, np.int32) for _ in range(3))
    vpg, vof = np.full(2 * K1, -1, np.int32), np.zeros(2 * K1, np.int32)
    for slot, n in ((0, 2), (1, 0)):
        for i in range(n + 1):
            r, p = slot * K1 + i, int(seq_lens[slot]) + i
            vt[r], vs[r], vp[r] = rng.integers(0, jcfg.vocab_size), slot + 1, p
            vpg[r], vof[r] = tables[slot, p // BS], p % BS
    vargs = (vt, vs, vp, vpg, vof, tables, seq_lens)
    jl, jkv = J_VERIFY(jp, jcfg, *map(jnp.asarray, vargs), jkv)
    tl, tkv = tmr.verify_packed_ctx(tp, tcfg, *vargs, tkv)
    live = vs > 0
    _close(tl.numpy()[live], np.asarray(jl)[live])
    for a, b in zip(tkv[0] + tkv[1], jkv[0] + jkv[1]):
        _close(a, b, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# K2 at head_dim 64 against the TPU's lane-packed variant K2p
# ---------------------------------------------------------------------------
@pytest.fixture
def jax_interpret():
    jpk.set_interpret(True)
    try:
        yield
    finally:
        jpk.set_interpret(False)


@pytest.mark.parametrize("hq,hkv", [(12, 12), (8, 2)])
def test_decode_plain_matches_jax_packed_kernel(jax_interpret, hq, hkv):
    """K2's plain version (what the CUDA kernel is held to on the card) at
    head_dim 64 against ``_paged_decode_packed`` (K2p) in interpret mode:
    gpt2_small's MHA heads and the GQA shape of JAX's own packed test."""
    assert jpk._packed_mode(64, hkv)
    rng = np.random.default_rng(hkv)
    B, nb, bs, P, hd = 4, 16, 8, 4, 64
    q = rng.standard_normal((B, hq, hd)).astype(np.float32)
    ck = rng.standard_normal((nb, bs, hkv, hd)).astype(np.float32)
    cv = rng.standard_normal((nb, bs, hkv, hd)).astype(np.float32)
    tables = rng.permutation(nb)[:B * P].reshape(B, P).astype(np.int32)
    lens = np.array([1, 9, 17, 32], np.int32)  # one page, mid-page, a full table
    want = jpk._paged_decode_packed(*(jnp.asarray(x) for x in (q, ck, cv, tables, lens)),
                                    hd ** -0.5)
    got = paged_attention_decode(*(torch.from_numpy(x) for x in (q, ck, cv, tables, lens)))
    _close(got, want, atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# the engine on tiny_gpt2
# ---------------------------------------------------------------------------
def test_gpt2_engine_matches_jax_engine():
    """put() over two packs, greedy step()s past a page boundary, then the
    scheduler with prefix caching: token-identical to the JAX engine."""
    jcfg = j_preset("tiny_gpt2", dtype=jnp.float32)
    tcfg = get_preset("tiny_gpt2", dtype=torch.float32)
    jp = j_init(jax.random.PRNGKey(0), cfg=jcfg, dtype=jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    kw = dict(max_seqs=4, num_blocks=40, block_size=8, prefill_buckets=(32, 64),
              prefill_budget=32, enable_prefix_caching=True)
    je, te = JEngine(jp, jcfg, **kw), InferenceEngineV2(tp, tcfg, device="cpu", **kw)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 256, n).tolist() for n in (5, 21, 14)]
    assert te.put([1, 2, 3], prompts) == je.put([1, 2, 3], prompts)
    for _ in range(10):
        assert te.step(SamplingParams()) == je.step(JSampling())
    te.flush([1, 2, 3])
    je.flush([1, 2, 3])
    shared = rng.integers(1, 256, 24).tolist()
    reqs = {u: shared + rng.integers(1, 256, 6).tolist() for u in (4, 5, 6)}
    for u, p in reqs.items():
        te.scheduler.submit(u, p, SamplingParams(max_new_tokens=8))
        je.scheduler.submit(u, p, JSampling(max_new_tokens=8))
    assert te.scheduler.run() == je.scheduler.run()
    assert te.mgr.cached_prompt_tokens == je.mgr.cached_prompt_tokens > 0
    assert te.close() == je.close()
