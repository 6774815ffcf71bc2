"""The port's dense v1 engine (``deepspeed_tpu_torch/inference/engine.py``:
``InferenceEngine``, ``init_inference``) and the dense-cache path of
``models/transformer.py`` against the JAX package on the CPU, fp32,
weights from JAX ``init_params(PRNGKey(0))`` through ``params_from_numpy``.

- greedy generation token-identical to JAX's ``init_inference`` on
  ``tiny``, ``tiny_moe`` (dropless experts), ``tiny_alibi`` (ALiBi over
  the cache) and ``tiny_parallel`` (the parallel block), also where
  ``max_seq_len`` ends the cache before ``max_new_tokens``;
- ``forward(cache=, cache_index=)``: the prefill's logits and the cache
  written, then one decode step, against JAX's (``TOL``);
- ``init_kv_cache`` laid out as JAX's;
- the attention body chosen as JAX's flash entry chooses it:
  ``flash_supports`` equal to JAX ``flash_kernel.supports`` over a grid of
  shapes, and a prefill that fills the whole cache at head dim 64 counted
  on the flash body (``transformer.CACHE_ATTENTION``), everything else on
  the plain body;
- sampled generation reproducible from the seed; a mesh of two devices
  refused naming item 7; no CUDA device and no ``device`` raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.engine import init_inference as j_init_inference
from deepspeed_tpu.inference.sampling import SamplingParams as JSampling
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.ops.pallas import flash_kernel

from deepspeed_tpu_torch.inference import InferenceEngine, init_inference
from deepspeed_tpu_torch.inference.sampling import SamplingParams
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.parallel.topology import initialize_mesh
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

TOL = dict(atol=2e-5, rtol=1e-4)
V1_PRESETS = ["tiny", "tiny_moe", "tiny_alibi", "tiny_parallel"]


@pytest.fixture(scope="module")
def models():
    """(jcfg, jax params, tcfg, port params) per preset, fp32, built once."""
    cache = {}

    def get(name, **over):
        key = (name, tuple(sorted(over.items())))
        if key not in cache:
            jcfg = j_preset(name, dtype=jnp.float32, **over)
            jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
            tcfg = get_preset(name, dtype=torch.float32, **over)
            tp = tt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                                      device="cpu")
            cache[key] = jcfg, jp, tcfg, tp
        return cache[key]

    return get


def _prompts(b, s, vocab=256, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("name", V1_PRESETS)
@pytest.mark.parametrize("max_seq_len", [None, 16], ids=["full", "cut_at_16"])
def test_greedy_generation_is_token_identical_to_jax(models, name, max_seq_len):
    jcfg, jp, tcfg, tp = models(name)
    prompt = _prompts(3, 11, seed=len(name))
    kw = {} if max_seq_len is None else dict(max_seq_len=max_seq_len)
    want = j_init_inference(jt.CausalLM(jcfg), jp, **kw).generate(
        prompt, JSampling(max_new_tokens=12))
    eng = init_inference(tt.CausalLM(tcfg), tp, device="cpu", **kw)
    got = eng.generate(prompt, SamplingParams(max_new_tokens=12))
    assert isinstance(eng, InferenceEngine)
    assert got.shape == want.shape == (3, 12 if max_seq_len is None else 6)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", V1_PRESETS)
def test_cached_forward_matches_jax(models, name):
    """The prefill at index 0 into a 20-long cache, then one token at
    index 9: logits and every cache entry against JAX's."""
    jcfg, jp, tcfg, tp = models(name)
    prompt = _prompts(2, 9, seed=1)
    jcache = jt.init_kv_cache(jcfg, 2, 20)
    tcache = tt.init_kv_cache(tcfg, 2, 20, device="cpu")
    assert [tuple(c.shape) for c in tcache] == [tuple(c.shape) for c in jcache]
    assert tcache[0].dtype == torch.float32
    jl, jcache, jaux = jt.forward(jp, jnp.asarray(prompt), jcfg, cache=jcache, cache_index=0)
    with torch.no_grad():
        tl, tcache, aux = tt.forward(tp, torch.from_numpy(prompt).long(), tcfg, cache=tcache,
                                     cache_index=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert aux.item() == float(jaux) == 0.0
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    jl2, jcache, _ = jt.forward(jp, jnp.asarray(nxt), jcfg, cache=jcache, cache_index=9)
    with torch.no_grad():
        tl2, tcache, _ = tt.forward(tp, torch.from_numpy(nxt).long(), tcfg, cache=tcache,
                                    cache_index=9)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **TOL)
    for got, want in zip(tcache, jcache):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_supports_is_jax_supports():
    """The static predicate the cache path chooses its body by, over
    offsets, lengths, head dims, groups and segment ids."""
    def arrays(lib, b, sq, sk, hq, hk, d):
        zeros = torch.zeros if lib is torch else jnp.zeros
        return zeros((b, sq, hq, d)), zeros((b, sk, hk, d))

    cases = [(0, 128, 128, 4, 2, 64, None), (0, 256, 256, 8, 8, 128, (1, 256)),
             (0, 256, 384, 4, 2, 64, None), (3, 128, 128, 4, 2, 64, None),
             (0, 64, 64, 4, 2, 64, None), (0, 200, 200, 4, 2, 64, None),
             (0, 128, 128, 4, 2, 80, None), (0, 128, 128, 4, 3, 64, None),
             (0, 128, 128, 4, 2, 256, (1, 64)), (0, 1024, 1024, 32, 8, 128, None)]
    seen = set()
    for off, sq, sk, hq, hk, d, seg in cases:
        q, k = arrays(torch, 1, sq, sk, hq, hk, d)
        jq, jk = arrays(jnp, 1, sq, sk, hq, hk, d)
        tseg = torch.zeros(seg, dtype=torch.int32) if seg else None
        jseg = jnp.zeros(seg, jnp.int32) if seg else None
        want = flash_kernel.supports(jq, jk, jk, True, off, jseg, None)
        assert tt.flash_supports(q, k, off, tseg) == want, (off, sq, sk, hq, hk, d, seg)
        seen.add(want)
    assert seen == {True, False}
    assert not tt.flash_supports(*arrays(torch, 1, 128, 128, 4, 2, 64),
                                 torch.tensor(0))  # a traced offset, as in JAX


def test_cache_path_counts_each_attention_body(models):
    """With ``attn_impl="flash"`` a prefill whose prompt fills the whole
    cache (s = max_seq_len = 128, head dim 64) takes the flash body in
    every layer; a longer cache or a decode step takes the plain body.
    The tokens equal JAX's engine, which runs its plain body on the CPU."""
    over = dict(hidden_size=256, num_heads=4, num_kv_heads=2, attn_impl="flash")
    jcfg, jp, tcfg, tp = models("tiny", **over)
    prompt = _prompts(2, 128, seed=2)
    tt.CACHE_ATTENTION.update(flash=0, plain=0)
    eng = init_inference(tt.CausalLM(tcfg), tp, device="cpu", max_seq_len=128)
    got = eng.generate(prompt, SamplingParams(max_new_tokens=4))
    assert got.shape == (2, 1)  # the cache is full after the prompt
    assert tt.CACHE_ATTENTION == {"flash": tcfg.num_layers, "plain": 0}
    want = j_init_inference(jt.CausalLM(jcfg), jp, max_seq_len=128).generate(
        prompt, JSampling(max_new_tokens=4))
    np.testing.assert_array_equal(got, want)
    tt.CACHE_ATTENTION.update(flash=0, plain=0)
    got = init_inference(tt.CausalLM(tcfg), tp, device="cpu", max_seq_len=256).generate(
        prompt, SamplingParams(max_new_tokens=3))
    # the prefill and a decode after each of the 3 tokens (JAX decodes past
    # the last one too)
    assert tt.CACHE_ATTENTION == {"flash": 0, "plain": 4 * tcfg.num_layers}
    want = j_init_inference(jt.CausalLM(jcfg), jp, max_seq_len=256).generate(
        prompt, JSampling(max_new_tokens=3))
    np.testing.assert_array_equal(got, want)


def test_sampled_generation_is_reproducible_from_the_seed(models):
    _, _, tcfg, tp = models("tiny")
    prompt = _prompts(2, 7, seed=3)
    samp = SamplingParams(temperature=0.8, top_k=20, top_p=0.9, max_new_tokens=8)
    a = init_inference(tt.CausalLM(tcfg), tp, device="cpu", seed=5).generate(prompt, samp)
    b = init_inference(tt.CausalLM(tcfg), tp, device="cpu", seed=5).generate(prompt, samp)
    c = init_inference(tt.CausalLM(tcfg), tp, device="cpu", seed=6).generate(prompt, samp)
    assert a.shape == (2, 8) and a.dtype == np.int32
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_init_inference_from_seed_and_refusals(models, monkeypatch):
    """``params=None`` initialises from ``seed`` in the model's type; a
    mesh of two devices is tensor-parallel serving (item 7); no CUDA
    device and no ``device`` raises rather than running on the CPU."""
    _, _, tcfg, _ = models("tiny")
    eng = init_inference(tt.CausalLM(tcfg), device="cpu", seed=3)
    again = init_inference(tt.CausalLM(tcfg), device="cpu", seed=3)
    assert torch.equal(eng.params["layers"]["attn"]["wq"], again.params["layers"]["attn"]["wq"])
    one = initialize_mesh(devices=["cpu"], data=1)
    assert init_inference(tt.CausalLM(tcfg), mesh=one).device == torch.device("cpu")
    with pytest.raises(NotImplementedError, match=r"mesh of more than one device .*item 7"):
        init_inference(tt.CausalLM(tcfg), mesh=initialize_mesh(devices=["cpu"] * 2, seq=2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_inference(tt.CausalLM(tcfg))
