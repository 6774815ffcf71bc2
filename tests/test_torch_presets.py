"""The port's presets against the JAX package's, on the CPU in fp32.

- Every port preset's fields equal JAX ``get_preset``'s (dtype by name),
  and ``list_presets()`` is JAX's, the two MoE presets included.
- Each preset the port added, cut to 2 layers at a narrow width through
  ``get_preset(name, **NARROW[name])`` (its family switches, query group,
  rotary dims and, for ``phi_2`` and ``gpt_neox_20b``, head dims 80 and 96
  kept), with its own ``remat``: the forward logits and the loss and every
  gradient against JAX.  The port runs the flash Function (its plain
  versions on the CPU; head dims 80 / 96 padded to 128) except under ALiBi;
  JAX its reference body.
- Greedy serving of ``llama2_7b``, ``mistral_7b``, ``qwen2_7b`` and
  ``opt_6_7b`` (narrow) token-identical to JAX's v2 engine.
- The parallel-block and ALiBi presets refused by the serving runner with
  JAX's v2 engine's text.

Tolerances are the training tests' (fp32: loss atol / rtol 1e-5, gradients
atol 1e-5 / rtol 1e-3, logits atol / rtol 1e-4 as the GPT-2 serving test):
the two frameworks sum the same products in other orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.engine_v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.sampling import SamplingParams as JSampling
from deepspeed_tpu.models import presets as jpresets
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.inference import model_runner
from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.sampling import SamplingParams
from deepspeed_tpu_torch.models import presets
from deepspeed_tpu_torch.models import transformer as tt
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-3)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)

_SMALL = dict(num_layers=2, vocab_size=512, max_seq_len=64)
# each added preset cut to 2 narrow layers; the query group, rotary dims,
# head dims 80 / 96 and every family switch stay
NARROW = {
    "llama2_7b": dict(hidden_size=128, intermediate_size=256, num_heads=4, num_kv_heads=4),
    "llama3_70b": dict(hidden_size=128, intermediate_size=256, num_heads=8, num_kv_heads=1),
    "mistral_7b": dict(hidden_size=128, intermediate_size=256, num_heads=8, num_kv_heads=2),
    "qwen2_7b": dict(hidden_size=112, intermediate_size=256, num_heads=7, num_kv_heads=1),
    "falcon_7b": dict(hidden_size=128, intermediate_size=256, num_heads=8, num_kv_heads=1,
                      head_dim=16),
    "gptj_6b": dict(hidden_size=256, intermediate_size=512, num_heads=2, num_kv_heads=2),
    "phi_2": dict(hidden_size=160, intermediate_size=320, num_heads=2, num_kv_heads=2),
    "gpt_neox_20b": dict(hidden_size=192, intermediate_size=384, num_heads=2, num_kv_heads=2),
    "bloom_7b1": dict(hidden_size=128, intermediate_size=256, num_heads=4, num_kv_heads=4),
    "opt_6_7b": dict(hidden_size=128, intermediate_size=256, num_heads=4, num_kv_heads=4),
    "tiny_parallel": {},
    "tiny_alibi": {},
}
SERVED = ("llama2_7b", "mistral_7b", "qwen2_7b", "opt_6_7b")
REFUSED = ("falcon_7b", "gptj_6b", "phi_2", "gpt_neox_20b", "bloom_7b1", "tiny_parallel",
           "tiny_alibi")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _pair(name, **over):
    """(JAX config, port config, JAX params as numpy) of ``name`` cut to
    ``NARROW[name]``, fp32."""
    over = {**_SMALL, **NARROW[name], **over} if name in NARROW else over
    jcfg = jpresets.get_preset(name, dtype=jnp.float32, **over)
    tcfg = presets.get_preset(name, dtype=torch.float32, **over)
    jp = jax.tree_util.tree_map(np.asarray, jt.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, tcfg, jp


def test_list_presets_is_jax_less_the_moe_presets():
    """Every JAX preset: the two MoE presets joined the port with its MoE
    layers (``tests/test_torch_moe.py`` holds them against JAX)."""
    assert presets.list_presets() == sorted(jpresets.list_presets())
    assert set(NARROW) | {"llama3_8b", "llama3_proxy_410m", "gpt2_small", "tiny",
                          "tiny_gpt2", "mixtral_8x7b", "tiny_moe"} == set(presets.list_presets())


@pytest.mark.parametrize("name", presets.list_presets())
def test_preset_fields_equal_jax(name):
    t, j = presets.get_preset(name), jpresets.get_preset(name)
    for f in dataclasses.fields(t):
        got, want = getattr(t, f.name), getattr(j, f.name)
        if f.name == "dtype":
            assert str(got).removeprefix("torch.") == jnp.dtype(want).name
        else:
            assert got == want, f.name
    only_jax = {f.name for f in dataclasses.fields(j)} - {f.name for f in dataclasses.fields(t)}
    for f in only_jax:  # the MoE knobs: the port's presets leave them at JAX's defaults
        assert getattr(j, f) == getattr(jt.TransformerConfig(), f), f
    assert t.param_count == j.param_count
    assert t.hd == j.hd


@pytest.mark.parametrize("name", sorted(NARROW))
def test_preset_cut_to_two_layers_trains_like_jax(name):
    jcfg, tcfg, jp = _pair(name)
    if name in ("phi_2", "gpt_neox_20b"):
        assert tcfg.hd == presets.get_preset(name).hd  # 80 / 96: the padded flash route
    tokens = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 25)).astype(np.int32)
    jtok = jnp.asarray(tokens)
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    ref_cfg = jcfg.replace(attn_impl="reference")
    # jitted: one compile each, not an op-by-op dispatch of the whole model
    jlogits = jax.jit(lambda p, t: jt.forward(p, t, ref_cfg)[0])(jparams, jtok[:, :-1])
    jloss, jgrads = jax.jit(jax.value_and_grad(jt.CausalLM(ref_cfg).loss_fn))(
        jparams, {"input_ids": jtok})
    port_attn = "reference" if tcfg.position == "alibi" else "flash"
    tcfg = tcfg.replace(attn_impl=port_attn)
    tp = tt.params_from_numpy(jp, tcfg, device="cpu")
    for leaf in _flat(tp).values():
        leaf.requires_grad_(True)
    ttok = torch.from_numpy(tokens).long()
    with torch.no_grad():
        logits = tt.forward(tp, ttok[:, :-1], tcfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **LOGIT_TOL)
    loss = tt.CausalLM(tcfg).loss_fn(tp, {"input_ids": ttok})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    fj, ft = _flat(jax.tree_util.tree_map(np.asarray, jgrads)), _flat(tp)
    assert set(fj) == set(ft)
    for key in fj:
        np.testing.assert_allclose(ft[key].grad.numpy(), fj[key], err_msg=key, **GRAD_TOL)


@pytest.mark.parametrize("name", SERVED)
def test_served_preset_is_token_identical_to_jax_v2(name):
    """put() of two packs and greedy step()s past a page boundary, then
    the scheduler with prefix caching, as the GPT-2 engine test."""
    jcfg, tcfg, jp = _pair(name)
    tp = tt.params_from_numpy(jp, tcfg, device="cpu")
    kw = dict(max_seqs=4, num_blocks=40, block_size=8, prefill_buckets=(32, 64),
              prefill_budget=32, enable_prefix_caching=True)
    je = JEngine(jax.tree_util.tree_map(jnp.asarray, jp), jcfg, **kw)
    te = InferenceEngineV2(tp, tcfg, device="cpu", **kw)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, tcfg.vocab_size, n).tolist() for n in (5, 21, 14)]
    assert te.put([1, 2, 3], prompts) == je.put([1, 2, 3], prompts)
    for _ in range(6):
        assert te.step(SamplingParams()) == je.step(JSampling())
    te.flush([1, 2, 3])
    je.flush([1, 2, 3])
    shared = rng.integers(1, tcfg.vocab_size, 24).tolist()
    for u in (4, 5):
        p = shared + rng.integers(1, tcfg.vocab_size, 6).tolist()
        te.scheduler.submit(u, p, SamplingParams(max_new_tokens=6))
        je.scheduler.submit(u, p, JSampling(max_new_tokens=6))
    assert te.scheduler.run() == je.scheduler.run()
    assert te.close() == je.close()


@pytest.mark.parametrize("name", REFUSED)
def test_unservable_preset_is_refused_with_jax_text(name):
    _, tcfg, _ = _pair(name)
    jcfg = jpresets.get_preset(name, dtype=jnp.float32)
    with pytest.raises(NotImplementedError) as port:
        model_runner._check_family(tcfg)
    with pytest.raises(NotImplementedError) as ref:
        JEngine(None, jcfg)
    jax_says = str(ref.value).split(" — ")[0].split(" yet")[0]
    assert " ".join(str(port.value).split()).startswith(" ".join(jax_says.split()))
