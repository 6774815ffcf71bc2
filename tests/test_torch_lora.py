"""LoRA (``deepspeed_tpu_torch/linear``) and the engine's trainable mask
against the JAX package, on the CPU.

JAX's ``LoRACausalLM.init_params(PRNGKey(0))`` tree goes through both
packages (``lora_params_from_numpy``).  The fp32 trajectory (base stored in
fp32, so that the merge rounds nothing) holds losses and adapters to the
engine tolerance of the training tests (atol 1e-5 / rtol 1e-4); the merge
and ``optimized_linear`` are one fp32 product each (atol 1e-6 / rtol
1e-5).  The masked optimizer state's bytes equal JAX's up to the step
counters, as the plain engine's do.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.linear import LoRACausalLM as JLoRA
from deepspeed_tpu.linear import LoRAConfig as JLoRAConfig
from deepspeed_tpu.linear import optimized_linear as j_optimized_linear
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.parallel.topology import initialize_mesh

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.config.config import ConfigError
from deepspeed_tpu_torch.linear import (LoRACausalLM, LoRAConfig, lora_params_from_numpy,
                                        optimized_linear)
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.presets import get_preset
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

ENGINE_TOL = dict(atol=1e-5, rtol=1e-4)
FN_TOL = dict(atol=1e-6, rtol=1e-5)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _config(**over):
    cfg = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "adamw", "params": {"lr": 1e-2, "weight_decay": 0.1}},
           "gradient_clipping": 0.5, "bf16": {"enabled": False}, "steps_per_print": 1000}
    cfg.update(over)
    return cfg


def _batches(n, seed=7):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, (2, 2, 17)).astype(np.int32)} for _ in range(n)]


def _jax_tree(r=4, base_dtype=jnp.float32, trained=True):
    """JAX's LoRA tree (fp32 tiny, a given base type); with ``trained``
    the adapters' b are made non-zero so that the merge is not the base."""
    jcfg = j_preset("tiny", dtype=jnp.float32)
    jmodel = JLoRA(jt.CausalLM(jcfg), JLoRAConfig(lora_r=r, base_dtype=base_dtype))
    tree = jmodel.init_params(jax.random.PRNGKey(0))
    if trained:
        rng = np.random.default_rng(1)
        tree["lora"] = {k: {"a": g["a"], "b": jnp.asarray(
            rng.normal(size=g["b"].shape).astype(np.float32) * 0.05)}
            for k, g in tree["lora"].items()}
    return jcfg, jmodel, tree


def _port_model(r=4, base_dtype=torch.float32, **over):
    tcfg = get_preset("tiny", dtype=torch.float32, attn_impl="flash", remat="selective", **over)
    return LoRACausalLM(tt.CausalLM(tcfg), LoRAConfig(lora_r=r, base_dtype=base_dtype))


def test_init_shapes_and_identity_at_b_zero():
    model = _port_model(base_dtype=torch.bfloat16)
    params = model.init_params(seed=0, device="cpu")
    _, _, jtree = _jax_tree(trained=False, base_dtype=jnp.bfloat16)
    assert set(params) == {"base", "lora"}
    assert set(params["lora"]) == set(jtree["lora"])  # JAX's dotted keys
    for key, g in params["lora"].items():
        assert tuple(g["a"].shape) == tuple(jtree["lora"][key]["a"].shape)
        assert tuple(g["b"].shape) == tuple(jtree["lora"][key]["b"].shape)
        assert g["a"].dtype == g["b"].dtype == torch.float32
        assert float(g["b"].abs().max()) == 0.0
    for leaf in _flat(params["base"]).values():
        assert leaf.dtype == torch.bfloat16
    merged, base = _flat(model.merge(params)), _flat(params["base"])
    for key in base:
        assert torch.equal(merged[key], base[key]), key


def test_merge_and_export_equal_jax():
    jcfg, jmodel, jtree = _jax_tree()
    want = _flat(jax.tree_util.tree_map(np.asarray, jmodel.export_merged(jtree)))
    model = _port_model()
    got = _flat(model.export_merged(lora_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jtree), device="cpu")))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key], err_msg=key, **FN_TOL)
    # the merged tree runs in the plain model with the LoRA loss
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 17)).astype(np.int32))
    port = lora_params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree), device="cpu")
    l_lora = model.loss_fn(port, {"input_ids": tokens})
    l_plain = model.inner.loss_fn(model.export_merged(port), {"input_ids": tokens})
    assert l_lora.item() == l_plain.item()


def test_optimized_linear_equals_jax():
    rng = np.random.default_rng(3)
    x, w, a, b = (rng.normal(size=s).astype(np.float32)
                  for s in ((4, 16), (16, 8), (16, 2), (2, 8)))
    want = j_optimized_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(a), jnp.asarray(b),
                              scale=0.5)
    got = optimized_linear(*(torch.from_numpy(t) for t in (x, w, a, b)), scale=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)
    np.testing.assert_allclose(optimized_linear(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
                               x @ w, **FN_TOL)


def _engines(jtree, jmodel, **over):
    jengine, _, _, _ = jds.initialize(
        model=jmodel, params=jtree, config=_config(**over),
        mesh=initialize_mesh(devices=jax.devices()[:1], data=1))
    model = _port_model()
    engine, _, _, _ = tds.initialize(
        model=model, params=lora_params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree),
                                                   device="cpu"),
        config=_config(**over), device="cpu")
    return jengine, engine


def test_fp32_trajectory_matches_jax():
    """Adam's eps is 1e-4 here: the adapters' ``a`` get an exactly zero
    gradient while ``b`` is 0 and then tiny ones, which ``m / (sqrt(v) +
    eps)`` at eps 1e-8 magnifies from fp32 summation noise into lr-sized
    steps of either sign (the block-sparse trajectory test's reason)."""
    _, jmodel, jtree = _jax_tree(trained=False)
    jengine, engine = _engines(jtree, jmodel, optimizer={
        "type": "adamw", "params": {"lr": 1e-2, "weight_decay": 0.1, "eps": 1e-4}})
    batches = _batches(5)
    j_losses = [float(jengine.train_batch(b)) for b in batches]
    t_losses = [float(engine.train_batch(b)) for b in batches]
    np.testing.assert_allclose(t_losses, j_losses, **ENGINE_TOL)
    np.testing.assert_allclose(engine.get_global_grad_norm(), jengine.get_global_grad_norm(),
                               **ENGINE_TOL)
    fj = _flat(jax.tree_util.tree_map(np.asarray, jengine.state.params))
    ft = _flat(engine.params)
    assert set(fj) == set(ft)
    for key in fj:
        np.testing.assert_allclose(ft[key].detach().numpy(), fj[key], err_msg=key, **ENGINE_TOL)
    assert all(float(g["b"].detach().abs().max()) > 0 for g in engine.params["lora"].values())


def test_base_frozen_without_fp32_masters_or_gradients():
    model = _port_model(base_dtype=torch.bfloat16)
    params = model.init_params(seed=0, device="cpu")
    base_before = {k: v.clone() for k, v in _flat(params["base"]).items()}
    engine, _, _, _ = tds.initialize(model=model, params=params, config=_config(), device="cpu")
    for b in _batches(3):
        engine.train_batch(b)
    n_lora = sum(t.numel() for t in _flat(params["lora"]).values())
    assert engine._masters.flat.numel() == n_lora  # K8's buffer: the adapters alone
    assert engine._masters.grad.numel() == n_lora
    held = {id(t) for t in engine._params_list}
    for key, leaf in _flat(engine.params["base"]).items():
        assert leaf.dtype == torch.bfloat16 and not leaf.requires_grad and leaf.grad is None
        assert id(leaf) not in held
        assert torch.equal(leaf, base_before[key]), key  # weight decay never reached it
    assert any(float(g["b"].detach().abs().max()) > 0 for g in engine.params["lora"].values())
    assert engine._trainable_paths == [f"lora/{k}/{ab}" for k in params["lora"]
                                       for ab in ("a", "b")]


def test_masked_state_bytes_equal_jax():
    _, jmodel, jtree = _jax_tree(trained=False, base_dtype=jnp.bfloat16)
    jengine, _, _, _ = jds.initialize(
        model=jmodel, params=jtree, config=_config(),
        mesh=initialize_mesh(devices=jax.devices()[:1], data=1))
    model = _port_model(base_dtype=torch.bfloat16)
    engine, _, _, _ = tds.initialize(
        model=model, params=lora_params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree),
                                                   device="cpu"),
        config=_config(), device="cpu")
    got = engine.memory_breakdown()
    want = jengine.memory_breakdown()
    n_lora = sum(x.size for x in jax.tree_util.tree_leaves(jtree["lora"]))
    assert got["opt_state_bytes"] == 2 * 4 * n_lora + 4
    assert abs(got["opt_state_bytes"] - want["opt_state_bytes"]) <= 32
    assert got["master_params_bytes"] == want["master_params_bytes"]


def test_save_load_resume_equals_the_uninterrupted_run(tmp_path):
    batches = _batches(4, seed=11)

    def engine():
        model = _port_model(base_dtype=torch.bfloat16)
        return tds.initialize(model=model, params=model.init_params(seed=0, device="cpu"),
                              config=_config(), device="cpu")[0]

    ref = engine()
    ref_losses = [float(ref.train_batch(b)) for b in batches]
    a = engine()
    for b in batches[:2]:
        a.train_batch(b)
    a.save_checkpoint(str(tmp_path), tag="t2")
    names = os.listdir(tmp_path / "t2" / "state")
    assert names  # the frozen base rides params/, the moments the adapters alone
    b_ = engine()
    b_.load_checkpoint(str(tmp_path), tag="t2")
    losses = [float(b_.train_batch(b)) for b in batches[2:]]
    assert losses == ref_losses[2:]
    for key, leaf in _flat(ref.params).items():
        assert torch.equal(_flat(b_.params)[key], leaf), key


def test_offload_with_a_trainable_mask_is_refused():
    model = _port_model()
    with pytest.raises(NotImplementedError, match="trainable mask"):
        tds.initialize(model=model, params=model.init_params(seed=0, device="cpu"),
                       config=_config(zero_optimization={"stage": 2,
                                                         "offload_optimizer": "cpu"}),
                       device="cpu")


def test_activation_quantization_on_a_wrapped_model_is_refused():
    aq = {"activation_quantization": {
        "shared_parameters": {"enabled": True, "quantization_type": "symmetric"},
        "different_groups": {"aq1": {"params": {"bits": 8}, "modules": [".*"]}}}}
    model = _port_model()
    with pytest.raises(ConfigError, match="activation_quantization"):
        tds.initialize(model=model, params=model.init_params(seed=0, device="cpu"),
                       config=_config(compression_training=aq), device="cpu")
    assert model.cfg.act_quant_bits is None
