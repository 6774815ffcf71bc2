"""The port's progressive layer drop against the JAX package, on the CPU.

- The theta schedule equals JAX's (``update_state`` exactly; ``theta_at``
  against JAX's traced fp32 value within 1e-6 relative).
- Forward and gradients under JAX's own mask (``layer_keep_mask(fold_in(
  rng, 0x91D), L, theta)``, which JAX's ``CausalLM.loss_fn`` draws from a
  batch's ``pld_theta``), passed to the port as ``layer_keep``: the loss
  and every gradient within JAX's fp32 tolerances of
  ``test_torch_training.py`` (loss atol / rtol 1e-5, gradients atol 1e-5 /
  rtol 1e-3); a dropped layer's weights get exactly zero gradient in both.
- The port's draw keeps layer 0 and is a pure function of (seed, step,
  micro-batch); a dropped layer launches nothing (its attention and MLP
  never run); the engine's steps draw a mask a micro-batch and two engines
  of one seed train the same bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.runtime import progressive_layer_drop as jpld

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.config.config import parse_config
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.runtime import progressive_layer_drop as tpld
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-3)
LAYERS = 4


def test_theta_schedule_equals_jax():
    j, t = jpld.ProgressiveLayerDrop(0.5, 0.01), tpld.ProgressiveLayerDrop(0.5, 0.01)
    assert t.get_state() == j.get_state()
    for step in (0, 1, 7, 100, 5000):
        assert t.update_state(step) == j.update_state(step)
        assert t.get_state() == j.get_state()
        np.testing.assert_allclose(t.theta_at(step), float(j.theta_at(step)), rtol=1e-6)
    cfg = parse_config({"progressive_layer_drop": {"enabled": True}})
    assert (cfg.progressive_layer_drop.theta, cfg.progressive_layer_drop.gamma) == (0.5, 0.001)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _jax_mask(rng, theta):
    return np.array(jpld.layer_keep_mask(jax.random.fold_in(rng, 0x91D), LAYERS, theta))


@pytest.mark.parametrize("remat", ["selective", "full"])
def test_loss_and_grads_under_jaxs_mask_match(remat):
    jcfg = j_preset("tiny", dtype=jnp.float32, num_layers=LAYERS)
    jp = jax.tree_util.tree_map(np.asarray, jt.init_params(jax.random.PRNGKey(0), jcfg))
    tokens = np.random.default_rng(1).integers(0, 256, (2, 33)).astype(np.int32)
    theta = 0.5
    rng = next(jax.random.PRNGKey(s) for s in range(100)
               if 0 < _jax_mask(jax.random.PRNGKey(s), theta)[1:].sum() < LAYERS - 1)
    mask = _jax_mask(rng, theta)
    jloss, jgrads = jax.jit(jax.value_and_grad(jt.CausalLM(jcfg).loss_fn))(
        jax.tree_util.tree_map(jnp.asarray, jp),
        {"input_ids": jnp.asarray(tokens), "pld_theta": jnp.float32(theta)}, rng)
    tcfg = get_preset("tiny", dtype=torch.float32, num_layers=LAYERS, attn_impl="flash",
                      remat=remat)
    tp = tt.params_from_numpy(jp, tcfg, device="cpu")
    leaves = _flat(tp)
    for v in leaves.values():
        v.requires_grad_(True)
    tloss = tt.CausalLM(tcfg).loss_fn(tp, {"input_ids": torch.as_tensor(tokens),
                                           "layer_keep": torch.as_tensor(mask)})
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), **LOSS_TOL)
    jg = _flat(jax.tree_util.tree_map(np.asarray, jgrads))
    for key, v in leaves.items():
        np.testing.assert_allclose(v.grad.numpy(), jg[key], err_msg=key, **GRAD_TOL)
    dropped = int(np.flatnonzero(mask == 0)[0])
    wq = leaves["layers/attn/wq"].grad[dropped]
    assert torch.count_nonzero(wq) == 0 and not np.any(jg["layers/attn/wq"][dropped])


def test_port_draw_keeps_layer_0_and_is_pure():
    for step in range(20):
        keep = tpld.layer_keep_mask(tpld.pld_generator(3, step, 1), 8, 0.0)
        assert keep.dtype == torch.bool and keep.tolist() == [True] + [False] * 7
    a = tpld.layer_keep_mask(tpld.pld_generator(3, 5, 0), 64, 0.5)
    assert torch.equal(a, tpld.layer_keep_mask(tpld.pld_generator(3, 5, 0), 64, 0.5))
    assert not torch.equal(a, tpld.layer_keep_mask(tpld.pld_generator(3, 5, 1), 64, 0.5))
    assert tpld.layer_keep_mask(torch.Generator().manual_seed(0), 5, 1.0).all()


def test_a_dropped_layer_runs_nothing(monkeypatch):
    cfg = get_preset("tiny", dtype=torch.float32, num_layers=LAYERS, attn_impl="flash",
                     remat="selective")
    params = tt.init_params(cfg, device="cpu")
    calls = {"attend": 0, "mlp": 0}
    attend, mlp = tt._attend, tt.mlp_block

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tt, "_attend", count("attend", attend))
    monkeypatch.setattr(tt, "mlp_block", count("mlp", mlp))
    tok = torch.zeros(1, 9, dtype=torch.long)
    keep = torch.tensor([True, False, True, False])
    full = tt.forward(params, tok, cfg)
    assert calls == {"attend": LAYERS, "mlp": LAYERS}
    out = tt.forward(params, tok, cfg, layer_keep=keep)
    assert calls == {"attend": LAYERS + 2, "mlp": LAYERS + 2}
    two = tt.forward({**params, "layers": {k: {n: v[[0, 2]] for n, v in d.items()}
                                           for k, d in params["layers"].items()}},
                     tok, cfg.replace(num_layers=2))
    torch.testing.assert_close(out, two, rtol=0, atol=0)  # the kept layers, nothing else
    assert not torch.equal(out, full)
    with pytest.raises(ValueError, match="3 entries for 4 layers"):
        tt.forward(params, tok, cfg, layer_keep=[1, 1, 0])


def _engine(seed=7, **pld):
    cfg = get_preset("tiny", dtype=torch.float32, num_layers=LAYERS, attn_impl="flash",
                     remat="selective")
    conf = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
            "bf16": {"enabled": False}, "seed": seed,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
            "progressive_layer_drop": {"enabled": True, "theta": 0.3, "gamma": 0.5, **pld}}
    eng, _, _, _ = tds.initialize(model=tt.CausalLM(cfg), config=conf, device="cpu")
    return eng


def test_engine_draws_a_mask_a_micro_batch_from_the_schedule():
    a, b = _engine(), _engine()
    batch = {"input_ids": np.random.default_rng(0).integers(0, 256, (2, 2, 17))}
    masks, losses = [], []
    for step in range(4):
        losses.append(float(a.train_batch(batch)))
        masks.append([m.tolist() for m in a.pld_masks])
        assert float(b.train_batch(batch)) == losses[-1]
        assert [m.tolist() for m in b.pld_masks] == masks[-1]
        want = [tpld.layer_keep_mask(tpld.pld_generator(7, step + 1, i), LAYERS,
                                     a.progressive_layer_drop.theta_at(step)).tolist()
                for i in range(2)]
        assert masks[-1] == want
    assert masks[0] == [[True] * LAYERS] * 2  # theta(0) = 1: the first step keeps all
    assert any(not all(m) for ms in masks[1:] for m in ms)
    assert all(m[0] for ms in masks for m in ms)
    assert a.progressive_layer_drop.get_theta() == a.progressive_layer_drop.theta_at(4)
    assert torch.equal(a._masters.flat, b._masters.flat)


def test_forward_api_draws_the_mask_of_its_micro_batch():
    a, b = _engine(), _engine()
    batch = {"input_ids": np.random.default_rng(0).integers(0, 256, (2, 2, 17))}
    a.train_batch(batch)
    for i in range(2):
        b.backward(b.forward({"input_ids": batch["input_ids"][i]}))
    b.step()
    assert [m.tolist() for m in a.pld_masks][1] == [m.tolist() for m in b.pld_masks][0]
    torch.testing.assert_close(a._masters.flat, b._masters.flat, rtol=0, atol=1e-7)
