"""Mixtral-style MoE in the port (``deepspeed_tpu_torch/moe``, the MoE branch
of ``models/transformer.py``, serving, HF import / export, checkpoints and
the ``moe`` config section) against the JAX package on the CPU, fp32.
Inputs come from numpy seeds, weights from JAX ``init_params(PRNGKey(0))``
through ``params_from_numpy``.

- ``topk_gating`` for k 1 / 2 / 3, with and without drops, a
  ``min_capacity`` floor, renormalisation on and off, ties, and random
  token priority with JAX's ``jax.random.permutation`` passed in: the
  port's index-form routing rebuilt as JAX's dense combine tensor
  (``GatingResult.combine``) equals JAX's, and so do the aux loss, the
  expert counts and the dropped fraction (``FN_TOL``);
- ``moe_block``'s value and every gradient against ``jax.value_and_grad``
  (``GRAD_TOL``), ``moe_block_dropless``, and the ``MoE`` module over a
  user's expert function;
- ``tiny_moe``: ``loss_fn`` and every gradient under each remat policy
  (``LOSS_TOL`` / ``GRAD_TOL``), and a 5-step engine trajectory per
  optimizer with ``remat="full"`` against the JAX engine on a one-device
  mesh (``ENGINE_TOL``); ``chip_smoke.RoutePin``, which pins the CPU
  reference to the card's expert choices, replays them exactly;
- v2 serving on ``tiny_moe``: plain, int8 and a ``step_n`` burst,
  token-identical to JAX's v2 engine; the port's v2 equal to its v1 (JAX
  ``test_v2_moe_matches_v1_dense``);
- Mixtral HF export byte-identical to JAX's, both importers on both
  files, and ``init_inference(model=dir)`` serving JAX's tokens;
- a MoE save / resume that is bit-exact;
- the ``moe`` config section parsed as JAX parses it; pipeline stages
  beside the expert axis refused naming item 7 (the expert axis itself
  runs across ranks, ``tests/test_torch_expert.py``).
"""
import dataclasses
import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.checkpoint import hf_import as jhf
from deepspeed_tpu.config.config import parse_config as j_parse_config
from deepspeed_tpu.inference.engine import init_inference as j_init_inference
from deepspeed_tpu.inference.engine_v2 import InferenceEngineV2 as JEngineV2
from deepspeed_tpu.inference.sampling import SamplingParams as JSampling
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.moe import layer as jlayer
from deepspeed_tpu.moe import sharded_moe as jgate
from deepspeed_tpu.parallel.topology import initialize_mesh

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.checkpoint import hf_import as thf
from deepspeed_tpu_torch.checkpoint import saving
from deepspeed_tpu_torch.config.config import parse_config
from deepspeed_tpu_torch.inference import init_inference
from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
from deepspeed_tpu_torch.inference.sampling import SamplingParams
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.moe import MoE, layer as tlayer, sharded_moe as tgate
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

FN_TOL = dict(atol=1e-6, rtol=1e-5)
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-3)
ENGINE_TOL = dict(atol=1e-5, rtol=1e-4)  # test_torch_training.py's


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture(scope="module")
def tiny_moe():
    """(jcfg, jax params as numpy, tcfg) for ``tiny_moe`` in fp32."""
    jcfg = j_preset("tiny_moe", dtype=jnp.float32)
    jp = jax.tree_util.tree_map(np.asarray, jt.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, jp, get_preset("tiny_moe", dtype=torch.float32)


# ---------------------------------------------------------------------------
# (a) gating
# ---------------------------------------------------------------------------
# (tokens, experts, k, capacity_factor, min_capacity, normalize)
GATING_CASES = {
    "k1_no_drop": (32, 4, 1, 4.0, 4, True),
    "k1_drops": (64, 4, 1, 0.5, 1, True),
    "k2_no_drop": (48, 8, 2, 4.0, 4, True),
    "k2_drops": (96, 8, 2, 0.6, 2, True),
    "k2_drops_unnormalized": (96, 8, 2, 0.6, 2, False),
    "k2_min_capacity_floor": (16, 8, 2, 0.25, 9, True),
    "k3_drops": (80, 6, 3, 0.7, 1, True),
    "k3_no_drop_unnormalized": (40, 6, 3, 5.0, 4, False),
}


def _same_gating(got: tgate.GatingResult, want: jgate.GatingResult):
    np.testing.assert_allclose(got.combine().numpy(), np.asarray(want.combine), **FN_TOL)
    np.testing.assert_array_equal(got.combine().numpy() > 0, np.asarray(want.dispatch))
    np.testing.assert_allclose(got.aux_loss.item(), float(want.aux_loss), **FN_TOL)
    np.testing.assert_array_equal(got.expert_counts.numpy(), np.asarray(want.expert_counts))
    np.testing.assert_allclose(got.dropped_fraction.item(), float(want.dropped_fraction),
                               **FN_TOL)


@pytest.mark.parametrize("case", sorted(GATING_CASES))
def test_topk_gating_matches_jax(case):
    n, e, k, cf, mc, norm = GATING_CASES[case]
    logits = np.random.default_rng(n + e + k).standard_normal((n, e)).astype(np.float32)
    want = jgate.topk_gating(jnp.asarray(logits), k, cf, min_capacity=mc,
                             normalize_weights=norm)
    got = tgate.topk_gating(torch.from_numpy(logits), k, cf, min_capacity=mc,
                            normalize_weights=norm)
    assert got.capacity == jgate.capacity_for(n, e, k, cf, mc)
    _same_gating(got, want)
    if "drops" in case:
        assert got.dropped_fraction.item() > 0
    elif "no_drop" in case:
        assert got.dropped_fraction.item() == 0


@pytest.mark.parametrize("k", [1, 2])
def test_random_token_priority_with_jax_permutation(k):
    """JAX's permutation of the token order, passed to the port's private
    helper, gives JAX's routing; the public entry draws its order from a
    ``torch.Generator`` (a permutation of the tokens, so the counts and
    the aux loss do not depend on it)."""
    n, e = 64, 4
    logits = np.random.default_rng(11).standard_normal((n, e)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jgate.topk_gating(jnp.asarray(logits), k, 0.5, min_capacity=1, rng=key,
                             random_token_priority=True)
    order = torch.from_numpy(np.array(jax.random.permutation(key, n)))
    got = tgate._gating(torch.from_numpy(logits), k, 0.5, 1, True, order)
    _same_gating(got, want)
    plain = tgate.topk_gating(torch.from_numpy(logits), k, 0.5, min_capacity=1)
    assert not torch.equal(got.combine(), plain.combine())  # the order matters
    drawn = tgate.topk_gating(torch.from_numpy(logits), k, 0.5, min_capacity=1,
                              generator=torch.Generator().manual_seed(0),
                              random_token_priority=True)
    assert torch.equal(drawn.expert_counts, got.expert_counts)
    assert drawn.aux_loss.item() == pytest.approx(got.aux_loss.item())
    with pytest.raises(ValueError, match="generator"):
        tgate.topk_gating(torch.from_numpy(logits), k, random_token_priority=True)


def test_ties_take_the_lower_expert_like_jax_top_k():
    """Equal router probabilities pick the lower expert index first, as
    ``jax.lax.top_k`` does; the top-1 helper too."""
    rng = np.random.default_rng(2)
    logits = rng.integers(-2, 3, (64, 8)).astype(np.float32)  # many exact ties
    for k in (1, 2, 3):
        _same_gating(tgate.topk_gating(torch.from_numpy(logits), k, 2.0),
                     jgate.topk_gating(jnp.asarray(logits), k, 2.0))
        vals, idx = tgate.top_k(torch.from_numpy(logits), k)
        jvals, jidx = jax.lax.top_k(jnp.asarray(logits), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    _same_gating(tgate.top1_gating(torch.from_numpy(logits)),
                 jgate.top1_gating(jnp.asarray(logits)))


# ---------------------------------------------------------------------------
# (b) the layer
# ---------------------------------------------------------------------------
def _layer_weights(d=32, f=48, e=4, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"router": ((d, e), d), "w_gate": ((e, d, f), d), "w_up": ((e, d, f), d),
              "w_down": ((e, f, d), f)}
    return {k: (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
            for k, (shape, fan_in) in shapes.items()}


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cf1.25", "cf0.5_drops"])
def test_moe_block_value_and_grads_match_jax(cf):
    jcfg = j_preset("tiny_moe", dtype=jnp.float32, moe_capacity_factor=cf)
    tcfg = get_preset("tiny_moe", dtype=torch.float32, moe_capacity_factor=cf)
    lw = _layer_weights()
    x = np.random.default_rng(1).standard_normal((3, 16, 32)).astype(np.float32)

    def jloss(lw, x):
        out, aux = jlayer.moe_block(lw, x, jcfg)
        return jnp.sum(jnp.sin(out)) + 3.0 * aux

    (jv, (jg_lw, jg_x)) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jax.tree_util.tree_map(jnp.asarray, lw), jnp.asarray(x))
    tlw = {k: torch.from_numpy(v).requires_grad_(True) for k, v in lw.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = tlayer.moe_block(tlw, tx, tcfg)
    tv = torch.sin(out).sum() + 3.0 * aux
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), **LOSS_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg_x), **GRAD_TOL)
    for k in lw:
        np.testing.assert_allclose(tlw[k].grad.numpy(), np.asarray(jg_lw[k]), err_msg=k,
                                   **GRAD_TOL)


def test_moe_block_dropless_matches_jax():
    jcfg = j_preset("tiny_moe", dtype=jnp.float32, moe_top_k=3)
    tcfg = get_preset("tiny_moe", dtype=torch.float32, moe_top_k=3)
    lw = _layer_weights(seed=4)
    x = np.random.default_rng(5).standard_normal((2, 9, 32)).astype(np.float32)
    want, jaux = jlayer.moe_block_dropless(jax.tree_util.tree_map(jnp.asarray, lw),
                                           jnp.asarray(x), jcfg)
    got, aux = tlayer.moe_block_dropless({k: torch.from_numpy(v) for k, v in lw.items()},
                                         torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)
    assert aux.item() == float(jaux) == 0.0


def test_moe_module_with_a_user_expert_fn_matches_jax():
    """``MoE`` vmaps a user's expert function over the stacked expert
    parameters (a dict) and routes top-2 with drops."""
    rng = np.random.default_rng(6)
    e, d, f = 4, 16, 24
    ep = {"w1": (rng.standard_normal((e, d, f)) / 4).astype(np.float32),
          "w2": (rng.standard_normal((e, f, d)) / 5).astype(np.float32)}
    router = rng.standard_normal((d, e)).astype(np.float32)
    x = rng.standard_normal((2, 20, d)).astype(np.float32)
    jmoe = jlayer.MoE(d, lambda p, t: jnp.tanh(t @ p["w1"]) @ p["w2"], e, k=2,
                      capacity_factor=0.75, min_capacity=2)
    want, jaux = jmoe(jnp.asarray(router), jax.tree_util.tree_map(jnp.asarray, ep),
                      jnp.asarray(x))
    tmoe = MoE(d, lambda p, t: torch.tanh(t @ p["w1"]) @ p["w2"], e, k=2,
               capacity_factor=0.75, min_capacity=2)
    got, aux = tmoe(torch.from_numpy(router), {k: torch.from_numpy(v) for k, v in ep.items()},
                    torch.from_numpy(x))
    assert isinstance(tmoe, torch.nn.Module)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **FN_TOL)


def test_router_product_is_true_fp32(monkeypatch):
    """The router's product runs at full fp32 precision whatever the
    process-wide matmul precision says, and leaves that setting as it was."""
    old = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        seen = []
        real = torch.Tensor.__matmul__

        def spy(a, b):
            seen.append(torch.get_float32_matmul_precision())
            return real(a, b)

        monkeypatch.setattr(torch.Tensor, "__matmul__", spy)
        tlayer.router_logits(torch.ones(3, 4), torch.ones(4, 2))
        assert seen == ["highest"]
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(old)


# ---------------------------------------------------------------------------
# (c) the model and the engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny_moe_jax_grads(tiny_moe):
    """JAX's loss and gradients on ``tiny_moe`` (jitted), once for every
    remat case of the port."""
    jcfg, jp, _ = tiny_moe
    tokens = np.random.default_rng(3).integers(0, 256, (2, 25)).astype(np.int32)
    jloss, jgrads = jax.jit(jax.value_and_grad(jt.CausalLM(jcfg).loss_fn))(
        jax.tree_util.tree_map(jnp.asarray, jp), {"input_ids": jnp.asarray(tokens)})
    return tokens, jloss, jgrads


@pytest.mark.parametrize("remat", ["none", "full", "selective", "dots", "offload"])
def test_tiny_moe_loss_and_grads_match_jax(tiny_moe, tiny_moe_jax_grads, remat):
    jcfg, jp, tcfg = tiny_moe
    tokens, jloss, jgrads = tiny_moe_jax_grads
    tp = tt.params_from_numpy(jp, tcfg, device="cpu")
    for leaf in _flat(tp).values():
        leaf.requires_grad_(True)
    loss = tt.CausalLM(tcfg.replace(remat=remat)).loss_fn(
        tp, {"input_ids": torch.from_numpy(tokens)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    fj, ft = _flat(jax.tree_util.tree_map(np.asarray, jgrads)), _flat(tp)
    assert set(fj) == set(ft) and any(k.startswith("layers/moe/") for k in ft)
    for key in fj:
        np.testing.assert_allclose(ft[key].grad.numpy(), fj[key], err_msg=key, **GRAD_TOL)


def test_moe_forward_aux_and_init_params_match_jax(tiny_moe):
    """``forward(with_aux=True)``'s summed aux equals JAX's third output;
    the port's ``init_params`` lays the experts out as JAX does, and
    ``param_count`` counts them as JAX does."""
    jcfg, jp, tcfg = tiny_moe
    tokens = np.random.default_rng(8).integers(0, 256, (2, 12)).astype(np.int32)
    jlogits, _, jaux = jt.forward(jax.tree_util.tree_map(jnp.asarray, jp),
                                  jnp.asarray(tokens), jcfg)
    tp = tt.params_from_numpy(jp, tcfg, device="cpu")
    logits, cache, aux = tt.forward(tp, torch.from_numpy(tokens).long(), tcfg, with_aux=True)
    assert cache is None
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **LOSS_TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **FN_TOL)
    mine = _flat(tt.init_params(tcfg, device="cpu", dtype=torch.float32))
    theirs = _flat(jp)
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: tuple(v.shape) for k, v in theirs.items()}
    assert tcfg.param_count == jcfg.param_count
    assert get_preset("mixtral_8x7b").param_count == j_preset("mixtral_8x7b").param_count


def _engine_config(opt):
    return {
        "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
        "optimizer": opt,
        "scheduler": {"type": "WarmupCosineLR",
                      "params": {"total_num_steps": 6, "warmup_num_steps": 2, "lr": 3e-3}},
        "gradient_clipping": 0.5, "bf16": {"enabled": False}, "steps_per_print": 1000,
    }


ENGINE_OPTIMIZERS = {  # test_torch_training.py's
    "adamw": {"type": "adamw", "params": {"weight_decay": 0.1}},
    "lamb": {"type": "lamb", "params": {"weight_decay": 0.1}},
    "lion": {"type": "lion", "params": {"weight_decay": 0.1}},
    "adagrad": {"type": "adagrad", "params": {}},
    "muon": {"type": "muon", "params": {}},
}


@pytest.mark.parametrize("opt", sorted(ENGINE_OPTIMIZERS))
def test_moe_engine_trajectory_matches_jax_engine(tiny_moe, opt):
    """Five steps of ``train_batch`` on ``tiny_moe`` under ``remat="full"``
    (the Mixtral preset's policy): losses (the aux term included), the
    grad norm and every parameter against the JAX engine."""
    jcfg, jp, tcfg = tiny_moe
    conf = _engine_config(ENGINE_OPTIMIZERS[opt])
    rng = np.random.default_rng(7)
    batches = [{"input_ids": rng.integers(0, 256, (2, 2, 17)).astype(np.int32)}
               for _ in range(5)]
    jengine, _, _, _ = jds.initialize(
        model=jt.CausalLM(jcfg.replace(remat="full")),
        params=jax.tree_util.tree_map(jnp.asarray, jp), config=conf,
        mesh=initialize_mesh(devices=jax.devices()[:1], data=1))
    j_losses = [float(jengine.train_batch(b)) for b in batches]
    tcfg = tcfg.replace(remat="full", attn_impl="flash")
    engine, _, _, _ = tds.initialize(model=tt.CausalLM(tcfg),
                                     params=tt.params_from_numpy(jp, tcfg, device="cpu"),
                                     config=conf, device="cpu")
    t_losses = [float(engine.train_batch(b)) for b in batches]
    np.testing.assert_allclose(t_losses, j_losses, **ENGINE_TOL)
    np.testing.assert_allclose(engine.get_global_grad_norm(), jengine.get_global_grad_norm(),
                               **ENGINE_TOL)
    fj = _flat(jax.tree_util.tree_map(np.asarray, jengine.state.params))
    ft = _flat(engine.params)
    assert set(fj) == set(ft)
    flipped = 0
    for key in fj:
        got = ft[key].detach().numpy()
        if opt != "lion":
            np.testing.assert_allclose(got, fj[key], err_msg=key, **ENGINE_TOL)
            continue
        # Lion steps by sign(c) * lr: where c is ~0 (fp32 summation noise),
        # the two packages may step differently, by at most one step of
        # the peak lr at that entry
        off = ~np.isclose(got, fj[key], **ENGINE_TOL)
        assert np.all(np.abs(got - fj[key])[off] <= 2 * LION_PEAK_LR + 1e-6), key
        flipped += int(off.sum())
    assert flipped <= 2


LION_PEAK_LR = 3e-3  # _engine_config's


def test_moe_save_and_resume_is_bitwise(tiny_moe, tmp_path):
    """Two steps, save, two more; a fresh engine loads the save and takes
    the same two steps: the losses and every byte of the state agree."""
    _, jp, tcfg = tiny_moe
    conf = _engine_config(ENGINE_OPTIMIZERS["adamw"])
    rng = np.random.default_rng(9)
    batches = [{"input_ids": rng.integers(0, 256, (2, 2, 17)).astype(np.int32)}
               for _ in range(4)]

    def engine():
        e, _, _, _ = tds.initialize(model=tt.CausalLM(tcfg),
                                    params=tt.params_from_numpy(jp, tcfg, device="cpu"),
                                    config=conf, device="cpu")
        return e

    def state(e):
        return {k: v.detach().reshape(-1).view(torch.uint8).numpy().tobytes()
                for k, v in saving.train_state(e).items()}

    a = engine()
    for b in batches[:2]:
        a.train_batch(b)
    a.save_checkpoint(str(tmp_path), tag="moe")
    want = [float(a.train_batch(b)) for b in batches[2:]]
    c = engine()
    c.load_checkpoint(str(tmp_path))
    assert any(k.startswith("params/layers/moe") or "moe" in k for k in state(c))
    got = [float(c.train_batch(b)) for b in batches[2:]]
    assert got == want
    assert state(c) == state(a)


def test_route_pin_replays_the_recorded_experts_and_slots(tiny_moe):
    """``chip_smoke.RoutePin``, which holds the card's bf16 MoE runs against
    the CPU on the card's expert choices: a replay on the same weights
    changes nothing; on a perturbed router the replay takes the recorded
    experts and slots (the gate's counts and dropped fraction are the
    recorded run's, not the perturbed run's own), the weights from its own
    probabilities, and counts the tokens whose choices moved."""
    import chip_smoke

    _, jp, tcfg = tiny_moe
    params = tt.params_from_numpy(jp, tcfg, device="cpu")
    batch = {"input_ids": torch.from_numpy(
        np.random.default_rng(4).integers(0, 256, (2, 33)))}

    def run(p):
        tlayer.GATE_STATS = []
        try:
            loss = float(tt.CausalLM(tcfg).loss_fn(p, batch))
        finally:
            stats, tlayer.GATE_STATS = tlayer.GATE_STATS, None
        return loss, [(g["expert_counts"].tolist(), float(g["dropped_fraction"]))
                      for g in stats]

    pin = chip_smoke.RoutePin()
    with pin.record():
        loss0, gates0 = run(params)
    with pin.replay():
        assert run(params) == (loss0, gates0)
    assert pin.summary() == dict(routed_calls=2, token_choices=128, tokens_moved=0,
                                 tokens_reordered=0)
    moe = dict(params["layers"]["moe"])
    moe["router"] = moe["router"] + 0.5 * torch.randn(
        moe["router"].shape, generator=torch.Generator().manual_seed(5))
    bent = dict(params, layers=dict(params["layers"], moe=moe))
    loss_own, gates_own = run(bent)
    again = chip_smoke.RoutePin()
    again.calls = pin.calls
    with again.replay():
        loss_pinned, gates_pinned = run(bent)
    assert gates_pinned == gates0 != gates_own
    assert loss_pinned not in (loss0, loss_own)
    assert again.summary()["tokens_moved"] > 0


# ---------------------------------------------------------------------------
# (d) serving
# ---------------------------------------------------------------------------
V2_KW = dict(max_seqs=4, num_blocks=32, block_size=16, prefill_buckets=(16, 32, 64))
V2_PROMPTS = [[3, 4, 5, 6, 7], [9, 8, 7], list(range(10, 31))]


@pytest.mark.parametrize("quant", [None, "int8"], ids=["bf16_tree", "int8"])
def test_v2_serving_is_token_identical_to_jax(tiny_moe, quant):
    """put(), four per-tick steps and a 6-tick ``step_n`` burst: the same
    tokens as JAX's v2 engine; a quantized tree keeps its experts in the
    model's type, as JAX's quantizer leaves them."""
    jcfg, jp, tcfg = tiny_moe
    je = JEngineV2(jax.tree_util.tree_map(jnp.asarray, jp), jcfg, quantize_weights=quant,
                   **V2_KW)
    te = InferenceEngineV2(tt.params_from_numpy(jp, tcfg, device="cpu"), tcfg, device="cpu",
                           quantize_weights=quant, **V2_KW)
    uids = [1, 2, 3]
    assert te.put(uids, V2_PROMPTS) == je.put(uids, V2_PROMPTS)
    for _ in range(4):
        assert te.step(SamplingParams()) == je.step(JSampling())
    assert te.step_n(6, SamplingParams()) == je.step_n(6, JSampling())
    for u in uids:
        assert te.mgr.seqs[u].tokens == je.mgr.seqs[u].tokens
    if quant:
        assert all(isinstance(v, torch.Tensor) for v in _flat(te.params["layers"]["moe"]).values())
        assert te.params["layers"]["moe"]["w_up"].dtype == torch.float32
    assert te.stats["burst_ticks"] == je.stats["burst_ticks"] > 0
    te.close()


def test_v2_moe_matches_v1_dense(tiny_moe):
    """The port's paged v2 engine and its dense v1 engine agree token for
    token on ``tiny_moe`` (JAX ``test_v2_moe_matches_v1_dense``): both
    route dropless."""
    _, jp, tcfg = tiny_moe
    params = tt.params_from_numpy(jp, tcfg, device="cpu")
    v1 = init_inference(tt.CausalLM(tcfg), params, device="cpu")
    v2 = InferenceEngineV2(params, tcfg, device="cpu", max_seqs=2, num_blocks=64,
                           block_size=8, prefill_buckets=(16,))
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    dense = v1.generate(np.asarray([prompt], np.int32),
                        SamplingParams(max_new_tokens=5))[0].tolist()
    assert dense == v2.generate(prompt, SamplingParams(max_new_tokens=5))


# ---------------------------------------------------------------------------
# (e) Hugging Face
# ---------------------------------------------------------------------------
def test_mixtral_hf_export_and_import_both_ways(tmp_path):
    """The port's Mixtral export is byte-identical to JAX's with the same
    ``config.json``; both importers read both files into the exported
    tree; ``init_inference(model=dir)`` serves JAX's v1 tokens."""
    jcfg = j_preset("tiny_moe", dtype=jnp.float32)
    jp = jax.tree_util.tree_map(np.asarray, jt.init_params(jax.random.PRNGKey(1), jcfg))
    tcfg = get_preset("tiny_moe", dtype=torch.float32)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jhf.export_hf_checkpoint(jax.tree_util.tree_map(jnp.asarray, jp), jcfg, jdir)
    thf.export_hf_checkpoint(tt.params_from_numpy(jp, tcfg, device="cpu"), tcfg, tdir)
    assert filecmp.cmp(os.path.join(jdir, "model.safetensors"),
                       os.path.join(tdir, "model.safetensors"), shallow=False)
    hf = json.load(open(os.path.join(tdir, "config.json")))
    assert hf == json.load(open(os.path.join(jdir, "config.json")))
    assert hf["model_type"] == "mixtral" and hf["num_local_experts"] == 4
    want_tree = _flat(jp)
    for src in (jdir, tdir):
        tparams, tcfg2 = thf.load_hf_checkpoint(src, device="cpu")
        jparams, jcfg2 = jhf.load_hf_checkpoint(src)
        for name in ("moe_num_experts", "moe_top_k", "num_layers", "hidden_size"):
            assert getattr(tcfg2, name) == getattr(jcfg2, name), name
        got, theirs = _flat(tparams), _flat(jax.tree_util.tree_map(np.asarray, jparams))
        assert set(got) == set(theirs) == set(want_tree)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), theirs[k], err_msg=k)
            np.testing.assert_array_equal(got[k].numpy(), want_tree[k], err_msg=k)
    cfg2 = thf.config_from_hf(hf)
    assert (cfg2.moe_num_experts, cfg2.moe_top_k, cfg2.hd) == (4, 2, tcfg.hd)
    prompt = np.random.default_rng(4).integers(0, 256, (2, 9)).astype(np.int32)
    cfg_fp32 = thf.config_from_hf(hf).replace(dtype=torch.float32)
    eng = init_inference(tt.CausalLM(cfg_fp32), thf.load_hf_checkpoint(tdir, device="cpu")[0],
                         device="cpu")
    want = j_init_inference(jt.CausalLM(jcfg), jax.tree_util.tree_map(jnp.asarray, jp))
    samp = dict(max_new_tokens=6)
    assert np.array_equal(eng.generate(prompt, SamplingParams(**samp)),
                          want.generate(prompt, JSampling(**samp)))
    from_dir = init_inference(tdir, device="cpu")  # the config's bf16, loaded as bf16
    assert from_dir.cfg.moe_num_experts == 4
    assert from_dir.params["layers"]["moe"]["w_gate"].dtype == torch.bfloat16
    assert from_dir.generate(prompt, SamplingParams(**samp)).shape == (2, 6)


# ---------------------------------------------------------------------------
# (f) config and refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("raw", [
    {}, {"moe": {"enabled": True, "num_experts": 8, "top_k": 2, "capacity_factor": 1.25,
                 "min_capacity": 2, "drop_tokens": False, "aux_loss_coef": 0.02}},
], ids=["default", "enabled"])
def test_moe_config_section_parses_as_jax(raw):
    t, j = parse_config(raw, dp_world_size=1), j_parse_config(raw, dp_world_size=1)
    assert dataclasses.asdict(t.moe) == dataclasses.asdict(j.moe)


def test_expert_parallelism_is_refused_naming_item_7(tiny_moe):
    """The expert axis runs across ranks
    (tests/test_torch_expert.py); pipeline stages beside it stay refused.
    Without an expert axis of 2 or more ``routed_ffn_ep`` is ``moe_block``,
    as JAX's is."""
    with pytest.raises(NotImplementedError, match=r"config key 'mesh' .*queue 1 item 7\)"):
        parse_config({"moe": {"enabled": True}, "mesh": {"expert": 2, "stage": 2}})
    jcfg, jp, tcfg = tiny_moe
    lw = {k: torch.from_numpy(np.array(v[0])) for k, v in jp["layers"]["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 4, 64)).astype(np.float32))
    out, aux = tlayer.routed_ffn_ep(lw, x, tcfg, None, fmt="int8")
    ref, ref_aux = tlayer.moe_block(lw, x, tcfg)
    assert torch.equal(out, ref) and torch.equal(aux, ref_aux)
