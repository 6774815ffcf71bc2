"""The port's compression (``deepspeed_tpu_torch/compression``) against the
JAX package's, on the CPU.

The fake-quant, prune and structured-mask math are the same IEEE fp32
operations in both packages, so their results are compared bit for bit
(``np.array_equal``): ``fake_quantize`` at traced bits, ``magnitude_prune_mask``
at JAX's fp32 ``k``, ``structured_keep_mask`` with ties, and
``CompressionManager.transform`` in fp32 and bf16 at steps before, at and
after the offsets.  ``redundancy_clean`` gives JAX's shapes and kept
indices.  Losses and gradients (activation quantization, distillation) use
the training tests' fp32 tolerances (loss atol / rtol 1e-5, gradients atol
1e-5 / rtol 1e-3); a 4-step engine trajectory under QAT + pruning uses the
engine tolerance (atol 1e-5 / rtol 1e-4).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.compression import compress as jc
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.parallel.topology import initialize_mesh

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.compression import compress as tc
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.presets import get_preset
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-3)
ENGINE_TOL = dict(atol=1e-5, rtol=1e-4)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(over=None, dtype=jnp.float32, seed=0):
    jcfg = j_preset("tiny", dtype=jnp.float32, **(over or {}))
    jp = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    jp = jax.tree_util.tree_map(lambda x: x.astype(dtype), jp)
    return jcfg, jax.tree_util.tree_map(np.asarray, jp)


def _port_params(jp, dtype=torch.float32):
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, dtype=np.float32)).to(dtype)

    return conv(jp)


# ---------------------------------------------------------------------------
# the math, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("bits", [8.0, 5.0, 3.0])
@pytest.mark.parametrize("groups", [1, 4])
def test_fake_quantize_bits_equal_jax(symmetric, bits, groups):
    x = np.random.default_rng(0).normal(size=(8, 32, 24)).astype(np.float32)
    x[0, 0, 0] = 0.0
    want = jc.fake_quantize(jnp.asarray(x), jnp.asarray(bits, jnp.float32),
                            symmetric=symmetric, groups=groups)
    got = tc.fake_quantize(torch.from_numpy(x), torch.tensor(bits), symmetric=symmetric,
                           groups=groups)
    assert np.array_equal(got.numpy(), np.asarray(want))
    if symmetric:
        # traced bits, as the engine's step traces them; XLA contracts the
        # asymmetric dequant ``q * scale + lo`` into one FMA under jit, so
        # that form is held against the eager ops above
        traced = jax.jit(lambda v, b: jc.fake_quantize(v, b, symmetric=symmetric,
                                                       groups=groups))(jnp.asarray(x), bits)
        assert np.array_equal(got.numpy(), np.asarray(traced))


@pytest.mark.parametrize("n,ratio", [(100_663_296, 0.3), (100_663_296, 0.7), (3_000, 0.3),
                                     (2_520, 0.5), (7, 0.99), (10, 0.0)])
def test_prune_k_is_jaxs_fp32_k(n, ratio):
    """JAX's ``k`` (fp32 ``n * (1 - ratio)``, int32, clipped), which float64
    moves for the flagship's 24-layer ``w_up`` at ratio 0.3."""
    want = int(jnp.clip((n * (1.0 - jnp.asarray(ratio, jnp.float32))).astype(jnp.int32),
                        0, n - 1))
    assert tc.prune_keep_index(n, ratio) == want
    if n == 100_663_296 and ratio == 0.3:
        assert int(n * (1.0 - ratio)) != want  # the float64 k differs


@pytest.mark.parametrize("ratio", [0.75, 0.5, 0.3, 0.1])
def test_magnitude_prune_mask_equals_jax(ratio):
    x = np.random.default_rng(1).normal(size=(4, 30, 21)).astype(np.float32)
    x[1, :4, :3] = 0.5  # ties at the threshold are all kept (>=)
    want = jc.magnitude_prune_mask(jnp.asarray(x), ratio)
    got = tc.magnitude_prune_mask(torch.from_numpy(x), ratio)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ratio", [0.5, 0.25, 0.6, 0.01])
def test_structured_keep_mask_with_ties_equals_jax(ratio):
    rng = np.random.default_rng(2)
    scores = rng.integers(0, 4, (3, 16)).astype(np.float32)  # many ties
    want = np.asarray(jc.structured_keep_mask(jnp.asarray(scores), ratio))
    got = tc.structured_keep_mask(torch.from_numpy(scores), ratio).numpy()
    assert np.array_equal(got, want)
    assert (got.sum(-1) == max(1, int(round(16 * ratio)))).all()


# the techniques the transform is checked on: QAT with an 8 -> 4 bit ramp on
# the MLP, l1 pruning on the attention, head pruning on wq with wo related,
# row pruning on the MLP's twins with w_down related, and all of them at once
WQ = {"weight_quantization": {
    "shared_parameters": {"enabled": True, "schedule_offset": 2, "quantize_groups": 1,
                          "quantization_type": "symmetric"},
    "different_groups": {"wq1": {"params": {"start_bits": 8, "target_bits": 4,
                                            "quantization_period": 1},
                                 "modules": ["layers/mlp"]}}}}
WQ_ASYM = {"weight_quantization": {
    "shared_parameters": {"enabled": True, "schedule_offset": 1, "quantize_groups": 2,
                          "quantization_type": "asymmetric"},
    "different_groups": {"wq1": {"params": {"start_bits": 6, "target_bits": 6},
                                 "modules": ["layers/attn/w[qk]$"]}}}}
L1 = {"sparse_pruning": {
    "shared_parameters": {"enabled": True, "method": "l1", "schedule_offset": 2},
    "different_groups": {"sp1": {"params": {"dense_ratio": 0.3}, "modules": ["layers/attn"]}}}}
HEADS = {"head_pruning": {
    "shared_parameters": {"enabled": True, "num_heads": 4, "schedule_offset": 2},
    "different_groups": {"hp1": {"params": {"dense_ratio": 0.5},
                                 "modules": [r"layers/attn/wq$"],
                                 "related_modules": [[r"layers/attn/wo$"]]}}}}
ROWS = {"row_pruning": {
    "shared_parameters": {"enabled": True, "method": "l1", "schedule_offset": 2},
    "different_groups": {"rp1": {"params": {"dense_ratio": 0.5},
                                 "modules": [r"layers/mlp/w_(up|gate)$"],
                                 "related_modules": [[r"layers/mlp/w_down$"]]}}}}
TECHNIQUES = {"wq_ramp": WQ, "wq_asym": WQ_ASYM, "l1": L1, "heads": HEADS, "rows": ROWS,
              "all": {**WQ, **L1, **HEADS, **ROWS}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(TECHNIQUES))
def test_transform_bits_equal_jax_around_the_offset(name, dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    _, jp = _pair(dtype=jdt)
    jm, tm = jc.CompressionManager(TECHNIQUES[name]), tc.CompressionManager(TECHNIQUES[name])
    tp = _port_params(jp, tdt)
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    for step in (0, 1, 2, 3, 5):
        want = _flat(jm.transform(jparams, jnp.asarray(step, jnp.int32)))
        got = _flat(tm.transform(tp, torch.tensor(step, dtype=torch.int32)))
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == tdt
            assert np.array_equal(_np(got[key]), _np(want[key])), (name, dtype, step, key)


def test_transform_is_an_ste_and_reads_a_device_step():
    """The forward is the transformed value, the gradient the identity; the
    schedule reads the step tensor with no host read."""
    _, jp = _pair()
    tm = tc.CompressionManager({**WQ, **L1})
    tp = {k: v.requires_grad_(True) for k, v in _flat(_port_params(jp)).items()}
    out = _flat(tm.transform(_unflat(tp), torch.tensor(7, dtype=torch.int32)))
    sum(v.sum() for v in out.values()).backward()
    for key, leaf in tp.items():
        np.testing.assert_array_equal(leaf.grad.numpy(), np.ones(leaf.shape, np.float32))
    assert not np.array_equal(_np(out["layers/mlp/w_up"]), _np(tp["layers/mlp/w_up"]))


def _unflat(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def test_offload_layer_sequences_are_stacked():
    """A leaf given as its layers' tensors (an offloaded engine's compute
    copy) transforms as the stacked leaf."""
    _, jp = _pair()
    tm = tc.CompressionManager(TECHNIQUES["all"])
    tp = _port_params(jp)
    seq = {**tp, "layers": {g: {k: tuple(torch.unbind(v, 0)) for k, v in sub.items()}
                            for g, sub in tp["layers"].items()}}
    a = _flat(tm.transform(tp, 9))
    b = _flat(tm.transform(seq, 9))
    for key in a:
        assert torch.equal(a[key], b[key]), key


def test_redundancy_clean_shapes_indices_and_loss_equal_jax():
    jcfg, jp = _pair()
    cfg = {**HEADS, **ROWS}
    jm, tm = jc.CompressionManager(cfg), tc.CompressionManager(cfg)
    jclean, jinfo = jm.redundancy_clean(jax.tree_util.tree_map(jnp.asarray, jp))
    tclean, tinfo = tm.redundancy_clean(_port_params(jp))
    fj, ft = _flat(jclean), _flat(tclean)
    assert set(fj) == set(ft) and tinfo == jinfo
    for key in fj:
        assert tuple(ft[key].shape) == tuple(fj[key].shape), key
        assert np.array_equal(_np(ft[key]), _np(fj[key])), key
    assert ft["layers/mlp/w_up"].shape[-1] == jcfg.intermediate_size // 2
    assert ft["layers/attn/wq"].shape[-1] == jcfg.hidden_size // 2
    # the shrunk tree computes the masked tree's loss (dead units add 0);
    # row pruning only: pruned query heads no longer pair with their kv heads
    rows = tc.CompressionManager(ROWS)
    rclean, _ = rows.redundancy_clean(_port_params(jp))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 33)).astype(np.int32))
    tcfg = get_preset("tiny", dtype=torch.float32)
    masked = tt.CausalLM(tcfg).loss_fn(rows.export_params(_port_params(jp)),
                                       {"input_ids": tokens})
    small = tcfg.replace(intermediate_size=tcfg.intermediate_size // 2)
    shrunk = tt.CausalLM(small).loss_fn(rclean, {"input_ids": tokens})
    np.testing.assert_allclose(shrunk.item(), masked.item(), rtol=1e-2)


# ---------------------------------------------------------------------------
# activation quantization
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", ["llama", "parallel_block"])
def test_activation_quantization_loss_and_grads_match_jax(variant):
    over = dict(act_quant_bits=8)
    if variant == "parallel_block":
        over.update(parallel_block=True, norm="layernorm", gated_mlp=False,
                    activation="gelu", qkv_bias=True)
    jcfg, jp = _pair(over)
    tokens = np.random.default_rng(3).integers(0, 256, (2, 25)).astype(np.int32)
    jloss, jgrads = jax.jit(jax.value_and_grad(jt.CausalLM(jcfg).loss_fn))(
        jax.tree_util.tree_map(jnp.asarray, jp), {"input_ids": jnp.asarray(tokens)})
    tcfg = get_preset("tiny", dtype=torch.float32, attn_impl="flash", remat="selective", **over)
    tp = tt.params_from_numpy(jp, tcfg, device="cpu")
    for leaf in _flat(tp).values():
        leaf.requires_grad_(True)
    loss = tt.CausalLM(tcfg).loss_fn(tp, {"input_ids": torch.from_numpy(tokens)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    fj, ft = _flat(jax.tree_util.tree_map(np.asarray, jgrads)), _flat(tp)
    for key in fj:
        np.testing.assert_allclose(ft[key].grad.numpy(), fj[key], err_msg=key, **GRAD_TOL)
    # the quantization changes the loss
    plain = tt.CausalLM(tcfg.replace(act_quant_bits=None)).loss_fn(
        tt.params_from_numpy(jp, tcfg, device="cpu"), {"input_ids": torch.from_numpy(tokens)})
    assert plain.item() != loss.item()


def test_quantize_activation_equals_jax_with_an_identity_gradient():
    x = np.random.default_rng(4).normal(size=(6, 40)).astype(np.float32)
    for static in (None, 2.5):
        want = jc.quantize_activation(jnp.asarray(x), 6, static_range=static)
        t = torch.from_numpy(x).requires_grad_(True)
        got = tc.quantize_activation(t, 6, static_range=static)
        assert np.array_equal(got.detach().numpy(), np.asarray(want))
        got.sum().backward()
        np.testing.assert_array_equal(t.grad.numpy(), np.ones_like(x))


# ---------------------------------------------------------------------------
# layer reduction and distillation
# ---------------------------------------------------------------------------
LR = {"enabled": True, "keep_number_layer": 2, "teacher_layer": [1, 3],
      "module_name_prefix": "layers"}


def test_layer_reduction_init_equals_jax():
    _, jp = _pair(dict(num_layers=4))
    want = _flat(jc.layer_reduction_init(jax.tree_util.tree_map(jnp.asarray, jp), LR))
    got = _flat(tc.layer_reduction_init(_port_params(jp), LR))
    assert set(got) == set(want)
    for key in want:
        assert np.array_equal(_np(got[key]), _np(want[key])), key
    assert got["layers/mlp/w_up"].shape[0] == 2
    with pytest.raises(ValueError, match="keep_number_layer"):
        tc.layer_reduction_init(_port_params(jp), dict(LR, keep_number_layer=3))


def test_kd_loss_equals_jax():
    rng = np.random.default_rng(5)
    s, t = (rng.normal(size=(2, 7, 50)).astype(np.float32) for _ in range(2))
    for temp in (1.0, 2.0):
        want = float(jc.kd_loss(jnp.asarray(s), jnp.asarray(t), temp))
        np.testing.assert_allclose(tc.kd_loss(torch.from_numpy(s), torch.from_numpy(t),
                                              temp).item(), want, **LOSS_TOL)


def test_make_kd_loss_fn_step_equals_jax(monkeypatch):
    """One KD loss and its gradients against JAX's, with one student and one
    teacher forward, the teacher's logits without a graph."""
    jtcfg, jtp = _pair(dict(num_layers=4))
    jscfg = jtcfg.replace(num_layers=2)
    jsp = jc.layer_reduction_init(jax.tree_util.tree_map(jnp.asarray, jtp), LR)
    jloss_fn = jc.make_kd_loss_fn(jt.CausalLM(jscfg), jt.CausalLM(jtcfg),
                                  jax.tree_util.tree_map(jnp.asarray, jtp), alpha=0.3,
                                  temperature=2.0)
    tokens = np.random.default_rng(6).integers(0, 256, (2, 17)).astype(np.int32)
    jl, jg = jax.jit(jax.value_and_grad(jloss_fn))(jsp, {"input_ids": jnp.asarray(tokens)})
    tcfg = get_preset("tiny", dtype=torch.float32, num_layers=4)
    teacher, student = tt.CausalLM(tcfg), tt.CausalLM(tcfg.replace(num_layers=2))
    ttp = _port_params(jtp)
    tsp = tc.layer_reduction_init(ttp, LR)
    for leaf in _flat(tsp).values():
        leaf.requires_grad_(True)
    calls = []
    real = tt.forward

    def counting(params, *a, **kw):
        out = real(params, *a, **kw)
        calls.append((torch.is_grad_enabled(),
                      (out[0] if isinstance(out, tuple) else out).requires_grad))
        return out

    monkeypatch.setattr(tt, "forward", counting)
    loss_fn = tc.make_kd_loss_fn(student, teacher, ttp, alpha=0.3, temperature=2.0)
    loss = loss_fn(tsp, {"input_ids": torch.from_numpy(tokens)})
    loss.backward()
    assert calls == [(True, True), (False, False)]  # student, then the teacher without grad
    np.testing.assert_allclose(loss.item(), float(jl), **LOSS_TOL)
    fj, ft = _flat(jax.tree_util.tree_map(np.asarray, jg)), _flat(tsp)
    for key in fj:
        np.testing.assert_allclose(ft[key].grad.numpy(), fj[key], err_msg=key, **GRAD_TOL)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def _config(**over):
    cfg = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "adamw", "params": {"lr": 3e-3, "weight_decay": 0.1}},
           "gradient_clipping": 0.5, "bf16": {"enabled": False}, "steps_per_print": 1000}
    cfg.update(over)
    return cfg


def _batches(n, seed=7):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, (2, 2, 17)).astype(np.int32)} for _ in range(n)]


QAT_PRUNE = {"weight_quantization": {
    "shared_parameters": {"enabled": True, "schedule_offset": 1},
    "different_groups": {"wq1": {"params": {"start_bits": 8, "target_bits": 6,
                                            "quantization_period": 1},
                                 "modules": ["layers/mlp"]}}},
    **L1, **HEADS}


def test_engine_trajectory_under_qat_and_pruning_matches_jax():
    jcfg, jp = _pair()
    batches = _batches(4)
    over = dict(compression_training=QAT_PRUNE)
    jengine, _, _, _ = jds.initialize(
        model=jt.CausalLM(jcfg), params=jax.tree_util.tree_map(jnp.asarray, jp),
        config=_config(**over), mesh=initialize_mesh(devices=jax.devices()[:1], data=1))
    j_losses = [float(jengine.train_batch(b)) for b in batches]
    tcfg = get_preset("tiny", dtype=torch.float32, attn_impl="flash", remat="selective")
    engine, _, _, _ = tds.initialize(model=tt.CausalLM(tcfg),
                                     params=tt.params_from_numpy(jp, tcfg, device="cpu"),
                                     config=_config(**over), device="cpu")
    assert engine._compression is not None
    t_losses = [float(engine.train_batch(b)) for b in batches]
    np.testing.assert_allclose(t_losses, j_losses, **ENGINE_TOL)
    fj = _flat(jax.tree_util.tree_map(np.asarray, jengine.state.params))
    ft = _flat(engine.params)
    for key in fj:
        np.testing.assert_allclose(ft[key].detach().numpy(), fj[key], err_msg=key,
                                   **ENGINE_TOL)
    # the schedule acts: the same run without compression trains otherwise
    plain, _, _, _ = tds.initialize(model=tt.CausalLM(tcfg),
                                    params=tt.params_from_numpy(jp, tcfg, device="cpu"),
                                    config=_config(), device="cpu")
    p_losses = [float(plain.train_batch(b)) for b in batches]
    assert p_losses[0] == t_losses[0] and p_losses[-1] != t_losses[-1]


def test_forward_api_runs_the_transform_like_train_batch():
    _, jp = _pair()
    batches = _batches(2, seed=9)
    tcfg = get_preset("tiny", dtype=torch.float32)

    def engine():
        return tds.initialize(model=tt.CausalLM(tcfg),
                              params=tt.params_from_numpy(jp, tcfg, device="cpu"),
                              config=_config(compression_training=QAT_PRUNE), device="cpu")[0]

    a, b = engine(), engine()
    for batch in batches:
        a.train_batch(batch)
        for i in range(2):
            b.forward({"input_ids": batch["input_ids"][i]})
            b.backward()
            b.step()
    for key, leaf in _flat(a.params).items():
        np.testing.assert_allclose(_flat(b.params)[key].detach().numpy(),
                                   leaf.detach().numpy(), atol=1e-6, rtol=1e-6)


def test_init_compression_on_an_engine_and_initialize_wires_activation_bits():
    tcfg = get_preset("tiny", dtype=torch.float32)
    engine, _, _, _ = tds.initialize(model=tt.CausalLM(tcfg), config=_config(), device="cpu")
    assert engine._compression is None
    aq = {"activation_quantization": {
        "shared_parameters": {"enabled": True, "quantization_type": "symmetric"},
        "different_groups": {"aq1": {"params": {"bits": 6}, "modules": [".*"]}}}}
    out = tc.init_compression(engine, {"compression_training": {**WQ, **aq}})
    assert out is engine and engine._compression is not None
    assert engine.model.cfg.act_quant_bits == 6
    assert np.isfinite(float(engine.train_batch(_batches(1)[0])))
    params, manager = tc.init_compression({"w": torch.ones(2, 2)}, {"compression_training": WQ})
    assert manager.any_weight_transform and params["w"].shape == (2, 2)
    # initialize() reads the bits from the config, as JAX does
    model = tt.CausalLM(tcfg)
    engine2, _, _, _ = tds.initialize(model=model, config=_config(compression_training=aq),
                                      device="cpu")
    jmodel = jt.CausalLM(j_preset("tiny", dtype=jnp.float32))
    jds.initialize(model=jmodel, config=_config(compression_training=aq),
                   mesh=initialize_mesh(devices=jax.devices()[:1], data=1))
    assert model.cfg.act_quant_bits == jmodel.cfg.act_quant_bits == 6
    assert engine2._compression is None  # no weight transform installed


def test_manager_refusals_match_jax():
    for bad, match in [({"sparse_pruning": {"shared_parameters": {"enabled": True,
                                                                  "method": "snip"}}},
                        "unsupported"),
                       ({"head_pruning": {"shared_parameters": {"enabled": True}}},
                        "num_heads")]:
        with pytest.raises(ValueError, match=match):
            jc.CompressionManager(bad)
        with pytest.raises(ValueError, match=match):
            tc.CompressionManager(bad)
    full = {"weight_quantization": {"shared_parameters": {"enabled": True},
                                    "different_groups": {}},
            "layer_reduction": {"enabled": True, "keep_number_layer": 2,
                                "teacher_layer": [0, 1]}}
    assert not tc.CompressionManager(full).any_weight_transform
    assert tc.CompressionManager(full).layer_reduction["keep_number_layer"] == 2


def test_bf16_ste_value_is_not_the_target():
    """Under bf16 the forward value is bf16(x + bf16(t - x)), as JAX's STE
    gives it, which differs from t for some entries."""
    x = torch.from_numpy(np.random.default_rng(8).normal(size=4096).astype(np.float32) * 300)
    x = x.to(torch.bfloat16)
    t = (x.float() * 1.001 + 0.37).to(torch.bfloat16)
    want = np.asarray(jc._ste(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                              jnp.asarray(t.float().numpy(), jnp.bfloat16)).astype(jnp.float32))
    got = tc._ste(x, t).float().numpy()
    assert np.array_equal(got, want)
    assert not np.array_equal(got, t.float().numpy())
    assert ml_dtypes.bfloat16  # the JAX side's bf16 arrays
