"""The port's reference-facing API against the JAX package, on the CPU.

(a) ``sample``'s top-p filter when a row's fp32 cumulative probability never
    reaches ``top_p``: the cutoff index equals the vocab size, JAX's gather
    there fills NaN and masks nothing, and the port must do the same
    (before, its ``torch.gather`` raised on the CPU and asserted on CUDA).
(b) The serving runner's refusals: ALiBi and parallel-block models are
    refused by design, as JAX's v2 engine refuses them, and sent to the
    port's v1 engine; MoE serves, and expert parallelism is a port gap.
(c) The training engine's forward / backward / step API (the reference's
    shim) on ``tiny`` in fp32 against ``train_batch`` and JAX's shim: GAS 2
    over 3 steps, an fp16 overflow skip, ``no_sync`` and the
    backward-without-forward errors, ``eval_batch``, the small getters, the
    LR scheduler's state and ``memory_breakdown``.

Tolerances: the filter masks are compared exactly (the same fp32 ops on
the same logits; a row's cutoff may move only where two cumulative sums
straddle ``top_p`` by an ulp, and the test checks that no row of this input
does); engine losses and parameters as ``test_torch_training.ENGINE_TOL``
(atol 1e-5 / rtol 1e-4 after AdamW steps); the shim against the port's own
``train_batch`` exactly (the same operations in the same order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.inference.engine_v2 import InferenceEngineV2 as JEngineV2
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.parallel.topology import initialize_mesh
from deepspeed_tpu.runtime import lr_schedules as jlr

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.inference import model_runner
from deepspeed_tpu_torch.inference.sampling import SamplingParams, sample, top_p_filter
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.runtime import lr_schedules as tlr
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

ENGINE_TOL = dict(atol=1e-5, rtol=1e-4)
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# (a) top-p when the cumulative sum never reaches top_p
# ---------------------------------------------------------------------------
def _fault1_logits():
    """ROADMAP queue 3 fault 1's reproduction: row 7's fp32 cumulative sum
    ends below 0.99999994."""
    return torch.randn(8, 128256, generator=torch.Generator().manual_seed(0)) * 0.1


def _jax_top_p(logits: np.ndarray, top_p: float) -> np.ndarray:
    """JAX ``sample``'s top-p filter (``deepspeed_tpu/inference/sampling.py``
    ``sample``, the ``top_p < 1`` branch), on jnp arrays."""
    x = jnp.asarray(logits)
    sorted_logits = jnp.sort(x, axis=-1)[:, ::-1]
    cum = jnp.cumsum(jax.nn.softmax(sorted_logits, axis=-1), axis=-1)
    cutoff_idx = jnp.sum(cum < top_p, axis=-1)
    cutoff = jnp.take_along_axis(sorted_logits, cutoff_idx[:, None], axis=-1)
    return np.asarray(jnp.where(x < cutoff, -jnp.inf, x)), np.asarray(cutoff_idx)


def test_top_p_that_cumsum_never_reaches_masks_nothing_like_jax():
    logits = _fault1_logits()
    top_p = 0.99999994
    v = logits.shape[-1]
    got = top_p_filter(logits, top_p)
    want, j_idx = _jax_top_p(logits.numpy(), top_p)
    assert j_idx[7] == v  # JAX's out-of-range gather on row 7
    assert torch.equal(got[7], logits[7])  # masks nothing
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    toks = sample(logits, SamplingParams(temperature=1.0, top_p=top_p),
                  torch.Generator().manual_seed(1))
    assert toks.dtype == torch.int32 and toks.shape == (8,)
    assert bool(((toks >= 0) & (toks < v)).all())
    assert bool(torch.isfinite(got[torch.arange(8), toks.long()]).all())  # never a masked id


def test_top_p_cutoff_inside_the_vocab_still_filters():
    """A top_p that the cumulative sum reaches keeps only its prefix, as
    JAX does: the clamp changes nothing for an in-range cutoff."""
    logits = torch.from_numpy(np.random.default_rng(3).normal(size=(4, 64)).astype(np.float32))
    got = top_p_filter(logits, 0.5)
    want, j_idx = _jax_top_p(logits.numpy(), 0.5)
    assert (j_idx < 64).all()
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    assert 0 < int(torch.isinf(got).sum()) < got.numel()


# ---------------------------------------------------------------------------
# (b) the serving runner's refusals
# ---------------------------------------------------------------------------
# the third value is where the port's text sends the caller: its own v1
# engine
@pytest.mark.parametrize("over,jax_says,where", [
    (dict(position="alibi", num_kv_heads=4, norm="layernorm"),
     "InferenceEngineV2 cannot serve position='alibi' models",
     "deepspeed_tpu_torch.inference.init_inference"),
    (dict(parallel_block=True, norm="layernorm"),
     "InferenceEngineV2 cannot serve parallel_block models",
     "deepspeed_tpu_torch.inference.init_inference"),
])
def test_runner_refuses_alibi_and_parallel_block_as_jax_v2_does(over, jax_says, where):
    cfg = get_preset("tiny", dtype=torch.float32, **over)
    with pytest.raises(NotImplementedError) as port:
        model_runner._check_family(cfg)
    jcfg = j_preset("tiny", dtype=jnp.float32, **over)
    with pytest.raises(NotImplementedError) as ref:
        JEngineV2(None, jcfg)
    for msg in (str(port.value), str(ref.value)):
        assert msg.startswith(jax_says) and "use init_inference" in msg
    assert where in str(port.value) and "not ported" not in str(port.value)


def test_runner_refuses_moe_as_a_port_gap():
    """MoE serves on one card now (the runner routes its experts dropless)
    and trains across ranks; what stays a port gap is serving
    it over an expert axis, refused naming item 7."""
    model_runner._check_family(get_preset("tiny", dtype=torch.float32, moe_num_experts=4))
    from deepspeed_tpu_torch.parallel.topology import initialize_mesh

    with pytest.raises(NotImplementedError, match=r"not ported .*item 7"):
        initialize_mesh(devices=["cpu"] * 2, expert=2)


# ---------------------------------------------------------------------------
# (c) the training engine's reference API
# ---------------------------------------------------------------------------
def _config(**over):
    cfg = {
        "train_micro_batch_size_per_gpu": 2,
        "gradient_accumulation_steps": 2,
        "optimizer": {"type": "adamw", "params": {"weight_decay": 0.1}},
        "scheduler": {"type": "WarmupCosineLR",
                      "params": {"total_num_steps": 6, "warmup_num_steps": 2, "lr": 3e-3}},
        "gradient_clipping": 0.5,
        "bf16": {"enabled": False},
        "steps_per_print": 1000,
    }
    cfg.update(over)
    return cfg


def _batches(n, seed=7):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, (2, 2, 17)).astype(np.int32)} for _ in range(n)]


@pytest.fixture(scope="module")
def tiny_params():
    jcfg = j_preset("tiny", dtype=jnp.float32)
    return jax.tree_util.tree_map(np.asarray, jt.init_params(jax.random.PRNGKey(0), jcfg))


def _port(jp, dtype=torch.float32, **over):
    tcfg = get_preset("tiny", dtype=dtype, attn_impl="flash", remat="selective")
    params = tt.params_from_numpy(jp, tcfg, device="cpu")
    engine, _, _, _ = tds.initialize(model=tt.CausalLM(tcfg), params=params,
                                     config=_config(**over), device="cpu")
    return engine


def _jax(jp, dtype=jnp.float32, **over):
    engine, _, _, _ = jds.initialize(
        model=jt.CausalLM(j_preset("tiny", dtype=dtype)),
        params=jax.tree_util.tree_map(jnp.asarray, jp), config=_config(**over),
        mesh=initialize_mesh(devices=jax.devices()[:1], data=1))
    return engine


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v.detach() if torch.is_tensor(v) else v)
    return out


def _shim_steps(engine, batches, boundaries=None):
    """forward / backward / step over each batch's GAS micro-batches; the
    micro-batch losses as floats.  ``boundaries`` collects
    ``is_gradient_accumulation_boundary()`` after each backward."""
    losses = []
    for b in batches:
        for i in range(b["input_ids"].shape[0]):
            loss = engine.forward({"input_ids": b["input_ids"][i]})
            engine.backward(loss)
            if boundaries is not None:
                boundaries.append(engine.is_gradient_accumulation_boundary())
            engine.step()
            losses.append(float(loss))
    return losses


def test_shim_gas_matches_train_batch_and_jax_shim(tiny_params):
    batches = _batches(3)
    fused = _port(tiny_params)
    fused_losses = [float(fused.train_batch(b)) for b in batches]
    shim = _port(tiny_params)
    boundaries = []
    shim_losses = _shim_steps(shim, batches, boundaries)
    jshim = _jax(tiny_params)
    j_losses = _shim_steps(jshim, batches)

    assert boundaries == [False, True] * 3
    np.testing.assert_allclose(shim_losses, j_losses, **ENGINE_TOL)
    np.testing.assert_allclose(np.asarray(shim_losses).reshape(3, 2).mean(-1), fused_losses,
                               rtol=1e-6)
    ft, ff = _flat(shim.params), _flat(fused.params)
    fj = _flat(jax.tree_util.tree_map(np.asarray, jshim.state.params))
    assert set(ft) == set(fj)
    for key in ft:
        np.testing.assert_array_equal(ft[key], ff[key], err_msg=key)
        np.testing.assert_allclose(ft[key], fj[key], err_msg=key, **ENGINE_TOL)
    assert shim.global_steps == fused.global_steps == jshim.global_steps == 3
    assert int(shim.device_step) == 3
    np.testing.assert_allclose(shim.get_lr(), jshim.get_lr(), rtol=1e-6)
    assert shim.get_lr() == fused.get_lr()


def test_step_off_the_boundary_changes_nothing(tiny_params):
    engine = _port(tiny_params)
    before = _flat(engine.params)
    micro = {"input_ids": _batches(1)[0]["input_ids"][0]}
    engine(micro)  # __call__ is forward
    engine.backward()
    engine.step()
    assert engine.global_steps == 0 and engine.lr_scheduler.last_step == 0
    for key, v in _flat(engine.params).items():
        np.testing.assert_array_equal(v, before[key], err_msg=key)


def test_fp16_overflow_step_is_skipped_like_jax(tiny_params):
    fp16 = dict(bf16={"enabled": False},
                fp16={"enabled": True, "initial_scale_power": 127, "hysteresis": 1})
    port = _port(tiny_params, dtype=torch.float16, **fp16)
    ref = _jax(tiny_params, dtype=jnp.float16, **fp16)
    assert isinstance(port.loss_scale, float) and port.loss_scale == ref.loss_scale == 2.0 ** 127
    before = _flat(port.params)
    scales = []
    for engine in (port, ref):
        _shim_steps(engine, _batches(2))
        scales.append(engine.loss_scale)
        assert engine.skipped_steps == 2 and engine.global_steps == 2
    assert scales[0] == scales[1] == 2.0 ** 125
    assert int(port.device_step) == 0
    for key, v in _flat(port.params).items():
        np.testing.assert_array_equal(v, before[key], err_msg=key)


def _error(fn, exc):
    with pytest.raises(exc) as info:
        fn()
    return str(info.value)


def _nested_no_sync(engine):
    with engine.no_sync():
        with engine.no_sync():
            pass


def _step_in_no_sync(engine):
    with engine.no_sync():
        engine.step()


def test_no_sync_and_backward_errors_match_jax(tiny_params):
    pairs = [(_port(tiny_params), _jax(tiny_params))]
    stage2 = {"zero_optimization": {"stage": 2}}
    port2, jax2 = _port(tiny_params, **stage2), _jax(tiny_params, **stage2)
    msgs = [_error(lambda e=e: e.no_sync().__enter__(), RuntimeError) for e in (port2, jax2)]
    assert msgs[0] == msgs[1] and "ZeRO stage 2" in msgs[0]
    for port, ref in pairs:
        for fn in (_nested_no_sync, _step_in_no_sync):
            assert _error(lambda: fn(port), RuntimeError) == _error(lambda: fn(ref), RuntimeError)
        assert (_error(port.backward, AssertionError) == _error(ref.backward, AssertionError)
                == "backward() without a prior forward()")
        micro = {"input_ids": _batches(1)[0]["input_ids"][0]}
        for engine in (port, ref):
            with engine.no_sync():
                engine.backward(engine.forward(micro))
                engine.backward(engine.forward(micro))
                assert not engine.is_gradient_accumulation_boundary()
            assert engine.is_gradient_accumulation_boundary()


def test_a_second_forward_replaces_the_pending_one(tiny_params):
    b = _batches(2, seed=11)
    a = _port(tiny_params)
    a.forward({"input_ids": b[1]["input_ids"][0]})  # dropped
    for i in range(2):
        a.forward({"input_ids": b[0]["input_ids"][i]})
        a.backward()
    a.step()
    ref = _port(tiny_params)
    ref.train_batch(b[0])
    for key, v in _flat(a.params).items():
        np.testing.assert_array_equal(v, _flat(ref.params)[key], err_msg=key)


def test_eval_batch_and_getters_match_jax(tiny_params):
    port, ref = _port(tiny_params), _jax(tiny_params)
    batches = _batches(2, seed=5)
    port.train_batch(batches[0])
    ref.train_batch(batches[0])
    micro = {"input_ids": batches[1]["input_ids"][0]}
    got = port.eval_batch(micro)
    assert not got.requires_grad
    np.testing.assert_allclose(float(got), float(ref.eval_batch(micro)), **ENGINE_TOL)
    assert port.loss_scale == ref.loss_scale == 1.0
    assert port.gradient_accumulation_steps() == ref.gradient_accumulation_steps() == 2
    assert port.train_micro_batch_size_per_gpu() == ref.train_micro_batch_size_per_gpu() == 2
    assert port.dp_world_size == ref.dp_world_size == 1
    mp, jmp = _flat(port.module_params()), _flat(jax.tree_util.tree_map(np.asarray,
                                                                        ref.module_params()))
    for key in mp:
        np.testing.assert_allclose(mp[key], jmp[key], err_msg=key, **ENGINE_TOL)


def test_eval_fn_replaces_the_loss_in_eval_batch(tiny_params):
    tcfg = get_preset("tiny", dtype=torch.float32)
    model = tt.CausalLM(tcfg)
    engine, _, _, _ = tds.initialize(
        model=model, params=tt.params_from_numpy(tiny_params, tcfg, device="cpu"),
        config=_config(), device="cpu", eval_fn=lambda p, b, rng: 2.0 * model.loss_fn(p, b))
    micro = {"input_ids": _batches(1)[0]["input_ids"][0]}
    with torch.no_grad():
        want = 2.0 * model.loss_fn(engine.params, {"input_ids": torch.from_numpy(micro["input_ids"])})
    np.testing.assert_allclose(float(engine.eval_batch(micro)), float(want), **LOSS_TOL)


@pytest.mark.parametrize("name,params", [
    ("WarmupCosineLR", {"total_num_steps": 10, "warmup_num_steps": 3, "lr": 1e-3}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3, "cycle_first_step_size": 4}),
])
def test_lr_scheduler_state_round_trips_like_jax(name, params):
    sched = tlr.LRScheduler(tlr.get_lr_schedule_fn(name, params))
    jsched = jlr.LRScheduler(jlr.get_lr_schedule_fn(name, params))
    for s in (sched, jsched):
        s.step(3)
        s.step()
    sd = sched.state_dict()
    assert sd == jsched.state_dict() == {"last_step": 4}
    fresh = tlr.LRScheduler(tlr.get_lr_schedule_fn(name, params))
    fresh.load_state_dict(sd)
    assert fresh.last_step == 4 and fresh.get_last_lr() == sched.get_last_lr()
    np.testing.assert_allclose(fresh.get_last_lr(), jsched.get_last_lr(), rtol=1e-6)


def test_memory_breakdown_counts_the_flat_buffers(tiny_params):
    port, ref = _port(tiny_params), _jax(tiny_params)
    got, want = port.memory_breakdown(), ref.memory_breakdown()
    assert set(got) == set(want)
    assert set(got["snapshot"]) == set(want["snapshot"])
    masters = port._masters.flat
    assert got["master_params_bytes"] == masters.numel() * 4 == want["master_params_bytes"]
    moments = port.opt_state["mu"][0].numel() * 4 + port.opt_state["nu"][0].numel() * 4
    assert got["opt_state_bytes"] == moments + 4  # + the int32 step count
    assert got["state_total_bytes"] == got["master_params_bytes"] + got["opt_state_bytes"]
    assert got["snapshot"]["device_bytes_in_use"] == 0  # a CPU engine: no device allocator
