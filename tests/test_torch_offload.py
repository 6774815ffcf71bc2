"""ZeRO-Offload in the port against the JAX package and against the
port's own plain engine, on ``tiny`` in fp32 on the CPU: the CPU tier
(masters and moments in host memory, streamed in chunks) and the NVMe tier
(swap files and the host AdamW), mirroring ``tests/test_offload.py``.

Tolerances: the CPU tier against the plain engine is exact (each chunk's
update is the plain update on those elements); against JAX's engine, and
the NVMe tier against JAX's NVMe engine, ``ENGINE_TOL`` (the forward and
backward round differently in the two frameworks; the host AdamW is the
same C++); the NVMe tier against the port's plain engine ``NVME_TOL`` of
max |p| (the host AdamW against K8's plain version)."""
import dataclasses
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.config.config import AIOConfig as JAIOConfig
from deepspeed_tpu.config.config import ConfigError as JConfigError
from deepspeed_tpu.config.config import ZeroConfig as JZeroConfig
from deepspeed_tpu.config.config import parse_config as j_parse_config
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.parallel.topology import initialize_mesh
from deepspeed_tpu.runtime.offload import NVMeOptimizer as JNVMeOptimizer

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.checkpoint.saving import export_fp32_state_dict
from deepspeed_tpu_torch.config.config import ConfigError, ZeroConfig, parse_config
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.runtime import offload
from deepspeed_tpu_torch.runtime.offload import NVMeOptimizer

ENGINE_TOL = dict(atol=1e-5, rtol=1e-4)
# the NVMe engine against the plain one, of the model's max |p|: the host
# AdamW rounds 1 - b2 in fp32 arithmetic (1.3e-5 off K8's 1 - b2 from
# double), a last-ulp difference in the masters after one step
# (test_torch_native.py holds the two updates to 1e-6 on the same inputs);
# from the second step the gradients see those ulps, and an embedding entry
# whose micro-batch gradients nearly cancel turns them into about 5e-4 of
# lr through Adam at eps 1e-8 (ENGINE_TOL's atol is the same allowance)
NVME_TOL = 1e-5
OPTIMIZERS = {
    "adamw": {"type": "adamw", "params": {"weight_decay": 0.1}},
    "lamb": {"type": "lamb", "params": {"weight_decay": 0.1}},
    "lion": {"type": "lion", "params": {"weight_decay": 0.1}},
    "adagrad": {"type": "adagrad", "params": {}},
    "muon": {"type": "muon", "params": {}},
    "sgd": {"type": "sgd", "params": {"momentum": 0.9}},
}


@pytest.fixture(autouse=True)
def small_chunks(monkeypatch):
    """Chunks of 1,000 elements: the tiny model's state streams in about
    100 of them (whole leaves for Lamb and Muon)."""
    monkeypatch.setattr(offload, "CHUNK_ELEMS", 1000)


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


def _zero(**z):
    return {"zero_optimization": {"stage": 2, **z}}


def _batches(n, gas=2, seed=7):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, (gas, 2, 17)).astype(np.int32)}
            for _ in range(n)]


@pytest.fixture(scope="module")
def jparams():
    jcfg = j_preset("tiny", dtype=jnp.float32)
    return jcfg, jax.tree_util.tree_map(np.asarray, jt.init_params(jax.random.PRNGKey(0), jcfg))


def _torch_engine(jp, dtype=torch.float32, **over):
    tcfg = get_preset("tiny", dtype=dtype, attn_impl="flash", remat="selective")
    params = tt.params_from_numpy(jp, tcfg, device="cpu")
    engine, _, _, _ = tds.initialize(model=tt.CausalLM(tcfg), params=params,
                                     config=_config(**over), device="cpu")
    return engine


def _jax_engine(jcfg, jp, **over):
    engine, _, _, _ = jds.initialize(
        model=jt.CausalLM(jcfg), params=jax.tree_util.tree_map(jnp.asarray, jp),
        config=_config(**over), mesh=initialize_mesh(devices=jax.devices()[:1], data=1))
    return engine


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _masters(engine):
    return {k: v.detach().float().cpu() for k, v in _flat(export_fp32_state_dict(engine)).items()}


def _train(engine, batches):
    return [float(engine.train_batch(b)) for b in batches]


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------
ZERO_FORMS = [
    {"offload_optimizer": "cpu"},
    {"offload_optimizer": "none", "offload_param": "none"},
    {"offload_param": "cpu"},
    {"offload_optimizer": {"device": "cpu", "pin_memory": True}},
    {"offload_optimizer": {"device": "nvme", "nvme_path": "/x/swap"}},
    {"offload_optimizer": {"device": "nvme", "nvme_path": "/x/swap", "pipeline_read": True}},
    {"offload_optimizer": {"device": "nvme", "pipeline_write": True}},
    {"offload_optimizer": {"device": "nvme", "pipeline": True}, "offload_grad_dtype": "bf16"},
    {"offload_optimizer": "nvme", "offload_pipeline": True, "offload_nvme_path": "/y"},
    {"offload_param": {"device": "cpu", "nvme_path": "/z"}, "offload_optimizer": "cpu"},
]
ZERO_ERRORS = [
    {"offload_optimizer": "disk"},
    {"offload_param": "nvme"},  # params-to-nvme
    {"offload_param": {"device": "nvme", "nvme_path": "/x"}},
    {"offload_grad_dtype": "fp16"},
    {"offload_optimizer": "cpu", "offload_pipeline": True},
    {"offload_optimizer": {"device": "cpu", "pipeline": True}},
    {"offload_param": "cpu", "offload_pipeline": True},
]


@pytest.mark.parametrize("z", ZERO_FORMS, ids=str)
def test_offload_forms_parse_as_jax(z):
    j, t = JZeroConfig(**dict(z)), ZeroConfig(**dict(z))
    for f in ("offload_optimizer", "offload_param", "offload_nvme_path", "offload_pipeline",
              "offload_grad_dtype"):
        assert getattr(t, f) == getattr(j, f), f
    jc = j_parse_config({"zero_optimization": dict(z)}, dp_world_size=1)
    tc = parse_config({"zero_optimization": dict(z)}, dp_world_size=1)
    assert tc.zero_optimization.offload_optimizer == jc.zero_optimization.offload_optimizer
    assert tc.zero_optimization.offload_cpu == (
        tc.zero_optimization.offload_optimizer != "nvme"
        and "cpu" in (jc.zero_optimization.offload_optimizer, jc.zero_optimization.offload_param))


@pytest.mark.parametrize("z", ZERO_ERRORS, ids=str)
def test_offload_config_errors_are_jaxs(z):
    with pytest.raises(JConfigError) as jerr:
        JZeroConfig(**dict(z))
    with pytest.raises(ConfigError) as terr:
        ZeroConfig(**dict(z))
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("aio", [{}, {"thread_count": 4, "queue_depth": 64},
                                 {"block_size": 4096, "single_submit": True,
                                  "overlap_events": False}])
def test_aio_section_parses_as_jax(aio):
    t = parse_config({"aio": aio}).aio
    assert dataclasses.asdict(t) == dataclasses.asdict(JAIOConfig(**aio))
    with pytest.raises(ConfigError, match="unknown config key 'threads' for AIOConfig"):
        parse_config({"aio": {"threads": 2}})


def test_no_offload_key_is_refused_as_unported():
    for z in ZERO_FORMS:
        parse_config({"zero_optimization": dict(z), "aio": {"queue_depth": 8}})


# ---------------------------------------------------------------------------
# the CPU tier
# ---------------------------------------------------------------------------
_TIER_RUNS = {}


def _tier_run(jp, opt):
    """The CPU tier under ``opt`` trained on ``_batches(4)``: (engine,
    losses), made once per module and optimizer (``test_cpu_tier_equals_
    the_plain_engine`` and ``test_cpu_tier_matches_jax_cpu_offload`` read
    the same run; neither trains it further)."""
    if opt not in _TIER_RUNS:
        tier = _torch_engine(jp, optimizer=OPTIMIZERS[opt], **_zero(offload_optimizer="cpu"))
        _TIER_RUNS[opt] = tier, _train(tier, _batches(4))
    return _TIER_RUNS[opt]


@pytest.fixture(scope="module", autouse=True)
def release_tier_runs():
    yield
    _TIER_RUNS.clear()


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_cpu_tier_equals_the_plain_engine(jparams, opt):
    """Losses and masters bit-identical to the plain engine for every
    optimizer, GAS 2 with clipping; the state streamed in many chunks."""
    _, jp = jparams
    batches = _batches(4)
    plain = _torch_engine(jp, optimizer=OPTIMIZERS[opt])
    tier, losses = _tier_run(jp, opt)
    assert tier._offload is not None and len(tier._offload.chunks) > 5
    assert losses == _train(plain, batches)
    for a, b in zip(plain._params_list, tier._params_list):
        assert torch.equal(a.detach(), b)
    for a, b in zip(_state_leaves(plain.opt_state), _state_leaves(tier.opt_state)):
        assert torch.equal(a, b)
    assert tier.opt_state["count"].item() == 4
    launches = tier._offload.chunk_launches
    assert launches == 4 * len(tier._offload.chunks)


def _state_leaves(state):
    out = []
    for k in sorted(state):
        v = state[k]
        out += _state_leaves(v) if isinstance(v, dict) else (v if isinstance(v, list) else [v])
    return out


def test_cpu_tier_bf16_equals_the_plain_engine(jparams):
    """In bf16 the compute copy is the autograd leaf and each gradient is
    folded into the fp32 buffer as it lands; the plain engine
    differentiates through the cast of its masters: the same numbers."""
    _, jp = jparams
    batches = _batches(3)
    over = dict(bf16={"enabled": True})
    plain = _torch_engine(jp, dtype=torch.bfloat16, **over)
    tier = _torch_engine(jp, dtype=torch.bfloat16, **over, **_zero(offload_param="cpu"))
    assert _train(tier, batches) == _train(plain, batches)
    for a, b in zip(plain._params_list, tier._params_list):
        assert torch.equal(a.detach(), b)
    leaves = [t for v in _flat(tier._compute.loss_tree).values()
              for t in (v if isinstance(v, tuple) else (v,))]
    assert len(leaves) > len(tier._compute.leaves)  # one a layer of each stacked weight
    for leaf in leaves:  # no gradient kept on the compute copy
        assert leaf.requires_grad and leaf.grad is None and leaf.dtype == torch.bfloat16


def test_cpu_tier_fp16_overflow_skip_equals_the_plain_engine(jparams):
    _, jp = jparams
    batches = _batches(3)
    over = dict(fp16={"enabled": True, "initial_scale_power": 30}, bf16={"enabled": False})
    plain = _torch_engine(jp, dtype=torch.float16, **over)
    tier = _torch_engine(jp, dtype=torch.float16, **over, **_zero(offload_optimizer="cpu"))
    assert _train(tier, batches) == _train(plain, batches)
    tier.get_last_loss(), plain.get_last_loss()  # settle the deferred skip counts
    assert tier.skipped_steps == plain.skipped_steps > 0
    for a, b in zip(plain._params_list, tier._params_list):
        assert torch.equal(a.detach(), b)


@pytest.mark.parametrize("opt", ["adamw", "lion"])
def test_cpu_tier_matches_jax_cpu_offload(jparams, opt):
    jcfg, jp = jparams
    batches = _batches(4)
    over = dict(optimizer=OPTIMIZERS[opt], **_zero(offload_optimizer="cpu"))
    jeng = _jax_engine(jcfg, jp, **over)
    assert jeng._offload_cpu
    j_losses = _train(jeng, batches)
    teng, t_losses = _tier_run(jp, opt)  # the run test_cpu_tier_equals_the_plain_engine holds
    np.testing.assert_allclose(t_losses, j_losses, **ENGINE_TOL)
    fj = _flat(jax.tree_util.tree_map(np.asarray, jeng.state.params))
    ft = _masters(teng)
    assert set(fj) == set(ft)
    for k in fj:
        np.testing.assert_allclose(ft[k].numpy(), fj[k], err_msg=k, **ENGINE_TOL)


def test_cpu_tier_forward_backward_step_equals_train_batch(jparams):
    """The reference's piecewise API under the tier (JAX
    ``test_cpu_offload_gas_and_shim``) takes the same step as
    ``train_batch``."""
    _, jp = jparams
    batches = _batches(2)
    fused = _torch_engine(jp, **_zero(offload_optimizer="cpu"))
    piece = _torch_engine(jp, **_zero(offload_optimizer="cpu"))
    for b in batches:
        fused.train_batch(b)
        for i in range(2):
            piece.forward({"input_ids": b["input_ids"][i]})
            piece.backward()
            piece.step()
    assert piece.global_steps == fused.global_steps == 2
    for a, b in zip(fused._params_list, piece._params_list):
        assert torch.equal(a, b)
    assert float(piece.eval_batch({"input_ids": batches[0]["input_ids"][0]})) == float(
        fused.eval_batch({"input_ids": batches[0]["input_ids"][0]}))


def test_cpu_tier_train_on_loader_and_checkpoint_resume(jparams, tmp_path):
    """train_on_loader drives the tier; a save after step 1, a load into a
    fresh engine and 2 more steps equal the uninterrupted run bit for bit,
    and the checkpoint loads into the plain engine too (the same leaves)."""
    _, jp = jparams
    batches = _batches(3)
    zero = _zero(offload_optimizer="cpu")
    ref = _torch_engine(jp, **zero)
    ref_losses = [float(x) for x in ref.train_on_loader(iter(batches))]
    run = _torch_engine(jp, **zero)
    run.train_batch(batches[0])
    run.save_checkpoint(str(tmp_path), tag="s1")
    resumed = _torch_engine(jp, **zero)
    resumed.load_checkpoint(str(tmp_path), tag="s1")
    assert _train(resumed, batches[1:]) == ref_losses[1:]
    for a, b in zip(ref._params_list, resumed._params_list):
        assert torch.equal(a, b)
    plain = _torch_engine(jp)
    plain.load_checkpoint(str(tmp_path), tag="s1")
    assert _train(plain, batches[1:]) == ref_losses[1:]


def test_cpu_tier_memory_breakdown_reports_host_state(jparams):
    _, jp = jparams
    eng = _torch_engine(jp, **_zero(offload_optimizer="cpu"))
    rep = eng.memory_breakdown()
    n = eng._offload.masters.numel()
    off = rep["offload"]
    assert off["tier"] == "cpu" and off["host_state_bytes"] == 12 * n
    assert off["device_grad_bytes"] == 4 * n and off["device_compute_bytes"] == 4 * n
    assert off["pinned_bytes"] == 0  # a CPU device pins nothing
    assert rep["master_params_bytes"] == 4 * n
    assert rep["opt_state_bytes"] == 8 * n + 4  # mu, nu and the count


# ---------------------------------------------------------------------------
# the NVMe tier
# ---------------------------------------------------------------------------
def _nvme(path, **extra):
    return _zero(offload_optimizer={"device": "nvme", "nvme_path": str(path), **extra})


@pytest.mark.parametrize("gas,wire", [(1, "fp32"), (2, "fp32"), (2, "bf16")])
def test_nvme_tier_matches_jax_nvme_engine(jparams, tmp_path, gas, wire):
    jcfg, jp = jparams
    batches = _batches(4, gas=gas)
    over = dict(gradient_accumulation_steps=gas)
    if wire == "bf16":
        # an embedding entry whose two micro-batch gradients cancel rounds to
        # another bf16 value on either side of fp32 summation noise, and Adam
        # at eps 1e-8 turns that into a whole step of lr; eps 1e-4 keeps the
        # comparison about the wire (as test_torch_sparse_attention.py does)
        over["optimizer"] = {"type": "adamw", "params": {"weight_decay": 0.1, "eps": 1e-4}}
    z = _nvme(tmp_path / "j")
    z["zero_optimization"]["offload_grad_dtype"] = wire
    jeng = _jax_engine(jcfg, jp, **over, **z)
    j_losses = _train(jeng, batches)
    z = _nvme(tmp_path / "t")
    z["zero_optimization"]["offload_grad_dtype"] = wire
    teng = _torch_engine(jp, **over, **z)
    assert teng.opt_state == {} and os.listdir(tmp_path / "t")
    np.testing.assert_allclose(_train(teng, batches), j_losses, **ENGINE_TOL)
    from deepspeed_tpu.checkpoint.saving import export_fp32_state_dict as j_export

    fj = _flat(jax.tree_util.tree_map(np.asarray, j_export(jeng)))
    ft = _masters(teng)
    assert set(fj) == set(ft)
    for k in fj:
        np.testing.assert_allclose(ft[k].numpy(), fj[k], err_msg=k, **ENGINE_TOL)
    # the same swap files, by name
    assert sorted(os.listdir(tmp_path / "j")) == sorted(os.listdir(tmp_path / "t"))


def test_nvme_tier_against_the_plain_engine(jparams, tmp_path):
    """The host AdamW walk against K8's plain version over the engine's
    flat buffers: within NVME_TOL of max |p| after 3 steps."""
    _, jp = jparams
    batches = _batches(3)
    plain = _torch_engine(jp)
    nvme = _torch_engine(jp, **_nvme(tmp_path))
    pl, nl = _train(plain, batches[:1]), _train(nvme, batches[:1])
    got, ref = _masters(nvme), {k: v.detach().clone() for k, v in _flat(plain.params).items()}
    scale = max(float(v.abs().max()) for v in ref.values())
    assert max(float((got[k] - v).abs().max()) for k, v in ref.items()) / scale <= 1e-6
    pl, nl = pl + _train(plain, batches[1:]), nl + _train(nvme, batches[1:])
    assert pl[0] == nl[0]
    np.testing.assert_allclose(nl, pl, rtol=1e-5)
    got = _masters(nvme)
    ref = {k: v.detach() for k, v in _flat(plain.params).items()}
    scale = max(float(v.abs().max()) for v in ref.values())
    err = max(float((got[k] - v).abs().max()) for k, v in ref.items()) / scale
    assert 0 < err <= NVME_TOL, err


def test_nvme_pipelined_trains_and_first_loss_equals_sequential(jparams, tmp_path):
    """``offload_pipeline``: the first step equals the sequential engine's
    (no walk applied yet), the step after it runs one walk stale, as JAX's
    does; the flushed state is exact for eval and export."""
    jcfg, jp = jparams
    batches = _batches(5)
    seq = _torch_engine(jp, **_nvme(tmp_path / "s"))
    pipe = _torch_engine(jp, **_nvme(tmp_path / "p", pipeline_read=True))
    jpipe = _jax_engine(jcfg, jp, **_nvme(tmp_path / "j", pipeline_read=True))
    s_losses, p_losses, j_losses = _train(seq, batches), _train(pipe, batches), _train(
        jpipe, batches)
    assert p_losses[0] == s_losses[0] and p_losses != s_losses
    np.testing.assert_allclose(p_losses, j_losses, **ENGINE_TOL)
    pipe.flush_nvme_pipeline()
    jpipe.flush_nvme_pipeline()
    assert pipe._nvme_walk_span is not None
    fj = _flat(jax.tree_util.tree_map(np.asarray, jpipe.state.params))
    for k, v in _flat(pipe.params).items():
        np.testing.assert_allclose(v.detach().numpy(), fj[k], err_msg=k, **ENGINE_TOL)


def test_nvme_pipeline_walk_overlaps_next_dispatch(jparams, tmp_path, monkeypatch):
    """With the walk slowed, the engine's own timeline shows a gradient
    dispatch strictly inside a walk's [start, end] span (JAX
    ``test_nvme_pipeline_walk_overlaps_next_dispatch``)."""
    _, jp = jparams
    orig = NVMeOptimizer.step

    def slow_step(self, *a, **kw):
        out = orig(self, *a, **kw)
        time.sleep(0.3)
        return out

    monkeypatch.setattr(NVMeOptimizer, "step", slow_step)
    eng = _torch_engine(jp, **_nvme(tmp_path, pipeline=True))
    for b in _batches(3):
        eng.train_batch(b)
    eng.flush_nvme_pipeline()
    spans, start = [], None
    for kind, t in eng._nvme_timeline:
        if kind == "walk_start":
            start = t
        elif kind == "walk_end" and start is not None:
            spans.append((start, t))
            start = None
    dispatches = [t for kind, t in eng._nvme_timeline if kind == "dispatch"]
    assert len(spans) == 3 and len(dispatches) == 3
    assert any(s < d < e for d in dispatches for s, e in spans), list(eng._nvme_timeline)
    assert not any(t.name.startswith("dst-nvme-walk") and t.is_alive() and eng._nvme_pending
                   for t in threading.enumerate())


def test_nvme_checkpoint_round_trip(jparams, tmp_path):
    """Masters and moments survive save / load through ``nvme_state/``; a
    restored run continues exactly like the uninterrupted one, and the fp32
    export reads the masters, not the compute copy (JAX
    ``test_nvme_checkpoint_round_trip``)."""
    _, jp = jparams
    batches = _batches(5)
    eng = _torch_engine(jp, **_nvme(tmp_path / "a"))
    _train(eng, batches[:2])
    ckpt = str(tmp_path / "ckpt")
    path = eng.save_checkpoint(ckpt)
    assert sorted(os.listdir(os.path.join(path, "nvme_state"))) == sorted(
        os.listdir(tmp_path / "a"))
    tail_ref = _train(eng, batches[2:])
    eng2 = _torch_engine(jp, **_nvme(tmp_path / "b"))
    eng2.load_checkpoint(ckpt)
    assert _train(eng2, batches[2:]) == tail_ref
    sd = export_fp32_state_dict(eng2)
    assert all(v.dtype == torch.float32 for v in _flat(sd).values())
    a, b = _masters(eng), _masters(eng2)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_nvme_swap_state_crosses_packages(jparams, tmp_path):
    """A JAX NVMeOptimizer's saved swap state restores into the port's, and
    the reverse: the same names and raw bytes."""
    _, jp = jparams
    names = ["layers__attn__wq", "embed__embedding"]
    leaves = [jp["layers"]["attn"]["wq"], jp["embed"]["embedding"]]
    jo = JNVMeOptimizer(str(tmp_path / "j"))
    jo.init({"layers": {"attn": {"wq": leaves[0]}}, "embed": {"embedding": leaves[1]}})
    rng = np.random.default_rng(0)
    jgrads = {"embed": {"embedding": rng.normal(size=leaves[1].shape).astype(np.float32)},
              "layers": {"attn": {"wq": rng.normal(size=leaves[0].shape).astype(np.float32)}}}
    jo.step(jgrads, 1e-3, 1)
    jo.save_to(str(tmp_path / "jsave"))
    to = NVMeOptimizer(str(tmp_path / "t"))
    to.init(sorted(names), [torch.tensor(leaves[1]), torch.tensor(leaves[0])])
    to.restore_from(str(tmp_path / "jsave"))
    got = dict(zip(sorted(names), to.export_masters()))
    want = jax.tree_util.tree_map(np.asarray, jo.export_masters())
    np.testing.assert_array_equal(got["embed__embedding"].numpy(), want["embed"]["embedding"])
    np.testing.assert_array_equal(got["layers__attn__wq"].numpy(), want["layers"]["attn"]["wq"])
    to.save_to(str(tmp_path / "tsave"))
    jo2 = JNVMeOptimizer(str(tmp_path / "j2"))
    jo2.init({"layers": {"attn": {"wq": leaves[0]}}, "embed": {"embedding": leaves[1]}})
    jo2.restore_from(str(tmp_path / "tsave"))
    for part in ("master", "m", "v"):
        a = np.fromfile(tmp_path / "jsave" / f"layers__attn__wq.{part}.swp", np.float32)
        b = np.fromfile(tmp_path / "j2" / f"layers__attn__wq.{part}.swp", np.float32)
        np.testing.assert_array_equal(a, b)
    jo.close(), jo2.close(), to.close()


def test_nvme_refusals_are_jaxs(jparams, tmp_path):
    _, jp = jparams
    with pytest.raises(ConfigError, match="requires bf16 \\(no fp16 loss scaling\\)"):
        _torch_engine(jp, dtype=torch.float16, fp16={"enabled": True}, **_nvme(tmp_path))
    with pytest.raises(ConfigError, match="supports adam/adamw \\(host fused kernel\\), "
                                          "got lion"):
        _torch_engine(jp, optimizer=OPTIMIZERS["lion"], **_nvme(tmp_path))
    eng = _torch_engine(jp, **_nvme(tmp_path))
    with pytest.raises(NotImplementedError, match="supports the fused train_batch"):
        eng.forward({"input_ids": _batches(1)[0]["input_ids"][0]})
    rep = eng.memory_breakdown()["offload"]
    assert rep["tier"] == "nvme" and rep["swap_bytes"] == 12 * eng._grad.numel()
