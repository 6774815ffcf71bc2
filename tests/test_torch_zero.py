"""ZeRO across processes: the port's engine on a world of 2 gloo ranks on
the CPU against the JAX engine on 2 of the forced CPU devices
(``tests/conftest.py``), in fp32 on ``tiny`` with JAX's
``init_params(PRNGKey(0))``.

One spawned world (``tests/torch_world.py``) runs every case of the module
and the JAX references are built once: stages 0-3 (stage 3 also without
remat and under full remat), a global batch whose ranks hold unequal
numbers of valid tokens, an fp16 overflow on one rank, and a checkpoint
saved at 2 ranks that a one-device engine resumes.  Each case's comms
logger counts must equal ``runtime.zero.predicted_comm_counts``.  The
plans are compared with JAX's leaf by leaf on the host.

Tolerances (fp32): losses and gradient norms atol 1e-5 / rtol 1e-4, the
training engine's (``test_torch_training.py``): the ranks reduce the same
products in another order than XLA's reduction over the devices.
Parameters after 3 AdamW steps atol 5e-5 / rtol 1e-4: Adam divides by
``sqrt(v) + eps``, which amplifies an ulp of a near-zero gradient entry;
on this config JAX's own 1-device and 2-device engines differ by 1.8e-5
in one element, and the port's one-device engine from JAX's by 2.8e-5.
The resumed losses equal the uninterrupted run's to 1e-6 relative (the
same tensors in the same order, only gathered and sliced).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.config.config import ZeroConfig as JZeroConfig
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.parallel.topology import MeshSpec as JMeshSpec
from deepspeed_tpu.parallel.topology import initialize_mesh
from deepspeed_tpu.runtime import zero as jzero

import torch_world as W
import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.config.config import ZeroConfig
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.parallel.topology import MeshSpec
from deepspeed_tpu_torch.runtime import zero as tzero
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

TOL = dict(atol=1e-5, rtol=1e-4)
PARAM_TOL = dict(atol=5e-5, rtol=1e-4)
STEPS = 3
GAS = 2
GLOBAL_MICRO = 4


def config(stage, micro, **over):
    cfg = {"train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": GAS,
           "optimizer": {"type": "adamw", "params": {"lr": 3e-3, "weight_decay": 0.1}},
           "gradient_clipping": 0.5, "bf16": {"enabled": False}, "steps_per_print": 1000,
           "zero_optimization": {"stage": stage, "param_persistence_threshold": 0}}
    cfg.update(over)
    return cfg


def _batches(n, seed=7, labels=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if not labels:
            out.append({"input_ids": rng.integers(0, 256, (GAS, GLOBAL_MICRO, 17)).astype(np.int64)})
            continue
        ids = rng.integers(0, 256, (GAS, GLOBAL_MICRO, 16)).astype(np.int64)
        lab = rng.integers(0, 256, (GAS, GLOBAL_MICRO, 16)).astype(np.int64)
        lab[:, :2, 3:] = -100  # rank 0's rows keep 3 tokens a row, rank 1's all 16
        lab[1, 2, 5:] = -100
        out.append({"input_ids": ids, "labels": lab})
    return out


def _save_batches(path, batches):
    np.savez(path, **{f"{i}/{k}": v for i, b in enumerate(batches) for k, v in b.items()})


def _jax_run(jcfg, jp, cfg, batches, **mesh):
    engine, *_ = jds.initialize(model=jt.CausalLM(jcfg),
                                params=jax.tree_util.tree_map(jnp.asarray, jp), config=cfg,
                                mesh=initialize_mesh(devices=jax.devices()[:2], **mesh))
    losses, norms = [], []
    for b in batches:
        losses.append(float(engine.train_batch({k: v.astype(np.int32) for k, v in b.items()})))
        norms.append(engine.get_global_grad_norm())
    params = W._flat(jax.tree_util.tree_map(np.asarray, engine.state.params))
    return {"losses": losses, "norms": norms, "params": params}


STAGE_CASES = {"s0": (0, "selective"), "s1": (1, "selective"), "s2": (2, "selective"),
               "s3": (3, "selective"), "s3-none": (3, "none"), "s3-full": (3, "full")}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero_world")
    jcfg = j_preset("tiny", dtype=jnp.float32)
    jp = jax.tree_util.tree_map(np.asarray, jt.init_params(jax.random.PRNGKey(0), jcfg))
    W.save_tree(tmp / "params.npz", jp)
    plain, tok = _batches(STEPS), _batches(STEPS, seed=11, labels=True)
    ckpt_batches = _batches(4, seed=13)
    _save_batches(tmp / "plain.npz", plain)
    _save_batches(tmp / "tok.npz", tok)
    _save_batches(tmp / "ckpt.npz", ckpt_batches)
    micro = GLOBAL_MICRO // 2
    common = dict(params=str(tmp / "params.npz"))
    logged = {"comms_logger": {"enabled": True}}
    cases = [dict(name=n, kind="train", config=config(s, micro, **logged), remat=r,
                  batches=str(tmp / "plain.npz"), **common)
             for n, (s, r) in STAGE_CASES.items()]
    cases += [
        dict(name="tokens", kind="train", config=config(2, micro, **logged),
             batches=str(tmp / "tok.npz"), **common),
        dict(name="ckpt", kind="train", config=config(3, micro), batches=str(tmp / "ckpt.npz"),
             ckpt=str(tmp / "ckpt"), ckpt_after=2, **common),
        dict(name="overflow1", kind="fn", fn="overflow", stage=1),
        dict(name="overflow3", kind="fn", fn="overflow", stage=3),
        dict(name="refusals", kind="fn", fn="refusals"),
        dict(name="loader", kind="fn", fn="loader"),
        dict(name="deferred1", kind="fn", fn="deferred", stage=1),
        dict(name="deferred3", kind="fn", fn="deferred", stage=3),
    ]
    ranks = W.spawn(2, cases, tmp)
    refs = {
        "s0": _jax_run(jcfg, jp, config(0, micro), plain, data=2),
        "s1": _jax_run(jcfg, jp, config(1, micro), plain, fsdp=2),
        "s2": _jax_run(jcfg, jp, config(2, micro), plain, fsdp=2),
        "s3": _jax_run(jcfg, jp, config(3, micro), plain, fsdp=2),
        "tokens": _jax_run(jcfg, jp, config(2, micro), tok, fsdp=2),
    }
    return {"ranks": ranks, "refs": refs, "tmp": tmp, "jp": jp,
            "ckpt_batches": ckpt_batches}


@pytest.mark.parametrize("case", sorted(STAGE_CASES))
def test_stage_trains_as_the_jax_engine(world, case):
    """Losses, norms and the final masters of each stage (and stage 3 under
    each remat) equal the JAX engine's on a 2-device mesh."""
    got = world["ranks"][0][case]
    ref = world["refs"]["s3" if case.startswith("s3") else case]
    np.testing.assert_allclose(got["losses"], ref["losses"], **TOL)
    np.testing.assert_allclose(got["norms"], ref["norms"], **TOL)
    assert set(got["params"]) == set(ref["params"])
    for k, v in ref["params"].items():
        np.testing.assert_allclose(got["params"][k], v, err_msg=k, **PARAM_TOL)
    assert got["dp"] == 2
    # both ranks report the same global numbers
    np.testing.assert_array_equal(world["ranks"][1][case]["losses"], got["losses"])


@pytest.mark.parametrize("case", sorted(STAGE_CASES) + ["tokens"])
def test_collectives_are_the_ones_the_plan_predicts(world, case):
    got = world["ranks"][0][case]
    assert got["counts"] == got["predicted"]
    assert world["ranks"][1][case]["counts"] == got["counts"]


def test_stage3_gathers_each_layer_in_the_forward_and_again_in_the_backward(world):
    """Per micro-batch: the ``rest`` group once; each of the 2 layers once
    in the forward and once in the backward without remat, twice each
    (the two checkpointed halves) under selective remat."""
    per_step = {k: world["ranks"][0][k]["counts"]["all_gather@fsdp"] // STEPS
                for k in ("s3-none", "s3-full", "s3")}
    assert per_step == {"s3-none": GAS * (1 + 2 + 2), "s3-full": GAS * (1 + 2 + 2),
                        "s3": GAS * (1 + 4 + 4)}
    assert world["ranks"][0]["s3"]["live_gathered"] == 0


def test_unequal_valid_tokens_take_the_global_token_mean(world):
    """Rank 0's rows keep 3 labels of 16, rank 1's all of them: the loss is
    the mean over the global batch's valid tokens (a mean of the ranks'
    means would differ), as JAX's loss over its global batch."""
    got, ref = world["ranks"][0]["tokens"], world["refs"]["tokens"]
    np.testing.assert_allclose(got["losses"], ref["losses"], **TOL)
    for k, v in ref["params"].items():
        np.testing.assert_allclose(got["params"][k], v, err_msg=k, **PARAM_TOL)


@pytest.mark.parametrize("case", ["overflow1", "overflow3"])
def test_an_overflow_on_one_rank_skips_the_step_on_every_rank(world, case):
    for r in (0, 1):
        res = world["ranks"][r][case]
        assert res["first"] == (1, 0.5, True), (r, res)
        assert res["then_skipped"] == 1 and res["then_moved"]


def test_stage3_keeps_half_the_parameter_bytes_of_one_device(world):
    """Between steps a stage-3 rank keeps its fp32 slices only: half the
    one-device engine's masters (up to the padding of each group)."""
    jp = world["jp"]
    whole = sum(x.size * 4 for x in jax.tree_util.tree_leaves(jp))
    for r in (0, 1):
        got = world["ranks"][r]["s3"]["resident"]
        assert whole / 2 <= got <= whole / 2 + 4 * 8, (got, whole)


def test_a_checkpoint_saved_at_two_ranks_resumes_at_one(world):
    """Stage 3 at 2 ranks saves after 2 of 4 steps; a one-device engine
    loads it and its last 2 losses equal the uninterrupted run's."""
    tmp = world["tmp"]
    model = tt.CausalLM(get_preset("tiny", dtype=torch.float32, attn_impl="flash",
                                   remat="selective"))
    params = tt.params_from_numpy(world["jp"], model.cfg, device="cpu")
    engine, *_ = tds.initialize(model=model, params=params, config=config(0, GLOBAL_MICRO),
                                device="cpu")
    engine.load_checkpoint(str(tmp / "ckpt"))
    assert engine.global_steps == 2
    resumed = [float(engine.train_batch({k: torch.from_numpy(v) for k, v in b.items()}))
               for b in world["ckpt_batches"][2:]]
    np.testing.assert_allclose(resumed, world["ranks"][0]["ckpt"]["losses"][2:], rtol=1e-6)


PLAN_CASES = [
    (1, dict(fsdp=2), {}), (2, dict(fsdp=2), {}), (3, dict(fsdp=2), {}),
    (3, dict(fsdp=2), {"param_persistence_threshold": 5000}), (0, dict(data=2), {}),
    (3, dict(data=2, fsdp=2), {}), (1, dict(fsdp=2, sub=2), {}),
    (3, dict(fsdp=2, sub=2), {"zero_hpz_partition_size": 2}),
    (3, dict(fsdp=2, sub=2), {"mics_shard_size": 2}),
    (2, dict(fsdp=2, sub=2), {"mics_shard_size": 2}),
]


@pytest.mark.parametrize("stage,mesh,zero", PLAN_CASES, ids=lambda x: str(x))
def test_plans_equal_jax_leaf_by_leaf(stage, mesh, zero):
    jcfg = j_preset("llama3_proxy_410m", dtype=jnp.float32, num_layers=2)
    shapes = jax.eval_shape(lambda: jt.init_params(jax.random.PRNGKey(0), jcfg))
    jz = JZeroConfig(stage=stage, **zero)
    tz = ZeroConfig(stage=stage, **zero)
    jplan = jzero.plan_sharding(shapes, jz, JMeshSpec(**mesh))
    tshapes = jax.tree_util.tree_map(lambda s: tuple(s.shape), shapes)
    tplan = tzero.plan_sharding(tshapes, tz, MeshSpec(**mesh))
    for name in ("param_specs", "master_specs"):
        j = W._flat(jax.tree_util.tree_map(tuple, getattr(jplan, name),
                                           is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
        t = W._flat(getattr(tplan, name))
        assert set(j) == set(t)
        for k in j:
            assert tuple(t[k]) == tuple(j[k]), (name, k, t[k], j[k])


def test_what_does_not_train_across_ranks_yet_is_refused_on_every_rank(world):
    """ZeRO-Offload, compression's transform, progressive layer drop, the
    eigenvalue estimator, a compile backend, Lamb over the slices, the
    hybrid engine and a LoRA mask each raise naming item 7; none trains
    as world 1 beside its peers."""
    for r in (0, 1):
        got = world["ranks"][r]["refusals"]
        assert set(got) == {"offload", "compression", "pld", "eigenvalue", "compile", "lamb",
                            "hybrid", "lora"}
        for name, msg in got.items():
            assert "item 7" in msg, (r, name, msg)


def test_the_loader_gives_each_rank_its_rows_of_the_global_batch(world):
    """The sampler's order is JAX's (``data/sampler.py:90-95``): rank r
    takes the r-th half of each global micro-batch, and the two halves are
    the global batch a one-device loader draws."""
    from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedTpuDataLoader

    rows = [{"input_ids": np.full(9, i, np.int64)} for i in range(32)]
    one = DeepSpeedTpuDataLoader(rows, micro_batch_size=4, gradient_accumulation_steps=2,
                                 seed=5)
    want = next(iter(one))["input_ids"][..., 0].numpy()
    got = [world["ranks"][r]["loader"]["ids"] for r in (0, 1)]
    assert got[0].shape == (2, 2)
    np.testing.assert_array_equal(np.concatenate(got, axis=1), want)
    assert world["ranks"][0]["loader"]["len"] == len(one) == 4
    assert world["ranks"][0]["loader"]["loss"] == world["ranks"][1]["loader"]["loss"]


@pytest.mark.parametrize("case", ["deferred1", "deferred3"])
def test_each_rank_draws_one_leaf_at_a_time_and_keeps_its_slices(world, case):
    """``initialize`` without ``params`` in a world: the ranks' slices equal
    those of the tree drawn whole (and those of ``zero.Init``'s
    parameters), and a rank held one random leaf at a time, never the
    tree."""
    for r in (0, 1):
        got = world["ranks"][r][case]
        assert got["deferred"] and got["shapes_meta"]
        assert got["equal_whole"] and got["equal_init"] and got["compute_equal"]
        assert got["largest_leaf"] < got["total"] // 2 and got["slice"] <= got["total"] // 2 + 64


def test_zero_init_draws_the_tree_on_the_host_with_jax_s_plan():
    """``zero.Init`` (JAX :277): ``materialize`` records the plan JAX's
    ``Init.materialize`` would for that grid's shape and returns the
    parameters undrawn (``DeferredParams``: their shapes on the ``meta``
    device); drawn, the tree lies on the host."""
    from types import SimpleNamespace

    jcfg = j_preset("llama3_proxy_410m", dtype=jnp.float32, num_layers=2)
    model = tt.CausalLM(get_preset("llama3_proxy_410m", dtype=torch.float32, num_layers=2))
    conf = {"zero_optimization": {"stage": 3}}
    with tzero.Init(conf, SimpleNamespace(spec=MeshSpec(fsdp=2))) as zi:
        params = zi.materialize(model.init_params, seed=3)
    assert isinstance(params, tzero.DeferredParams)
    assert all(v.is_meta for v in W._flat(params.shapes).values())
    assert all(v.device.type == "cpu" for v in W._flat(params.draw("cpu")).values())
    shapes = jax.eval_shape(lambda: jt.init_params(jax.random.PRNGKey(0), jcfg))
    jplan = jzero.plan_sharding(shapes, JZeroConfig(stage=3), JMeshSpec(fsdp=2))
    j = W._flat(jax.tree_util.tree_map(
        tuple, jplan.param_specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    assert {k: tuple(v) for k, v in W._flat(zi.plan.param_specs).items()} == j
