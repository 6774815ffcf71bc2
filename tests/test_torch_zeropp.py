"""The grid's other axes and ZeRO++ across 4 gloo ranks on the CPU, against
the JAX engine on 4 of the forced CPU devices, fp32 on ``tiny`` with
JAX's ``init_params(PRNGKey(0))``: ``data`` x ``fsdp`` (2 x 2) at stages 1
and 3, hpZ and MiCS (``fsdp`` 2 x ``sub`` 2, factored by ``initialize``
from the ZeRO keys as JAX factors them), and qwZ + qgZ with and without
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)
LoCo over ``fsdp`` 4.  One spawned world runs every case; the comms
logger's counts must equal the plan's prediction.

Tolerances: the plain layouts as ``test_torch_zero.py`` (losses and norms
atol 1e-5 / rtol 1e-4, parameters atol 5e-5 / rtol 1e-4).  ZeRO++ is lossy
by design and the two packages cut the int8 chunks differently (JAX
quantizes each leaf's shard along its sharded dimension, the port each
group's contiguous slice), so the weights each rank computes with differ
by the int8 rounding of different 256-element chunks: losses rtol 2e-3.
An element whose gradient rounds to 0 in one package and not in the other
takes a different Adam step, which is at most about ``lr`` a step: the
parameters after 3 steps agree to ``2 * 3 * lr`` (1.8e-2) elementwise.
Against the unquantized run the losses move (the quantization is on).
The quantized payloads themselves are byte-equal to JAX's
(``test_torch_comm.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepspeed_tpu as jds
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.parallel.topology import initialize_mesh

import torch_world as W
from test_torch_zero import PARAM_TOL, STEPS, TOL, _batches, _save_batches, config

WORLD = 4
ZPP = {"zero_quantized_weights": True, "zero_quantized_gradients": True}
LOCO = dict(ZPP, zeropp_loco_param={"err_beta": 0.8, "reset_T": 2})
QTOL = dict(rtol=2e-3)
QPARAM_TOL = dict(atol=2 * STEPS * 3e-3, rtol=0)


def _zero(stage, **keys):
    return {"stage": stage, "param_persistence_threshold": 0, **keys}


# name: (config keys, JAX mesh, remat)
CASES = {
    "dxf1": (dict(zero_optimization=_zero(1), mesh={"data": 2, "fsdp": 2}),
             dict(data=2, fsdp=2), "selective"),
    "dxf3": (dict(zero_optimization=_zero(3), mesh={"data": 2, "fsdp": 2}),
             dict(data=2, fsdp=2), "none"),
    "hpz": (dict(zero_optimization=_zero(3, zero_hpz_partition_size=2)),
            dict(fsdp=2, sub=2), "none"),
    "mics": (dict(zero_optimization=_zero(3, mics_shard_size=2)),
             dict(fsdp=2, sub=2), "selective"),
    "zpp": (dict(zero_optimization=_zero(3, **ZPP)), dict(fsdp=4), "selective"),
    "loco": (dict(zero_optimization=_zero(3, **LOCO)), dict(fsdp=4), "none"),
}


def _jax_run(jcfg, jp, cfg, batches, mesh):
    cfg = {k: v for k, v in cfg.items() if k != "mesh"}
    engine, *_ = jds.initialize(model=jt.CausalLM(jcfg),
                                params=jax.tree_util.tree_map(jnp.asarray, jp), config=cfg,
                                mesh=initialize_mesh(devices=jax.devices()[:WORLD], **mesh))
    losses = [float(engine.train_batch({k: v.astype(np.int32) for k, v in b.items()}))
              for b in batches]
    return {"losses": losses, "norm": engine.get_global_grad_norm(),
            "params": W._flat(jax.tree_util.tree_map(np.asarray, engine.state.params))}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zeropp_world")
    jcfg = j_preset("tiny", dtype=jnp.float32)
    jp = jax.tree_util.tree_map(np.asarray, jt.init_params(jax.random.PRNGKey(0), jcfg))
    W.save_tree(tmp / "params.npz", jp)
    plain = _batches(STEPS)
    _save_batches(tmp / "plain.npz", plain)
    logged = {"comms_logger": {"enabled": True}}
    cases = [dict(name=n, kind="train", config=config(1, 1, **over, **logged), remat=r,
                  batches=str(tmp / "plain.npz"), params=str(tmp / "params.npz"))
             for n, (over, _, r) in CASES.items()]
    ranks = W.spawn(WORLD, cases, tmp)
    refs = {n: _jax_run(jcfg, jp, config(1, 1, **over), plain, mesh)
            for n, (over, mesh, _) in CASES.items()}
    return {"ranks": ranks, "refs": refs}


@pytest.mark.parametrize("case", ["dxf1", "dxf3", "hpz", "mics"])
def test_grid_layouts_train_as_the_jax_engine(world, case):
    got, ref = world["ranks"][0][case], world["refs"][case]
    np.testing.assert_allclose(got["losses"], ref["losses"], **TOL)
    np.testing.assert_allclose(got["norms"][-1], ref["norm"], **TOL)
    for k, v in ref["params"].items():
        np.testing.assert_allclose(got["params"][k], v, err_msg=k, **PARAM_TOL)
    for r in range(1, WORLD):
        np.testing.assert_array_equal(world["ranks"][r][case]["losses"], got["losses"])


@pytest.mark.parametrize("case", ["zpp", "loco"])
def test_quantized_collectives_train_near_the_jax_engine(world, case):
    got, ref = world["ranks"][0][case], world["refs"][case]
    np.testing.assert_allclose(got["losses"], ref["losses"], **QTOL)
    for k, v in ref["params"].items():
        np.testing.assert_allclose(got["params"][k], v, err_msg=k, **QPARAM_TOL)
    plain = world["refs"]["dxf3"]["losses"]  # stage 3 unquantized: the same global batch
    assert max(abs(a - b) for a, b in zip(got["losses"], plain)) > 1e-5  # int8 is on


@pytest.mark.parametrize("case", sorted(CASES))
def test_collectives_are_the_ones_the_plan_predicts(world, case):
    for r in range(WORLD):
        got = world["ranks"][r][case]
        assert got["counts"] == got["predicted"], r


def test_grid_axes_carry_their_collectives(world):
    """hpZ gathers within ``sub`` and refreshes its secondary partition
    over ``fsdp``; MiCS keeps every gather and reduce-scatter in ``sub``
    and all-reduces the slices over ``data`` x ``fsdp``; qwZ / qgZ move
    int8 through all-gathers and all-to-alls (no reduce-scatter)."""
    c = {n: world["ranks"][0][n]["counts"] for n in CASES}
    assert {"all_gather@sub", "all_gather@fsdp", "reduce_scatter@sub",
            "reduce_scatter@fsdp"} <= set(c["hpz"])
    assert set(c["mics"]) == {"all_gather@sub", "reduce_scatter@sub", "all_reduce@sub",
                              "all_reduce@data+fsdp", "all_reduce@data+fsdp+sub"}
    assert "all_reduce@data" in c["dxf3"] and "reduce_scatter@fsdp" in c["dxf3"]
    assert "reduce_scatter@fsdp" not in c["zpp"] and c["zpp"]["all_to_all@fsdp"] > 0
