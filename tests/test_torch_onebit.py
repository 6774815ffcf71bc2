"""The 1-bit optimizers across 2 gloo ranks on the CPU against the JAX
engine on 2 of the forced CPU devices (``data`` 2, ZeRO stage 0), fp32 on
``tiny`` with JAX's ``init_params(PRNGKey(0))``: 1-bit Adam, 0/1 Adam and
1-bit Lamb, 4 steps with ``freeze_step`` 2 (two dense warmup steps, two
compressed ones).  One spawned world runs every case.

Compared: the losses, the parameters and each rank's worker and server
error buffers against the row JAX keeps for that rank, and the comms
logger's counts against the plan's prediction (the warmup's all-reduce,
the compressed phase's two all-to-alls and two all-gathers a step).

Tolerances (fp32): losses atol 1e-5 / rtol 1e-4 (``test_torch_zero.py``'s).
Parameters and error buffers atol 5e-5 / rtol 1e-4, for all but a few
elements: a momentum entry within rounding of 0 takes the opposite sign in
the two packages (the reductions sum in another order), which moves its
error by twice the chunk's scale and its update by ``lr * scale /
sqrt(v)``.  On these runs 11-24 of the 106,816 error entries (0.02 %) and
at most 0.5 % of a leaf's parameters flip; the tests allow 0.1 % and 1 %.
``test_torch_comm.py`` holds ``compressed_allreduce`` itself to JAX's
without such ties.
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
from test_torch_zero import PARAM_TOL, TOL, _batches, _save_batches, config

STEPS = 4
OPTS = {
    "onebitadam": {"lr": 3e-3, "freeze_step": 2, "weight_decay": 0.01},
    "zerooneadam": {"lr": 3e-3, "freeze_step": 2},
    "onebitlamb": {"lr": 3e-3, "freeze_step": 2, "weight_decay": 0.01},
}


def _covering_batches(seed=5):
    """``STEPS`` batches whose two warmup steps put every token id in an
    input position: every embedding row has a gradient, so no element
    enters the compressed phase with a frozen variance of 0 (where the
    update divides a compressed momentum by ``eps`` alone, and a sign that
    rounds differently in the two packages moves the element by ~lr/eps)."""
    rng = np.random.default_rng(seed)
    out = _batches(STEPS, seed=seed)
    ids = rng.permutation(256)
    for i in range(2):
        x = out[i]["input_ids"]
        x[:, :, :16] = ids[i * 128:(i + 1) * 128].reshape(x.shape[0], x.shape[1], 16)
    return out


def _cfg(name, **over):
    return config(0, 2, optimizer={"type": name, "params": OPTS[name]}, **over)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("onebit_world")
    jcfg = j_preset("tiny", dtype=jnp.float32)
    jp = jax.tree_util.tree_map(np.asarray, jt.init_params(jax.random.PRNGKey(0), jcfg))
    W.save_tree(tmp / "params.npz", jp)
    batches = _covering_batches()
    _save_batches(tmp / "b.npz", batches)
    cases = [dict(name=n, kind="train", config=_cfg(n, comms_logger={"enabled": True}),
                  batches=str(tmp / "b.npz"), params=str(tmp / "params.npz")) for n in OPTS]
    ranks = W.spawn(2, cases, tmp)
    refs = {}
    for n in OPTS:
        engine, *_ = jds.initialize(model=jt.CausalLM(jcfg),
                                    params=jax.tree_util.tree_map(jnp.asarray, jp),
                                    config=_cfg(n),
                                    mesh=initialize_mesh(devices=jax.devices()[:2], data=2))
        losses = [float(engine.train_batch({k: v.astype(np.int32) for k, v in b.items()}))
                  for b in batches]
        st = engine.state.opt_state
        refs[n] = {"losses": losses,
                   "params": W._flat(jax.tree_util.tree_map(np.asarray, engine.state.params)),
                   "worker_error": np.asarray(st.worker_error),
                   "server_error": np.asarray(st.server_error)}
    return {"ranks": ranks, "refs": refs}


def _close_but(got, want, share, what):
    """All but ``share`` of the elements within ``PARAM_TOL``."""
    bad = ~np.isclose(got, want, **PARAM_TOL)
    assert bad.mean() <= share, (what, int(bad.sum()), bad.size)


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_onebit_trains_as_the_jax_engine(world, opt):
    got, ref = world["ranks"][0][opt], world["refs"][opt]
    np.testing.assert_allclose(got["losses"], ref["losses"], **TOL)
    for k, v in ref["params"].items():
        _close_but(got["params"][k], v, 0.01, k)


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_error_buffers_agree_with_jax_rank_by_rank(world, opt):
    ref = world["refs"][opt]
    for r in (0, 1):
        got = world["ranks"][r][opt]["errors"]
        for k in ("worker_error", "server_error"):
            assert np.abs(ref[k][r]).max() > 0  # the compressed phase ran
            _close_but(got[k], ref[k][r], 0.001, f"{k} rank {r}")


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_onebit_collectives_are_the_ones_the_plan_predicts(world, opt):
    for r in (0, 1):
        got = world["ranks"][r][opt]
        assert got["counts"] == got["predicted"]
    counts = world["ranks"][0][opt]["counts"]
    assert counts["all_to_all@data"] == 2 * (STEPS - 2)  # signs and scales a step


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_compressed_step_reports_the_norm_of_its_momentum(world, opt):
    """The last (compressed) step's gradient norm is the norm of the
    momentum the compressed all-reduce returned, to fp32 rounding: every
    entry of a chunk has one magnitude, where a plain fp32 accumulation
    on the CPU drifts (to 3.6 % at 96 M entries)."""
    for r in (0, 1):
        got = world["ranks"][r][opt]
        np.testing.assert_allclose(got["norms"][-1], got["m_norm"], rtol=2e-6)
