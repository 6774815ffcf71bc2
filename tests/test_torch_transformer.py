"""The port's transformer building blocks (deepspeed_tpu_torch/models/
transformer.py) against the JAX package's on the CPU, fp32: the parameter
layout of ``init_params``, ``params_from_numpy``, ``norm``, ``rope``,
``_activation``, ``mlp_block`` and the lm head.

Tolerance atol 1e-5, rtol 1e-4: one or two fp32 reductions per value,
summed in a different order by the two frameworks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.presets import get_preset

ATOL, RTOL = 1e-5, 1e-4

# the tiny preset and variants that change the parameter tree
VARIANTS = [
    {},
    dict(norm="layernorm", qkv_bias=True, attn_out_bias=True, mlp_bias=True),
    dict(gated_mlp=False, activation="gelu", tie_embeddings=True),
    dict(position="learned", embedding_norm=True, head_bias=True),
    dict(parallel_block=True, norm="layernorm"),  # one shared norm: no mlp_norm
]


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL, rtol=RTOL)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def _pair(over):
    jcfg = j_preset("tiny", dtype=jnp.float32, **over)
    tcfg = get_preset("tiny", dtype=torch.float32, **over)
    jp = jax.tree_util.tree_map(np.asarray, jt.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, jp, tcfg, tt.params_from_numpy(jp, tcfg, device="cpu")


@pytest.mark.parametrize("over", VARIANTS)
def test_init_params_layout_and_conversion(over):
    _, jp, tcfg, tp = _pair(over)
    assert _shapes(tt.init_params(tcfg, seed=0, device="cpu")) == _shapes(jp) == _shapes(tp)
    flat_j = jax.tree_util.tree_leaves(jp)
    flat_t = jax.tree_util.tree_leaves(tp)
    assert all(np.array_equal(j, t.numpy()) for j, t in zip(flat_j, flat_t))
    assert all(t.dtype == torch.float32 for t in flat_t)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_jax(kind):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3 + 1
    w = {"scale": rng.normal(size=64).astype(np.float32)}
    if kind == "layernorm":
        w["bias"] = rng.normal(size=64).astype(np.float32)
    want = jt.norm(jnp.asarray(x), {k: jnp.asarray(v) for k, v in w.items()}, kind, 1e-5)
    got = tt.norm(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in w.items()},
                  kind, 1e-5)
    _close(got, want)


@pytest.mark.parametrize("pos_shape", [(7,), (2, 7)])
def test_rope_half_split_matches_jax(pos_shape):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 4000, pos_shape).astype(np.int32)
    want = jt.rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0)
    got = tt.rope(torch.from_numpy(x), torch.from_numpy(pos), 500_000.0)
    _close(got, want)


@pytest.mark.parametrize("over", VARIANTS)
def test_mlp_block_and_head_match_jax(over):
    jcfg, jp, tcfg, tp = _pair(over)
    x = np.random.default_rng(2).normal(size=(3, 64)).astype(np.float32)
    jl = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), jp["layers"]["mlp"])
    tl = {k: v[0] for k, v in tp["layers"]["mlp"].items()}
    _close(tt.mlp_block(tl, torch.from_numpy(x), tcfg),
           jt.mlp_block(jl, jnp.asarray(x), jcfg))
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    _close(tt.head_kernel(tp, tcfg), jt.head_kernel(jparams, jcfg))
    jb, tb = jt.head_bias_vec(jparams), tt.head_bias_vec(tp)
    assert (jb is None) == (tb is None)
    if tb is not None:
        _close(tb, jb)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_activation_matches_jax(name):
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    _close(tt._activation(name)(torch.from_numpy(x)), jt._activation(name)(jnp.asarray(x)))
