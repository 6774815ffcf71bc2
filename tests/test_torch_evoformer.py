"""``ops/evoformer.py`` and ``ops/sparse_grads.py`` of the port against the
JAX package's, on the CPU in fp32, on the same numpy-seeded inputs.

Tolerance: atol / rtol 2e-5 for values (JAX's own evoformer tests use it
against numpy), 5e-5 for gradients (the backward sums over s keys and the
MSA rows in other orders).  A chunked call is held against the dense one
of the same package at 1e-6: the chunks compute the same rows the same way.
The embedding lookup's values are exact (a gather); its gradient is a
scatter-add of rows in fp32, held at 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import evoformer as jevo
from deepspeed_tpu.ops.sparse_grads import embedding_lookup as j_lookup

from deepspeed_tpu_torch.ops import evoformer as tevo
from deepspeed_tpu_torch.ops.sparse_grads import embedding_lookup

B, N, S, H, D = 2, 4, 24, 2, 8
VAL, GRAD = 2e-5, 5e-5


@pytest.fixture(scope="module")
def msa():
    rng = np.random.default_rng(0)
    mk = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    q, k, v = mk(B, N, S, H, D), mk(B, N, S, H, D), mk(B, N, S, H, D)
    bias1 = np.where(rng.random((B, N, 1, 1, S)) < 0.2, -1e9, 0.0).astype(np.float32)
    bias2 = mk(B, 1, H, S, S)
    w = mk(B, N, S, H, D)
    return q, k, v, bias1, bias2, w


def _biases(which, b1, b2, conv):
    if which == "none":
        return []
    if which == "bias1":
        return [conv(b1)]
    if which == "bias2":
        return [None, conv(b2)]
    return [conv(b1), conv(b2)]


@pytest.mark.parametrize("chunk", [None, 2])
@pytest.mark.parametrize("which", ["none", "bias1", "bias2", "both"])
def test_values_and_gradients_equal_jax(msa, which, chunk):
    """Each bias subset, dense and chunked over the MSA rows: the output and
    the gradients of q, k, v and of every bias given equal JAX's."""
    q, k, v, b1, b2, w = msa
    jb = _biases(which, b1, b2, jnp.asarray)

    def jloss(q, k, v, *bs):
        bs = list(bs) if which != "bias2" else [None, *bs]
        return jnp.sum(jevo.evoformer_attention(q, k, v, bs, chunk_rows=chunk) * w)

    jargs = [jnp.asarray(x) for x in (q, k, v)] + [b for b in jb if b is not None]
    jval = jevo.evoformer_attention(*jargs[:3], jb, chunk_rows=chunk)
    jgrads = jax.grad(jloss, argnums=tuple(range(len(jargs))))(*jargs)
    targs = [torch.from_numpy(np.array(x)).requires_grad_(True) for x in jargs]
    tb = targs[3:] if which != "bias2" else [None, *targs[3:]]
    got = tevo.evoformer_attention(*targs[:3], tb, chunk_rows=chunk)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jval), rtol=VAL, atol=VAL)
    (got * torch.from_numpy(w)).sum().backward()
    for t, j in zip(targs, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=GRAD, atol=GRAD)


def test_chunked_equals_dense_and_shapes_are_checked(msa):
    q, k, v, b1, b2, _ = msa
    tq, tk, tv, t1, t2 = (torch.from_numpy(x) for x in (q, k, v, b1, b2))
    dense = tevo.DS4Sci_EvoformerAttention(tq, tk, tv, [t1, t2])
    for chunk in (1, 2, 4, 8):
        np.testing.assert_allclose(
            tevo.evoformer_attention(tq, tk, tv, [t1, t2], chunk_rows=chunk).numpy(),
            dense.numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="chunk_rows 3 must divide"):
        tevo.evoformer_attention(tq, tk, tv, [t1, t2], chunk_rows=3)
    with pytest.raises(ValueError, match="bias1 shape"):
        tevo.evoformer_attention(tq, tk, tv, [t1[:, :2]])
    with pytest.raises(ValueError, match="bias2 shape"):
        tevo.evoformer_attention(tq, tk, tv, [None, t2[..., :5]])


@pytest.mark.parametrize("ids_shape", [(7,), (3, 5)])
def test_embedding_lookup_values_and_gradient_equal_jax(ids_shape):
    """Values and the scatter-add gradient (repeated ids included) equal
    JAX's ``embedding_lookup`` outside a data-parallel axis."""
    rng = np.random.default_rng(1)
    table = rng.standard_normal((11, 6)).astype(np.float32)
    ids = rng.integers(0, 11, ids_shape).astype(np.int32)
    ids.flat[0] = ids.flat[-1]  # a repeated row
    w = rng.standard_normal((*ids_shape, 6)).astype(np.float32)
    jval = j_lookup(jnp.asarray(table), jnp.asarray(ids))
    jgrad = jax.grad(lambda t: jnp.sum(j_lookup(t, jnp.asarray(ids)) * w))(jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_(True)
    got = embedding_lookup(tt, torch.from_numpy(ids))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(jval))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-6)
    bf = torch.from_numpy(table).to(torch.bfloat16).requires_grad_(True)
    embedding_lookup(bf, torch.from_numpy(ids)).sum().backward()
    assert bf.grad.dtype == torch.bfloat16  # the fp32 sum cast to the table's type


def test_embedding_lookup_refuses_a_data_parallel_axis():
    with pytest.raises(NotImplementedError, match="item 7"):
        embedding_lookup(torch.zeros(4, 2), torch.zeros(3, dtype=torch.long), axis_name="data")
