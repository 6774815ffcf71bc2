"""Random-LTD's token routing (``deepspeed_tpu_torch/data/random_ltd.py``)
against the JAX package's, on the CPU: the scheduler's kept-token ramp
equal step for step, gather / scatter equal on the same indices (a copy of
values, so bit for bit), and the sampled indices sorted and unique (the
draw itself is a ``torch.Generator``'s, not JAX's key)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.data import random_ltd as jr

from deepspeed_tpu_torch.data import random_ltd as tr
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)


@pytest.mark.parametrize("start,seq,total,gran", [(32, 128, 100, 16), (40, 100, 7, 16),
                                                  (8, 64, 0, 8), (128, 128, 10, 16)])
def test_scheduler_ramp_equals_jax(start, seq, total, gran):
    j = jr.RandomLTDScheduler(start, seq, total, granularity=gran)
    t = tr.RandomLTDScheduler(start, seq, total, granularity=gran)
    assert t.get_current_seq() == j.get_current_seq()
    for step in (0, 1, 3, 25, 50, 99, 100, 200):
        assert t.update_seq(step) == j.update_seq(step), step
    t2 = tr.RandomLTDScheduler(start, seq, total, granularity=gran)
    t2.load_state_dict(t.state_dict())
    assert t2.get_current_seq() == t.get_current_seq()
    with pytest.raises(ValueError):
        tr.RandomLTDScheduler(seq + 1, seq, total)


def test_gather_scatter_equal_jax_on_the_same_indices():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 40, 8)).astype(np.float32)
    full = rng.normal(size=(3, 40, 8)).astype(np.float32)
    idx = np.sort(np.stack([rng.permutation(40)[:12] for _ in range(3)]), -1)
    jg = jr.gather_tokens(jnp.asarray(x), jnp.asarray(idx))
    tg = tr.gather_tokens(torch.from_numpy(x), torch.from_numpy(idx).long())
    assert np.array_equal(tg.numpy(), np.asarray(jg))
    js = jr.scatter_tokens(jnp.asarray(full), jg * 2.0, jnp.asarray(idx))
    ts = tr.scatter_tokens(torch.from_numpy(full), tg * 2.0, torch.from_numpy(idx).long())
    assert np.array_equal(ts.numpy(), np.asarray(js))


def test_sampled_indices_sorted_unique_and_the_layer_subset():
    gen = torch.Generator().manual_seed(1)
    idx = tr.sample_kept_indices(gen, 4, 64, 16)
    assert idx.shape == (4, 16)
    for row in idx.numpy():
        assert (np.diff(row) > 0).all() and row.min() >= 0 and row.max() < 64
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 64, 8)).astype(np.float32))
    out = tr.random_ltd_layer(x, lambda t: t + 100.0, torch.Generator().manual_seed(0), kept=16)
    changed = (out - x).abs().sum(-1) > 1.0
    assert (changed.sum(1) == 16).all()  # exactly the kept tokens went through the layer
    full = tr.random_ltd_layer(x, lambda t: t + 100.0, None, kept=64)
    np.testing.assert_array_equal(full.numpy(), x.numpy() + 100.0)
