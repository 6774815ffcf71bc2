"""The fused AdamW (K8): the port against the JAX package, on the CPU.

- ``fused_adamw_flat`` (K8's plain version, what a CPU tensor runs) against
  JAX ``fused_adamw_flat`` run in interpret mode, over 3 steps with weight
  decay 0 and 0.1: p, m and v within rtol 1e-6, plus an absolute floor of
  1e-6 x the buffer's largest magnitude.  Both compute in fp32, but XLA
  may round in another order (contracting a multiply and an add, for
  one); where a sum cancels (an m or a p near 0) the result keeps the
  absolute error of its terms, one of their ulps, which no relative bound
  on the small result can hold.  The floor is ``chip_smoke.K8_TOL``'s
  criterion on the card.
- ``fused_adamw_tree`` against JAX ``fused_adamw_tree`` (``ravel_pytree``)
  on a nested tree of odd-sized leaves.
- A ``finite = False`` step leaves p, m, v (and, through the optimizer, the
  count) bit-identical, where a real step moves them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import fused_adam as jfa

from deepspeed_tpu_torch.ops.kernels import fused_adam as K8
from deepspeed_tpu_torch.ops.optimizers import build_optimizer

RTOL = 1e-6


def _close(got, want, msg):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()), err_msg=msg)


def _buffers(n, seed):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=n).astype(np.float32)
    grads = [(rng.normal(size=n) * 1e-2).astype(np.float32) for _ in range(3)]
    return p, grads


def _jax_interpreted(fn, *args, **kw):
    jfa.set_interpret(True)
    try:
        return fn(*args, **kw)
    finally:
        jfa.set_interpret(False)


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_flat_matches_interpreted_pallas_over_three_steps(wd):
    """n 1024 (one JAX tile), lr and step as one-element tensors, as the
    engine passes them; each step starts both from their own state."""
    n, lr = 1024, 1e-2
    p0, grads = _buffers(n, seed=int(wd * 10))
    jp, jm, jv = jnp.asarray(p0), jnp.zeros(n, jnp.float32), jnp.zeros(n, jnp.float32)
    tp, tm, tv = torch.from_numpy(p0.copy()), torch.zeros(n), torch.zeros(n)
    for t, g in enumerate(grads, start=1):
        jp, jm, jv = _jax_interpreted(jfa.fused_adamw_flat, jp, jnp.asarray(g), jm, jv,
                                      jnp.asarray(lr, jnp.float32),
                                      jnp.asarray(t, jnp.int32), wd=wd)
        out = K8.fused_adamw_flat(tp, torch.from_numpy(g), tm, tv, torch.tensor(lr),
                                  torch.tensor(t, dtype=torch.int32), wd=wd)
        assert all(a is b for a, b in zip(out, (tp, tm, tv)))  # in place
        for name, got, want in (("p", tp, jp), ("m", tm, jm), ("v", tv, jv)):
            _close(got, want, f"{name} t={t}")
    assert not np.array_equal(tp.numpy(), p0)


def _tree(rng, scale=1.0):
    return {"embed": (rng.normal(size=(37, 8)) * scale).astype(np.float32),
            "layers": {"w": (rng.normal(size=(3, 5, 7)) * scale).astype(np.float32),
                       "b": (rng.normal(size=(11,)) * scale).astype(np.float32)}}


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_tree_matches_interpreted_pallas(wd):
    """A nested tree of 296 + 105 + 11 elements: 3 steps of ravel -> update
    -> unravel; the port's inputs stay as they were."""
    rng = np.random.default_rng(5)
    params = _tree(rng)
    zeros = _map(np.zeros_like, params)
    jstate = [_map(jnp.asarray, x) for x in (params, zeros, zeros)]
    tstate = [_map(torch.from_numpy, x) for x in (params, zeros, zeros)]
    for t in (1, 2, 3):
        grads = _tree(rng, scale=1e-2)
        jstate = list(_jax_interpreted(jfa.fused_adamw_tree, *jstate[:1],
                                       _map(jnp.asarray, grads), *jstate[1:], lr=1e-2,
                                       step=t, wd=wd))
        before = [dict(_leaves(_map(torch.clone, x))) for x in tstate]
        new = K8.fused_adamw_tree(tstate[0], _map(torch.from_numpy, grads), tstate[1],
                                  tstate[2], lr=1e-2, step=t, wd=wd)
        for old, cur in zip(before, tstate):
            assert all(torch.equal(old[k], v) for k, v in _leaves(cur))
        tstate = list(new)
        for got_tree, want_tree in zip(tstate, jstate):
            want = dict(_leaves(want_tree))
            for key, got in _leaves(got_tree):
                assert got.shape == want[key].shape, key
                _close(got, want[key], f"{key} t={t}")


def test_finite_false_changes_no_bit():
    """Directly and through the optimizer (the engine's fp16 overflow skip):
    p, m, v and the count bit-identical after a step whose gradient is inf
    and whose ``finite`` flag is false."""
    p0, grads = _buffers(1000, seed=9)
    p, m, v = torch.from_numpy(p0.copy()), torch.zeros(1000), torch.zeros(1000)
    lr = torch.tensor(1e-2)
    K8.fused_adamw_flat(p, torch.from_numpy(grads[0]), m, v, lr, 1, wd=0.1)
    before = [x.clone() for x in (p, m, v)]
    bad = torch.full((1000,), float("inf"))
    K8.fused_adamw_flat(p, bad, m, v, lr, 2, wd=0.1, finite=torch.tensor(False))
    assert all(torch.equal(a, b) for a, b in zip(before, (p, m, v)))
    K8.fused_adamw_flat(p, torch.from_numpy(grads[1]), m, v, lr, 2, wd=0.1,
                        finite=torch.tensor(True))
    assert not torch.equal(before[0], p)

    opt = build_optimizer("fusedadam", {"weight_decay": 0.1})
    state = opt.init([p])
    opt.step([p], [torch.from_numpy(grads[2])], state, lr)
    snap = [x.clone() for x in (p, state["mu"][0], state["nu"][0], state["count"])]
    opt.step([p], [bad], state, lr, finite=torch.tensor(False))
    assert all(torch.equal(a, b)
               for a, b in zip(snap, (p, state["mu"][0], state["nu"][0], state["count"])))
    assert int(state["count"]) == 1
