"""The eigenvalue estimator (``deepspeed_tpu_torch/runtime/eigenvalue.py``)
against the JAX package's, on the CPU in fp32, and the repair it needed: a
double backward through the flash attention Functions raises.

- the quadratic's top eigenvalue within 1e-2 relative (as JAX's own test);
- one Hessian-vector product of ``tiny`` against JAX's ``jvp(grad)`` on
  the same ``v``, within 1e-5 relative (Frobenius over every leaf): the two
  frameworks sum the same second-order products in different orders;
- the converged estimates of both packages at tol 1e-5 within 1e-3
  relative (``tiny`` at 1 layer) (their start vectors differ: a ``torch.Generator`` against
  JAX's keys);
- the engine's ``block_eigenvalues`` at the steps JAX's engine records.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.parallel.topology import initialize_mesh
from deepspeed_tpu.runtime.eigenvalue import Eigenvalue as JEigenvalue

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.ops.kernels.flash_attention import flash_attention
from deepspeed_tpu_torch.ops.kernels.sparse_attention import block_sparse_flash_attention
from deepspeed_tpu_torch.runtime.eigenvalue import Eigenvalue, hvp_fn
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def test_eigenvalue_quadratic_exact():
    rng = np.random.default_rng(0)
    m = rng.normal(size=(6, 6))
    a = torch.from_numpy(m @ m.T).float()

    def loss_fn(p, batch, rng_):
        return 0.5 * p["w"] @ a @ p["w"]

    est, vec = Eigenvalue(max_iter=200, tol=1e-5).compute_eigenvalue(
        loss_fn, {"w": torch.zeros(6)}, None)
    true = float(np.linalg.eigvalsh(m @ m.T).max())
    assert abs(est - true) / true < 1e-2, (est, true)
    assert est >= 0 and vec["w"].shape == (6,)


def _tiny(seed=0, layers=2, b=2, s=17):
    jcfg = j_preset("tiny", dtype=jnp.float32, max_seq_len=32, num_layers=layers)
    jp = jax.tree_util.tree_map(np.asarray, jt.init_params(jax.random.PRNGKey(seed), jcfg))
    tokens = np.random.default_rng(1).integers(0, 256, (b, s)).astype(np.int32)
    return jcfg, jp, tokens


def _rel(a, b):
    num = sum(float(np.sum((a[k] - b[k]) ** 2)) for k in b)
    den = sum(float(np.sum(b[k] ** 2)) for k in b)
    return (num / den) ** 0.5


@pytest.mark.parametrize("remat", ["none", "selective"])
def test_hvp_of_tiny_matches_jax_jvp_of_grad(remat):
    """The port's product (a create_graph gradient, then the gradient of
    <g, v>) against JAX's ``jvp(grad)``, on the plain attention body the
    estimator runs; selective remat's checkpoints take the double backward."""
    jcfg, jp, tokens = _tiny()
    rng = np.random.default_rng(2)
    v = jax.tree_util.tree_map(lambda x: rng.normal(size=x.shape).astype(np.float32), jp)
    loss = jt.CausalLM(jcfg).loss_fn
    batch = {"input_ids": jnp.asarray(tokens)}
    grad_fn = jax.grad(lambda p: loss(p, batch, None))
    want = jax.jit(lambda p, t: jax.jvp(grad_fn, (p,), (t,))[1])(
        jax.tree_util.tree_map(jnp.asarray, jp), jax.tree_util.tree_map(jnp.asarray, v))
    tcfg = get_preset("tiny", dtype=torch.float32, max_seq_len=32, attn_impl="reference",
                      remat=remat)
    tp = tt.params_from_numpy(jp, tcfg, device="cpu")
    hvp, leaves = hvp_fn(tt.CausalLM(tcfg).loss_fn, tp, {"input_ids": torch.from_numpy(tokens)})
    tv = tt.params_from_numpy(v, tcfg, device="cpu")
    names = list(_flat(tp))
    got = dict(zip(names, [h.numpy() for h in hvp(list(_flat(tv).values()))]))
    assert _rel(got, _flat(jax.tree_util.tree_map(np.asarray, want))) < 1e-5


def test_converged_estimate_matches_jax():
    jcfg, jp, tokens = _tiny(layers=1, b=1, s=9)  # a 66-iteration run at 2 layers costs more
    tol = 1e-5
    j_est, _ = JEigenvalue(max_iter=300, tol=tol).compute_eigenvalue(
        jt.CausalLM(jcfg).loss_fn, jax.tree_util.tree_map(jnp.asarray, jp),
        {"input_ids": jnp.asarray(tokens)})
    tcfg = get_preset("tiny", dtype=torch.float32, max_seq_len=32, num_layers=1)
    t_est, _ = Eigenvalue(max_iter=300, tol=tol).compute_eigenvalue(
        tt.CausalLM(tcfg).loss_fn, tt.params_from_numpy(jp, tcfg, device="cpu"),
        {"input_ids": torch.from_numpy(tokens)}, generator=torch.Generator().manual_seed(3))
    assert abs(t_est - j_est) / j_est < 1e-3, (t_est, j_est)


def test_engine_block_eigenvalues_at_jaxs_steps():
    jcfg, jp, _ = _tiny()
    cfg = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
           "optimizer": {"type": "adamw", "params": {"lr": 3e-3}}, "bf16": {"enabled": False},
           "eigenvalue": {"enabled": True, "max_iter": 4, "gas_boundary_resolution": 2},
           "steps_per_print": 1000}
    rng = np.random.default_rng(4)
    batches = [{"input_ids": rng.integers(0, 256, (2, 2, 17)).astype(np.int32)}
               for _ in range(5)]
    jengine, _, _, _ = jds.initialize(
        model=jt.CausalLM(jcfg), params=jax.tree_util.tree_map(jnp.asarray, jp), config=cfg,
        mesh=initialize_mesh(devices=jax.devices()[:1], data=1))
    # the engine's model runs the flash Function; the estimator swaps in the
    # plain body, so the double backward does not meet it
    tcfg = get_preset("tiny", dtype=torch.float32, max_seq_len=32, attn_impl="flash",
                      remat="selective")
    engine, _, _, _ = tds.initialize(model=tt.CausalLM(tcfg),
                                     params=tt.params_from_numpy(jp, tcfg, device="cpu"),
                                     config=cfg, device="cpu")
    for b in batches:
        jengine.train_batch(b)
        engine.train_batch(b)
    assert [s for s, _ in engine.block_eigenvalues] == \
        [s for s, _ in jengine.block_eigenvalues] == [2, 4]
    assert all(np.isfinite(e) and e > 0 for _, e in engine.block_eigenvalues)
    assert engine.model.cfg.attn_impl == "flash"


# ---------------------------------------------------------------------------
# the repair: the flash Functions are once-differentiable
# ---------------------------------------------------------------------------
def _double_backward(attn):
    torch.manual_seed(0)
    q, k, v = (torch.randn(1, 256, 2, 64, requires_grad=True) for _ in range(3))
    w = torch.randn(1, 256, 2, 64)
    o = attn(q, k, v)
    loss = (o * w).sum() ** 2 + (q ** 3).sum()
    g, = torch.autograd.grad(loss, q, create_graph=True)
    return torch.autograd.grad((g * torch.randn_like(g)).sum(), q)


def test_double_backward_through_flash_attention_raises():
    """A second derivative through K1's Function used to come back wrong and
    silent (its backward's outputs carry no graph: ``o`` and ``lse`` are
    constants to the plain version, a kernel on the card); now it raises."""
    with pytest.raises(RuntimeError, match="differentiate twice"):
        _double_backward(lambda q, k, v: flash_attention(q, k, v, causal=True))


def test_double_backward_through_sparse_flash_raises():
    layout = np.tril(np.ones((2, 2), bool))

    def attn(q, k, v):
        return block_sparse_flash_attention(q, k, v, layout, 128)

    with pytest.raises(RuntimeError, match="differentiate twice"):
        _double_backward(attn)
