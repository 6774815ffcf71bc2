"""Block-sparse attention: the port against the JAX package, on the CPU.

- The five layout classes give ``np.array_equal`` layouts (BigBird with its
  numpy seed); ``sparse_tables`` equals JAX ``_sparse_tables`` (including
  None for an empty causal row) and ``sparse_supports`` JAX's gate.
- K7's plain versions (what the port's ``SparseFlashFn`` runs on a CPU
  tensor) against JAX ``pallas_block_sparse_attention`` in interpret mode:
  the output and the q / k / v gradients, without and with packed segments
  and a soft cap, at head_dim 256, and at 16 query heads on one kv head with
  the keys' ids (``kv_segment_ids``) apart from the rows'.  Tolerances of ``tests/test_flash_kernel.py:228-235``:
  output atol 2e-5, gradients atol 5e-4 / rtol 1e-3 (fp32; the interpreted
  kernel sums blockwise with an online softmax, the plain body at once).
- ``block_sparse_attention``'s dispatch: a block-16 layout (the masked dense
  body) and a decode-shaped call (dense attention) against JAX's
  ``block_sparse_attention``.
- Training: ``initialize`` with ``sparse_attention`` and FusedAdam against
  the JAX engine over 3 steps in fp32 (``ENGINE_TOL`` of
  ``tests/test_torch_training.py``), at head_dim 16 (both packages run the
  masked dense body) and 64 (the port runs K7's plain versions, JAX on the
  CPU its masked body: the same function).
- Config errors as JAX raises them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.config.config import ConfigError as JConfigError
from deepspeed_tpu.config.config import parse_config as j_parse_config
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.ops.pallas import flash_kernel as jfk
from deepspeed_tpu.parallel.topology import initialize_mesh

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.config.config import ConfigError, parse_config
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.ops.kernels import sparse_attention as K7
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

FWD_TOL = dict(atol=2e-5, rtol=0)
GRAD_TOL = dict(atol=5e-4, rtol=1e-3)
ENGINE_TOL = dict(atol=1e-5, rtol=1e-4)

LAYOUTS = [
    ("Dense", {}),
    ("Fixed", dict(num_local_blocks=4, num_global_blocks=1)),
    ("Fixed", dict(num_local_blocks=3, num_global_blocks=2)),
    ("BigBird", dict(num_random_blocks=2, num_sliding_window_blocks=3, num_global_blocks=1,
                     seed=5)),
    ("BSLongformer", dict(num_sliding_window_blocks=5, global_block_indices=(0, 7))),
    ("Variable", dict(local_window_blocks=(2, 3), num_global_blocks=2)),
]


@pytest.mark.parametrize("name,kw", LAYOUTS)
@pytest.mark.parametrize("block,s", [(16, 256), (128, 4096)])
def test_layouts_match_jax(name, kw, block, s):
    cls = f"{name}SparsityConfig"
    want = getattr(jsa, cls)(block=block, **kw).make_layout(s)
    got = getattr(tsa, cls)(block=block, **kw).make_layout(s)
    assert got.dtype == np.bool_ and np.array_equal(got, want)


def _layout_cases():
    rng = np.random.default_rng(3)
    cases = [tsa.FixedSparsityConfig(block=128).make_layout(4096),
             tsa.BigBirdSparsityConfig(block=128).make_layout(4096),
             rng.random((9, 9)) < 0.4]
    empty_row = np.tril(np.ones((5, 5), bool))
    empty_row[3, :4] = False  # row 3 keeps only a key block above the diagonal
    empty_row[3, 4] = True
    return cases + [empty_row]


@pytest.mark.parametrize("causal", [True, False])
def test_sparse_tables_match_jax(causal):
    for layout in _layout_cases():
        want = jfk._sparse_tables(layout, causal)
        assert K7.sparse_tables(layout, causal) == want
    assert K7.sparse_tables(_layout_cases()[-1], True) is None


def test_sparse_supports_matches_jax():
    cases = [
        # (b, sq, sk, hq, hk, d), block, causal, q_offset, segment ids shape
        ((2, 512, 512, 8, 2, 128), 128, True, 0, None),
        ((2, 512, 512, 8, 2, 64), 256, True, 0, (2, 512)),
        ((1, 1024, 1024, 4, 4, 256), 1024, True, 0, None),
        ((1, 2048, 2048, 4, 4, 128), 2048, True, 0, None),
        ((1, 512, 512, 4, 4, 128), 64, True, 0, None),
        ((1, 500, 500, 4, 4, 128), 128, True, 0, None),
        ((1, 512, 512, 4, 4, 96), 128, True, 0, None),
        ((1, 512, 512, 6, 4, 128), 128, True, 0, None),
        ((1, 512, 512, 4, 4, 128), 128, False, 0, None),
        ((1, 512, 512, 4, 4, 128), 128, True, 3, None),
        ((1, 256, 512, 4, 4, 128), 128, True, 0, None),
        ((2, 512, 512, 4, 4, 128), 128, True, 0, (2, 256)),
    ]
    for (b, sq, sk, hq, hk, d), block, causal, off, seg in cases:
        jq, jk = jnp.zeros((b, sq, hq, d)), jnp.zeros((b, sk, hk, d))
        tq, tk = torch.zeros(b, sq, hq, d), torch.zeros(b, sk, hk, d)
        want = jfk.sparse_supports(jq, jk, jk, block, causal, off,
                                   None if seg is None else jnp.zeros(seg, jnp.int32))
        got = K7.sparse_supports(tq, tk, tk, block, causal, off,
                                 None if seg is None else torch.zeros(seg, dtype=torch.int32))
        assert got == want, (b, sq, sk, hq, hk, d, block, causal, off, seg)


def _qkv(b, s, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32) for h in (hq, hkv, hkv, hq)]


def _grads_port(fn, q, k, v, cot):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fn(tq, tk, tv)
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), [x.grad.numpy() for x in (tq, tk, tv)]


def _grads_jax(fn, q, k, v, cot):
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


# b 1, s 256, block 128: (hq, hkv, head_dim, packed) of each case
K7_CASES = {
    "plain": (4, 2, 64, False),
    "packed": (4, 2, 64, True),
    "hd256": (4, 2, 256, False),
    "group16_kv_segments": (16, 1, 64, True),
}


@pytest.mark.parametrize("case", sorted(K7_CASES))
def test_plain_k7_matches_interpreted_pallas(case):
    """b 1, s 256, block 128.  Unpacked: block (1, 0) off.  Packed: every
    causal block on, segments crossing the block edge and a soft cap; in
    ``group16_kv_segments`` (16 query heads on one kv head) the keys carry
    their own ids (``kv_segment_ids``), packed at other lengths than the
    rows', as the kernels take them apart.  Head_dim 256 and the large
    group are the shapes the tensor-core kernels took on."""
    b, s, block = 1, 256, 128
    hq, hkv, d, packed = K7_CASES[case]
    q, k, v, cot = _qkv(b, s, hq, hkv, d, seed=7 + packed)
    layout, seg, kv_seg, cap = np.eye(2, dtype=bool), None, None, None
    if packed:
        layout = np.ones((2, 2), bool)
        seg = np.zeros((b, s), np.int32)
        seg[:, :100], seg[:, 100:200], seg[:, 200:] = 1, 2, 3
        cap = 5.0
        if case == "group16_kv_segments":
            kv_seg = np.zeros((b, s), np.int32)
            kv_seg[:, :60], kv_seg[:, 60:180], kv_seg[:, 180:] = 1, 2, 3
    tseg, tkv = (None if x is None else torch.from_numpy(x) for x in (seg, kv_seg))
    jseg, jkv = (None if x is None else jnp.asarray(x) for x in (seg, kv_seg))
    got = _grads_port(lambda *a: K7.block_sparse_flash_attention(
        *a, layout, block, segment_ids=tseg, kv_segment_ids=tkv, logits_soft_cap=cap),
        q, k, v, cot)
    jfk.set_interpret(True)
    try:
        want = _grads_jax(lambda *a: jfk.pallas_block_sparse_attention(
            *a, layout, block, segment_ids=jseg, kv_segment_ids=jkv, logits_soft_cap=cap),
            q, k, v, cot)
    finally:
        jfk.set_interpret(False)
    np.testing.assert_allclose(got[0], want[0], **FWD_TOL)
    for name, g, w in zip("qkv", got[1], want[1]):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **GRAD_TOL)


@pytest.mark.parametrize("case", ["block16", "block16_packed", "decode"])
def test_dispatch_matches_jax(case):
    """A block-16 layout runs the masked dense body in both packages; a
    decode-shaped call (one query against a longer cache) runs dense
    attention."""
    b, s, hq, hkv, d = 2, 128, 4, 2, 16
    q, k, v, cot = _qkv(b, s, hq, hkv, d, seed=11)
    kw_t, kw_j = {}, {}
    if case == "block16_packed":
        seg = np.ones((b, s), np.int32)
        seg[:, 50:] = 2
        kw_t["segment_ids"], kw_j["segment_ids"] = torch.from_numpy(seg), jnp.asarray(seg)
    if case == "decode":
        q, cot = q[:, -1:], cot[:, -1:]
        kw_t["q_offset"] = kw_j["q_offset"] = s - 1
    conf = dict(block=16, num_local_blocks=2, num_global_blocks=1)
    tcfg, jcfg = tsa.FixedSparsityConfig(**conf), jsa.FixedSparsityConfig(**conf)
    got = _grads_port(lambda *a: tsa.block_sparse_attention(*a, tcfg, **kw_t), q, k, v, cot)
    want = _grads_jax(lambda *a: jsa.block_sparse_attention(*a, jcfg, **kw_j), q, k, v, cot)
    np.testing.assert_allclose(got[0], want[0], **FWD_TOL)
    for name, g, w in zip("qkv", got[1], want[1]):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **GRAD_TOL)


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, prefix + key + "/"))
        else:
            out[prefix + key] = val
    return out


SPARSE = {"mode": "fixed", "block": 128, "num_local_blocks": 2, "num_global_blocks": 1}


@pytest.mark.parametrize("head_dim", [None, 64])
def test_sparse_engine_trajectory_matches_jax(head_dim):
    """tiny at seq 512 under fixed(128, 2, 1) (8 of 10 causal blocks), FusedAdam
    with decay and clipping: 3 steps' losses and the final parameters.
    Adam's eps is 1e-4.  At seq 512 every embedding entry is touched, and
    the two micro-batches' gradients nearly cancel in some (the smallest
    accumulated entry is 1.5e-7, where the frameworks' fp32 sums differ by
    4e-8); a step ``g / (|g| + eps)`` magnifies a gradient difference d by
    up to 1 / eps, so 3 steps move a parameter by up to 3 lr d / eps: 2.4e-5
    at the default 1e-8, 3.6e-6 at 1e-4, under ``ENGINE_TOL``."""
    over = dict(max_seq_len=512, **({"head_dim": head_dim} if head_dim else {}))
    jcfg = j_preset("tiny", dtype=jnp.float32, **over)
    jp = jax.tree_util.tree_map(np.asarray, jt.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(4)
    batches = [{"input_ids": rng.integers(0, 256, (2, 2, 513)).astype(np.int32)}
               for _ in range(3)]
    conf = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
            "optimizer": {"type": "FusedAdam", "params": {"lr": 3e-3, "weight_decay": 0.1,
                                                           "eps": 1e-4}},
            "gradient_clipping": 1.0, "bf16": {"enabled": False}, "steps_per_print": 1000,
            "sparse_attention": SPARSE}
    jengine, _, _, _ = jds.initialize(
        model=jt.CausalLM(jcfg), params=jax.tree_util.tree_map(jnp.asarray, jp), config=conf,
        mesh=initialize_mesh(devices=jax.devices()[:1], data=1))
    j_losses = [float(jengine.train_batch(b)) for b in batches]
    tcfg = get_preset("tiny", dtype=torch.float32, **over)
    model = tt.CausalLM(tcfg)
    engine, _, _, _ = tds.initialize(model=model, params=tt.params_from_numpy(jp, tcfg,
                                                                               device="cpu"),
                                     config=conf, device="cpu")
    assert model.cfg.sparse_attention == tsa.FixedSparsityConfig(
        block=128, num_local_blocks=2, num_global_blocks=1)
    t_losses = [float(engine.train_batch(b)) for b in batches]
    np.testing.assert_allclose(t_losses, j_losses, **ENGINE_TOL)
    fj = _flat(jax.tree_util.tree_map(np.asarray, jengine.state.params))
    ft = _flat(engine.params)
    assert set(fj) == set(ft)
    for key in fj:
        np.testing.assert_allclose(ft[key].detach().numpy(), fj[key], err_msg=key,
                                   **ENGINE_TOL)


@pytest.mark.parametrize("section,match", [
    ({"mode": "strided"}, "sparse_attention.mode"),
    ({"mode": "fixed", "different_layout_per_head": True}, "different_layout_per_head"),
    ({"mode": "fixed", "block": 0}, "block must be"),
])
def test_sparse_config_errors_match_jax(section, match):
    with pytest.raises(JConfigError, match=match):
        j_parse_config({"sparse_attention": section})
    with pytest.raises(ConfigError, match=match):
        parse_config({"sparse_attention": section})


def test_sparse_attention_needs_a_model():
    conf = {"sparse_attention": {"mode": "fixed"}, "bf16": {"enabled": False}}
    jcfg = j_preset("tiny", dtype=jnp.float32)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    with pytest.raises(JConfigError, match="requires model="):
        jds.initialize(loss_fn=jt.CausalLM(jcfg).loss_fn, params=jp, config=conf,
                       mesh=initialize_mesh(devices=jax.devices()[:1], data=1))
    tcfg = get_preset("tiny", dtype=torch.float32)
    with pytest.raises(ConfigError, match="requires model="):
        tds.initialize(loss_fn=tt.CausalLM(tcfg).loss_fn,
                       params=tt.init_params(tcfg, device="cpu"), config=conf, device="cpu")
