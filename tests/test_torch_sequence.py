"""Sequence parallelism across processes: the port's Ulysses
(``sequence/layer.py``) and ring attention (``sequence/ring.py``) on worlds
of 2 and 4 gloo ranks on the CPU, against JAX's ``DistributedAttention`` /
``ring_attention`` and the JAX engine on ``seq`` meshes of the forced CPU
devices (``tests/conftest.py``), in fp32 with JAX's
``init_params(PRNGKey(0))``.

The attention bodies on the same global q / k / v (each rank its
positions): Ulysses at ``seq`` 2 (even: ``tiny``'s 4 q / 2 kv heads a rank
1 kv head), over a ``fixed`` block-sparse layout (the plain sparse body on
the CPU), at ``seq`` 4 (uneven: 2 kv heads under 4 ranks take the grouped
collectives), with packed segments (the replicated-kv path), 6 q heads
under 4 ranks over the sparse layout (replicated: the layout's body over
the gathered sequence); ring at 2 and 4; the ring's fallback under a soft
cap.  Output and q / k / v gradients
equal JAX's.

Training ``tiny`` 3 steps (AdamW, GAS 2, clipping) at ``seq`` 2 and 4 under
``ulysses``, ``ring`` and ``none`` (a seq axis under ``none``: the body
over the gathered sequence, each rank its rows), with packed
``segment_ids``, at ``seq`` 2 x ``model`` 2, ``data`` 2 x ``seq`` 2 at ZeRO
stage 1 (the slices' replicas over seq), and over a ``fixed`` sparse layout
under ``ulysses`` and ``none``: losses, gradient
norms and the whole masters equal the JAX engine's.  JAX's GSPMD runs give
the values of the global computation whatever the layout, so the cases of
one batch set are held to one JAX run: ``ulysses`` at ``seq`` 2 for the
plain batches, ``ring`` at ``seq`` 2 for the packed ones (its reference
fallback), ``ulysses`` over the sparse layout at ``seq`` 2 for both sparse
cases.  JAX's own
``ring`` and ``ulysses`` at ``seq`` 4 and ``ulysses`` at ``seq`` 2 x
``model`` 2 differ from those runs by at most 9.5e-7 in a loss and 3.3e-5
in a parameter on the plain batches, 4.8e-7 and 2.0e-4 on the packed ones
(Adam magnifies the last bits of near-zero gradient entries).

What stays refused: a length the seq axis does not divide (JAX pads it),
a sparse layout under ring (JAX's ConfigError), ALiBi (also under ``none``
over the axis), a loss function
other than the model's, the 1-bit optimizers, and the routed region
(``moe_qcomm``) beside a seq axis.

Tolerances (fp32), those of ``test_torch_tp.py``: losses and gradient norms
atol 1e-5 / rtol 1e-4, parameters after 3 AdamW steps atol 2e-4 / rtol
1e-4; the attention bodies atol 2e-5 (outputs) and 1e-4 (gradients), JAX's
own ``tests/test_sequence.py`` tolerances.  Every world has a timeout.
"""
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepspeed_tpu as jds
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.ops.attention import dot_product_attention as j_dpa
from deepspeed_tpu.ops.sparse_attention import FixedSparsityConfig as JFixed
from deepspeed_tpu.ops.sparse_attention import block_sparse_attention as j_sparse
from deepspeed_tpu.parallel.sharding import set_current_mesh
from deepspeed_tpu.parallel.topology import initialize_mesh
from deepspeed_tpu.sequence import DistributedAttention as JDistributedAttention
from deepspeed_tpu.sequence import ring_attention as j_ring

import torch_world as W
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

TOL = dict(atol=1e-5, rtol=1e-4)
PARAM_TOL = dict(atol=2e-4, rtol=1e-4)
OUT_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
STEPS = 3
GAS = 2
GLOBAL_MICRO = 4
SEQ = 32  # tokens a row after the label shift
# block 8: 4 blocks a row of SEQ, so that the layout masks (at block 16 it
# would be the whole causal triangle)
SPARSE = {"mode": "fixed", "block": 8, "num_local_blocks": 2, "num_global_blocks": 1}


def config(mesh, micro, stage=0, **over):
    cfg = {"train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": GAS,
           "optimizer": {"type": "adamw", "params": {"lr": 3e-3, "weight_decay": 0.1}},
           "gradient_clipping": 0.5, "bf16": {"enabled": False}, "steps_per_print": 1000,
           "zero_optimization": {"stage": stage, "param_persistence_threshold": 0},
           "comms_logger": {"enabled": True}}
    if mesh is not None:
        cfg["mesh"] = mesh
    cfg.update(over)
    return cfg


def _batches(segments=False, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        b = {"input_ids": rng.integers(0, 256, (GAS, GLOBAL_MICRO, SEQ + 1)).astype(np.int64)}
        if segments:  # packed rows: documents of unequal lengths
            seg = np.zeros((GAS, GLOBAL_MICRO, SEQ + 1), np.int64)
            seg[:, :, 11:] = 1
            seg[:, 1::2, 23:] = 2
            seg[1, 2, 5:] += 3
            b["segment_ids"] = seg
        out.append(b)
    return out


# name -> (world, port mesh, sequence_parallel, batches, stage, sparse)
CASES = {
    "ulysses2": (2, {"seq": 2}, "ulysses", "plain", 0, False),
    "ring2": (2, {"seq": 2}, "ring", "plain", 0, False),
    "none2": (2, {"seq": 2}, "none", "plain", 0, False),
    "ulysses2_seg": (2, {"seq": 2}, "ulysses", "seg", 0, False),
    "ring2_seg": (2, {"seq": 2}, "ring", "seg", 0, False),
    "ulysses2_sparse": (2, {"seq": 2}, "ulysses", "plain", 0, True),
    "none2_sparse": (2, {"seq": 2}, "none", "plain", 0, True),
    "ulysses4": (4, {"seq": 4}, "ulysses", "plain", 0, False),
    "ring4": (4, {"seq": 4}, "ring", "plain", 0, False),
    "ulysses4_seg": (4, {"seq": 4}, "ulysses", "seg", 0, False),
    "ring4_seg": (4, {"seq": 4}, "ring", "seg", 0, False),
    "ulysses_s2m2": (4, {"seq": 2, "model": 2}, "ulysses", "plain", 0, False),
    "ring_d2s2_stage1": (4, {"data": 2, "seq": 2}, "ring", "plain", 1, False),
}
# the JAX run each case is held to (see the module docstring)
REF_OF = {name: ("sparse" if sparse else batches) for name, (_, _, _, batches, _, sparse)
          in CASES.items()}

# attention bodies: name -> (world, kind, heads (hq, hkv), sparse, soft cap, segments)
ATTN = {
    "ulysses2": (2, "ulysses", (4, 2), None, None, False),
    "ulysses2_sparse": (2, "ulysses", (4, 2), dict(block=16, num_local_blocks=2,
                                                    num_global_blocks=1), None, False),
    "ring2": (2, "ring", (4, 2), None, None, False),
    "ring2_softcap": (2, "ring", (4, 2), None, 5.0, False),
    "ulysses4_uneven": (4, "ulysses", (4, 2), None, None, False),
    "ulysses4_seg": (4, "ulysses", (4, 2), None, None, True),
    "ring4": (4, "ring", (4, 2), None, None, False),
    # 6 q heads under 4 ranks: replicated, the layout's body on the whole
    "ulysses4_sparse_replicated": (4, "ulysses", (6, 2), dict(block=16, num_local_blocks=2,
                                                              num_global_blocks=1), None, False),
}


def _attn_inputs(path, hq, hkv, seed):
    rng = np.random.default_rng(seed)
    b, s, d = 2, 64, 16
    x = {"q": rng.normal(size=(b, s, hq, d)) * 0.5, "k": rng.normal(size=(b, s, hkv, d)) * 0.5,
         "v": rng.normal(size=(b, s, hkv, d)) * 0.5, "w": rng.normal(size=(b, s, hq, d))}
    seg = np.zeros((b, s), np.int32)
    seg[:, 21:] = 1
    seg[1, 40:] = 2
    x = {k: v.astype(np.float32) for k, v in x.items()}
    x["seg"] = seg
    np.savez(path, **x)
    return x


def _jax_attn(x, world, kind, sparse, cap, segments):
    """JAX's body on a ``seq`` mesh of ``world`` devices: output and the
    q / k / v gradients of ``sum(out * w)``."""
    grid = initialize_mesh(devices=jax.devices()[:world], seq=world)
    kw = {"causal": True}
    if cap is not None:
        kw["logits_soft_cap"] = cap
    if segments:
        kw["segment_ids"] = jnp.asarray(x["seg"])
    if kind == "ring":
        body = functools.partial(j_ring, **kw)
    else:
        base = j_dpa if sparse is None else functools.partial(j_sparse, config=JFixed(**sparse))
        body = functools.partial(JDistributedAttention(base), **kw)
    w = jnp.asarray(x["w"])
    set_current_mesh(grid.mesh)
    try:
        out, vjp = jax.vjp(jax.jit(body), *(jnp.asarray(x[t]) for t in ("q", "k", "v")))
        dq, dk, dv = vjp(w)
    finally:
        set_current_mesh(None)
    return {k: np.asarray(v) for k, v in dict(out=out, dq=dq, dk=dk, dv=dv).items()}


def _jax_run(jcfg, jp, cfg, batches, world, **mesh):
    engine, *_ = jds.initialize(model=jt.CausalLM(jcfg),
                                params=jax.tree_util.tree_map(jnp.asarray, jp), config=cfg,
                                mesh=initialize_mesh(devices=jax.devices()[:world], **mesh))
    losses, norms = [], []
    for b in batches:
        losses.append(float(engine.train_batch({k: v.astype(np.int32) for k, v in b.items()})))
        norms.append(engine.get_global_grad_norm())
    params = W._flat(jax.tree_util.tree_map(np.asarray, engine.state.params))
    return {"losses": losses, "norms": norms, "params": params}


def _jax_refs(jcfg, jp, data):
    cfg = config(None, GLOBAL_MICRO)
    return {
        "plain": _jax_run(jcfg.replace(sequence_parallel="ulysses"), jp, cfg, data["plain"],
                          2, seq=2),
        "seg": _jax_run(jcfg.replace(sequence_parallel="ring"), jp, cfg, data["seg"], 2,
                        seq=2),
        "sparse": _jax_run(jcfg.replace(sequence_parallel="ulysses"), jp,
                           dict(cfg, sparse_attention=SPARSE), data["plain"], 2, seq=2),
    }


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq_world")
    data = {"plain": _batches(), "seg": _batches(segments=True, seed=11)}
    for k, v in data.items():
        np.savez(tmp / f"{k}.npz", **{f"{i}/{n}": a for i, b in enumerate(v)
                                       for n, a in b.items()})
    jcfg = j_preset("tiny", dtype=jnp.float32)
    jp = jax.tree_util.tree_map(np.asarray, jt.init_params(jax.random.PRNGKey(0), jcfg))
    W.save_tree(tmp / "tiny.npz", jp)
    by_world = {2: [], 4: []}
    for name, (world, mesh, sp, batches, stage, sparse) in CASES.items():
        dp = mesh.get("data", 1)
        extra = {"sparse_attention": SPARSE} if sparse else {}
        by_world[world].append(dict(
            name=name, kind="train", params=str(tmp / "tiny.npz"),
            batches=str(tmp / f"{batches}.npz"), over={"sequence_parallel": sp},
            config=config(mesh, GLOBAL_MICRO // dp, stage, **extra)))
    attn_inputs = {}
    for name, (world, kind, (hq, hkv), sparse, cap, seg) in ATTN.items():
        path = tmp / f"attn_{name}.npz"
        attn_inputs[name] = _attn_inputs(path, hq, hkv, seed=len(attn_inputs))
        by_world[world].append(dict(name="attn_" + name, kind="fn", fn="seq_attn",
                                    inputs=str(path), mesh={"seq": world}, body=kind,
                                    sparse=sparse, cap=cap, segments=seg))
    for world in by_world:
        by_world[world].append(dict(name="refusals", kind="fn", fn="seq_refusals"))
    with ThreadPoolExecutor(len(by_world)) as pool:
        futures = {w: pool.submit(W.spawn, w, cases, tmp / f"w{w}", timeout=600)
                   for w, cases in by_world.items()}
        refs = _jax_refs(jcfg, jp, data)
        attn_refs = {name: _jax_attn(attn_inputs[name], world, kind, sparse, cap, seg)
                     for name, (world, kind, _, sparse, cap, seg) in ATTN.items()}
        ranks = {w: f.result() for w, f in futures.items()}
    return {"ranks": ranks, "refs": refs, "attn_refs": attn_refs}


def _got(worlds, world, name, rank=0):
    return worlds["ranks"][world][rank][name]


@pytest.mark.parametrize("case", sorted(CASES))
def test_sequence_axis_trains_as_the_jax_engine(worlds, case):
    """Losses, norms and the whole masters after 3 steps equal the JAX
    engine's; every rank reports the same numbers."""
    world = CASES[case][0]
    got, ref = _got(worlds, world, case), worlds["refs"][REF_OF[case]]
    np.testing.assert_allclose(got["losses"], ref["losses"], **TOL)
    np.testing.assert_allclose(got["norms"], ref["norms"], **TOL)
    assert set(got["params"]) == set(ref["params"])
    for k, v in ref["params"].items():
        np.testing.assert_allclose(got["params"][k], v, err_msg=k, **PARAM_TOL)
    for r in range(1, world):
        other = _got(worlds, world, case, r)
        np.testing.assert_array_equal(other["losses"], got["losses"])


@pytest.mark.parametrize("name", sorted(ATTN))
def test_attention_bodies_match_jax_on_a_seq_mesh(worlds, name):
    """Each rank's output and q / k / v gradient slices, concatenated over
    the ranks, equal JAX's body on the global arrays."""
    world = ATTN[name][0]
    parts = [_got(worlds, world, "attn_" + name, r) for r in range(world)]
    ref = worlds["attn_refs"][name]
    for key in ("out", "dq", "dk", "dv"):
        got = np.concatenate([p[key] for p in parts], axis=1)
        np.testing.assert_allclose(got, ref[key], err_msg=key,
                                   **(OUT_TOL if key == "out" else GRAD_TOL))


def test_the_new_collectives_are_counted_by_op_and_axis(worlds):
    """Ulysses' all-to-alls, the ring's rotations and the gathered keys land
    in the comms logger under ``<op>@seq``; the token mean's and the
    gradient's reductions span the batch axes and seq."""
    counts = {name: _got(worlds, CASES[name][0], name)["counts"] for name in CASES}
    assert counts["ulysses2"]["all_to_all@seq"] > 0
    assert counts["ring2"]["ppermute@seq"] > 0 and "all_to_all@seq" not in counts["ring2"]
    assert counts["none2"]["all_gather@seq"] > 0
    # the uneven heads' grouped gathers
    assert counts["ulysses4"]["all_gather@seq"] > 0 and counts["ulysses4"]["all_to_all@seq"] > 0
    # per step: GAS token counts, the loss and the gradient
    assert counts["ulysses2"]["all_reduce@data+fsdp+sub+seq"] == STEPS * (GAS + 2)
    assert counts["ring_d2s2_stage1"]["all_reduce@data+seq"] == STEPS  # the replicas


@pytest.mark.parametrize("world", [2, 4])
def test_what_a_seq_axis_refuses(worlds, world):
    got = _got(worlds, world, "refusals")
    assert got["length"].startswith("NotImplementedError") and "item 7" in got["length"]
    assert got["sparse_ring"] == ("ConfigError: sparse_attention composes with ulysses but "
                                  "not ring (ring attention supplies its own attention body)")
    assert got["alibi"].startswith("NotImplementedError") and "alibi" in got["alibi"]
    for key in ("loss_fn", "onebit", "alibi_none") + (("ep_seq",) if world == 4 else ()):
        assert got[key].startswith("NotImplementedError") and "item 7" in got[key], key
