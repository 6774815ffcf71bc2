"""Expert parallelism and MoE across processes: the port's routed layers
(``moe/layer.py``: ``moe_block`` with the gate over the global tokens, a
rank's experts over ``expert`` and its expert-FFN columns over ``model``;
``routed_ffn_ep`` over the quantized all-to-all) on worlds of 2 and 4 gloo
ranks on the CPU, against JAX's ``moe_block`` / ``routed_ffn_ep`` and the
JAX engine on ``data`` / ``expert`` meshes of the forced CPU devices
(``tests/conftest.py``), in fp32 with JAX's ``init_params(PRNGKey(0))``.

The gate across ranks (the repair of JAX's global gate): JAX's GSPMD
``moe_block`` gates over the global token set, so capacity and slot order
are the global batch's.  ``tiny_moe`` with ``moe_capacity_factor`` 0.5
(tokens drop) at ``data`` 2 equals JAX on a ``data`` 2 mesh: the gate's
decisions for each rank's tokens (expert, slot, kept) and the expert
counts equal JAX's ``topk_gating`` on the global logits, the layer's
output, aux loss and gradients equal JAX's, and 3 training steps equal the
JAX engine's.  The same run at ``expert`` 2 and 4, ``expert`` 2 x ``data``
2 (ZeRO stage 2), ``model`` 2, ``expert`` 2 x ``model`` 2, ``seq`` 2
(Ulysses) and ``seq`` 2 x ``expert`` 2 (ring) is held to that JAX run
(GSPMD's values are the global computation's whatever the layout).

The explicit region (``moe_qcomm`` ``none`` / ``int8`` / ``fp8`` at
``expert`` 2, and ``none`` at ``expert`` 2 x ``data`` 2): each rank gates
its own rows (capacity per rank), as JAX's region does; the layer's
output, aux loss and gradients equal JAX's ``routed_ffn_ep`` under the
same mesh (``none`` at the fp32 tolerance; int8 / fp8 at the quantized
transport's, the codec's bytes being JAX's), the gradients of the expert
weights flow through the all-to-all's transpose (a dropped gradient would
leave them zero), and 3 training steps equal the JAX engine's.

A checkpoint saved at ``expert`` 2 resumes in a one-device engine, and a
one-device checkpoint resumes at ``expert`` 2.  What stays refused: the
routed region beside a model axis, MoE served over a model axis (v1 and v2
engines), Lamb over the expert axis's shards.

Tolerances (fp32), those of ``test_torch_tp.py``: losses and gradient norms
atol 1e-5 / rtol 1e-4, parameters after 3 AdamW steps atol 2e-4 / rtol
1e-4; the layers' outputs and gradients atol 2e-5 / rtol 1e-4 (``none``)
and, over the int8 / fp8 wire, ``QTOL``: a payload's rounding that flips
between the two packages' fp32 sums moves one quantum of the chunk's
scale.  Over that wire the training runs meet TOL at their first step and
``QTRAJ`` / ``QTRAJ_PARAM`` after 3 (the flips carried on; set from
readings).  AdamW's eps is 1e-4 (as in ``test_torch_sparse_attention.py``):
at 1e-8 Adam turns fp32 summation noise in near-zero gradient entries into
lr-sized steps, and a moved router weight can flip a near-tied expert
choice, a discrete change.  Read at eps 1e-8 on ``ep2_none``: one
``w_down`` entry whose first gradient is noise about 0 (-9.1e-10 in the
port, -2.7e-9 in JAX, where the largest entry is 2.3e-2 and no entry of
the step differs by more than 2.5e-8) takes Adam's first step ``g / (|g|
+ eps)``, -0.083 and -0.214 of the learning rate: 3.9e-4 apart after 3
steps, the whole gap, while its later gradients agree to 1.2e-7.  So that
a gradient wrong but small cannot hide behind that eps, each step-1
gradient is held to JAX's entry by entry before Adam acts (Adam's first
moment after one step is ``(1 - beta1)`` times the clipped gradient,
whatever eps): GRAD1_TOL, and QTOL over the int8 / fp8 wire.  Gate
decisions are equal.  Every world has a timeout.
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.moe import layer as jlayer
from deepspeed_tpu.moe.sharded_moe import topk_gating as j_topk_gating
from deepspeed_tpu.parallel.sharding import set_current_mesh
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
PARAM_TOL = dict(atol=2e-4, rtol=1e-4)
LAYER_TOL = dict(atol=2e-5, rtol=1e-4)
# the first step's gradients, entry by entry (the largest about 2e-2)
GRAD1_TOL = dict(atol=1e-6, rtol=1e-4)
QTOL = dict(atol=2e-3, rtol=1e-3)
# 3 steps over the int8 / fp8 wire: a payload value one ulp from a rounding
# boundary in either package's fp32 sums moves one quantum (1/127 of its
# chunk's amax for int8), which the next steps carry on; read: losses 1.9e-3
# and norms 2.1e-3 relative, parameters 7.2e-3 (int8; fp8 3.3e-4, 1.0e-3,
# 5.0e-3)
QTRAJ = dict(atol=0.0, rtol=5e-3)
QTRAJ_PARAM = dict(atol=1e-2, rtol=0.0)
STEPS = 3
GAS = 2
GLOBAL_MICRO = 4
DROP_CF = 0.5


def config(mesh, micro, stage=0, **over):
    cfg = {"train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": GAS,
           "optimizer": {"type": "adamw", "params": {"lr": 3e-3, "weight_decay": 0.1,
                                                      "eps": 1e-4}},
           "gradient_clipping": 0.5, "bf16": {"enabled": False}, "steps_per_print": 1000,
           "zero_optimization": {"stage": stage, "param_persistence_threshold": 0},
           "comms_logger": {"enabled": True}}
    if mesh is not None:
        cfg["mesh"] = mesh
    cfg.update(over)
    return cfg


def _batches(n=STEPS, seed=7):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, (GAS, GLOBAL_MICRO, 17)).astype(np.int64)}
            for _ in range(n)]


# name -> (world, port mesh, model overrides, stage, JAX reference)
CASES = {
    "data2": (2, {"data": 2}, {"moe_capacity_factor": DROP_CF}, 0, "drop"),
    "expert2": (2, {"expert": 2}, {"moe_capacity_factor": DROP_CF}, 0, "drop"),
    "model2": (2, {"model": 2}, {"moe_capacity_factor": DROP_CF}, 0, "drop"),
    "ep2_none": (2, {"expert": 2}, {"moe_qcomm": "none"}, 0, "ep_none"),
    "ep2_int8": (2, {"expert": 2}, {"moe_qcomm": "int8"}, 0, "ep_int8"),
    "ep2_fp8": (2, {"expert": 2}, {"moe_qcomm": "fp8"}, 0, "ep_fp8"),
    "expert4": (4, {"expert": 4}, {"moe_capacity_factor": DROP_CF}, 0, "drop"),
    "e2d2_stage2": (4, {"expert": 2, "data": 2}, {"moe_capacity_factor": DROP_CF}, 2, "drop"),
    "e2m2": (4, {"expert": 2, "model": 2}, {"moe_capacity_factor": DROP_CF}, 0, "drop"),
    "ep_e2d2_none": (4, {"expert": 2, "data": 2}, {"moe_qcomm": "none"}, 0, "ep_none_d2"),
    # the gate's tokens gathered over seq too (rows by batch rank, positions
    # by seq rank)
    "seq2_ulysses": (2, {"seq": 2}, {"moe_capacity_factor": DROP_CF,
                                      "sequence_parallel": "ulysses"}, 0, "drop"),
    "s2e2_ring": (4, {"seq": 2, "expert": 2}, {"moe_capacity_factor": DROP_CF,
                                                "sequence_parallel": "ring"}, 0, "drop"),
}
# layer checks: name -> (world, port mesh, layer, fmt, capacity factor, JAX mesh)
LAYERS = {
    "block_d2": (2, {"data": 2}, "block", "none", DROP_CF, dict(data=2)),
    "block_e2": (2, {"expert": 2}, "block", "none", DROP_CF, dict(data=2)),
    "ep_none": (2, {"expert": 2}, "ep", "none", 1.25, dict(expert=2)),
    "ep_int8": (2, {"expert": 2}, "ep", "int8", 1.25, dict(expert=2)),
    "ep_fp8": (2, {"expert": 2}, "ep", "fp8", 1.25, dict(expert=2)),
    "ep_e2d2": (4, {"expert": 2, "data": 2}, "ep", "none", 1.25, dict(expert=2, data=2)),
    "block_e2d2": (4, {"expert": 2, "data": 2}, "block", "none", DROP_CF, dict(data=2)),
}


def _layer_inputs(path):
    rng = np.random.default_rng(11)
    e, d, f = 4, 32, 64
    x = {"router": rng.standard_normal((d, e)) * 0.1, "w_gate": rng.standard_normal((e, d, f)) * 0.1,
         "w_up": rng.standard_normal((e, d, f)) * 0.1, "w_down": rng.standard_normal((e, f, d)) * 0.1,
         "x": rng.standard_normal((8, 16, d)), "w": rng.standard_normal((8, 16, d))}
    x = {k: v.astype(np.float32) for k, v in x.items()}
    np.savez(path, **x)
    return x


def _jax_layer(x, layer, fmt, cf, jmesh):
    """JAX's layer under ``jmesh``: output, aux and the gradients of
    ``sum(out * w) + aux``; with ``block`` the global gate's decisions."""
    cfg = jt.TransformerConfig(vocab_size=64, hidden_size=32, num_layers=1, num_heads=4,
                               intermediate_size=64, moe_num_experts=4, moe_top_k=2,
                               moe_capacity_factor=cf, dtype=jnp.float32)
    devices = int(np.prod(list(jmesh.values())))
    grid = initialize_mesh(devices=jax.devices()[:devices], **jmesh)
    lw = {k: jnp.asarray(x[k]) for k in ("router", "w_gate", "w_up", "w_down")}
    xin, w = jnp.asarray(x["x"]), jnp.asarray(x["w"])

    def f(lw, xin):
        if layer == "ep":
            out, aux = jlayer.routed_ffn_ep(lw, xin, cfg, grid.mesh, fmt=fmt)
        else:
            out, aux = jlayer.moe_block(lw, xin, cfg)
        return jnp.sum(out * w) + aux, (out, aux)

    set_current_mesh(grid.mesh)
    try:
        (_, (out, aux)), (g_lw, g_x) = jax.jit(
            jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(lw, xin)
    finally:
        set_current_mesh(None)
    res = {"out": np.asarray(out), "aux": np.asarray(aux), "dx": np.asarray(g_x)}
    res.update({f"d_{k}": np.asarray(v) for k, v in g_lw.items()})
    if layer == "block":
        logits = xin.reshape(-1, xin.shape[-1]) @ lw["router"]
        gate = j_topk_gating(logits, 2, cf, min_capacity=4)
        disp = np.asarray(gate.dispatch)  # [N, E, C]
        res["dispatch"] = disp
        res["counts"] = np.asarray(gate.expert_counts)
    return res


def _jax_run(jcfg, jp, cfg, batches, devices, **mesh):
    engine, *_ = jds.initialize(model=jt.CausalLM(jcfg),
                                params=jax.tree_util.tree_map(jnp.asarray, jp), config=cfg,
                                mesh=initialize_mesh(devices=jax.devices()[:devices], **mesh))
    losses, norms, mu1 = [], [], None
    for b in batches:
        losses.append(float(engine.train_batch({k: v.astype(np.int32) for k, v in b.items()})))
        norms.append(engine.get_global_grad_norm())
        if mu1 is None:  # Adam's first moment after the first step
            adam = [s for s in jax.tree_util.tree_leaves(
                engine.state.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")]
            mu1 = W._flat(jax.tree_util.tree_map(np.asarray, adam[0].mu))
    params = W._flat(jax.tree_util.tree_map(np.asarray, engine.state.params))
    return {"losses": losses, "norms": norms, "params": params, "mu1": mu1}


def _jax_refs(jcfg, jp, data):
    cfg = config(None, GLOBAL_MICRO)
    refs = {"drop": _jax_run(jcfg.replace(moe_capacity_factor=DROP_CF), jp, cfg, data, 2,
                             data=2)}
    for fmt in ("none", "int8", "fp8"):
        refs[f"ep_{fmt}"] = _jax_run(jcfg.replace(moe_qcomm=fmt), jp, cfg, data, 2, expert=2)
    refs["ep_none_d2"] = _jax_run(jcfg.replace(moe_qcomm="none"), jp, cfg, data, 4,
                                  expert=2, data=2)
    return refs


def _torch_engine(jp, cfg):
    model = tt.CausalLM(get_preset("tiny_moe", dtype=torch.float32, attn_impl="flash",
                                   remat="selective"))
    params = tt.params_from_numpy(jp, model.cfg, device="cpu")
    engine, *_ = tds.initialize(model=model, params=params, config=cfg, device="cpu")
    return engine


def _torch_steps(engine, batches):
    return [float(engine.train_batch({k: torch.from_numpy(v) for k, v in b.items()}))
            for b in batches]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("expert_world")
    data, ckpt_data = _batches(), _batches(4, seed=13)
    for name, batches in (("plain", data), ("ckpt", ckpt_data)):
        np.savez(tmp / f"{name}.npz", **{f"{i}/{k}": v for i, b in enumerate(batches)
                                          for k, v in b.items()})
    jcfg = j_preset("tiny_moe", dtype=jnp.float32)
    jp = jax.tree_util.tree_map(np.asarray, jt.init_params(jax.random.PRNGKey(0), jcfg))
    W.save_tree(tmp / "tiny_moe.npz", jp)
    # the reverse resume: a one-device engine saves after 2 of 4 steps
    one_losses = _torch_steps(_torch_engine(jp, config(None, GLOBAL_MICRO)), ckpt_data)
    fresh = _torch_engine(jp, config(None, GLOBAL_MICRO))
    _torch_steps(fresh, ckpt_data[:2])
    fresh.save_checkpoint(str(tmp / "ckpt_one"))
    common = dict(kind="train", preset="tiny_moe", params=str(tmp / "tiny_moe.npz"))
    by_world = {2: [], 4: []}
    for name, (world, mesh, over, stage, _) in CASES.items():
        dp = mesh.get("data", 1)
        by_world[world].append(dict(name=name, batches=str(tmp / "plain.npz"), over=over,
                                    config=config(mesh, GLOBAL_MICRO // dp, stage),
                                    moments_at=(1,), **common))
    by_world[2] += [
        dict(name="ckpt", batches=str(tmp / "ckpt.npz"), config=config({"expert": 2}, 4),
             ckpt=str(tmp / "ckpt_e2"), ckpt_after=2, **common),
        dict(name="resume", batches=str(tmp / "ckpt.npz"), config=config({"expert": 2}, 4),
             load=str(tmp / "ckpt_one"), **common),
    ]
    for world in by_world:
        by_world[world].append(dict(name="refusals", kind="fn", fn="expert_refusals"))
    layer_inputs = _layer_inputs(tmp / "layer.npz")
    for name, (world, mesh, layer, fmt, cf, _) in LAYERS.items():
        by_world[world].append(dict(name="layer_" + name, kind="fn", fn="moe_layer",
                                    inputs=str(tmp / "layer.npz"), mesh=mesh, layer=layer,
                                    fmt=fmt, cf=cf))
    with ThreadPoolExecutor(len(by_world)) as pool:
        futures = {w: pool.submit(W.spawn, w, cases, tmp / f"w{w}", timeout=600)
                   for w, cases in by_world.items()}
        refs = _jax_refs(jcfg, jp, data)
        layer_refs = {name: _jax_layer(layer_inputs, layer, fmt, cf, jmesh)
                      for name, (_, _, layer, fmt, cf, jmesh) in LAYERS.items()}
        ranks = {w: f.result() for w, f in futures.items()}
    return {"ranks": ranks, "refs": refs, "layer_refs": layer_refs, "tmp": tmp, "jp": jp,
            "ckpt_data": ckpt_data, "one_losses": one_losses}


def _got(worlds, world, name, rank=0):
    return worlds["ranks"][world][rank][name]


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_across_ranks_trains_as_the_jax_engine(worlds, case):
    """Losses, norms and the whole masters after 3 steps equal the JAX
    engine's; every rank reports the same losses."""
    world, _, over, _, ref_name = CASES[case]
    got, ref = _got(worlds, world, case), worlds["refs"][ref_name]
    wire = over.get("moe_qcomm") in ("int8", "fp8")
    # the first step at the fp32 tolerance; over the lossy wire the later
    # ones carry its rounding flips on (QTRAJ)
    np.testing.assert_allclose(got["losses"][0], ref["losses"][0], **TOL)
    np.testing.assert_allclose(got["norms"][0], ref["norms"][0], **TOL)
    np.testing.assert_allclose(got["losses"], ref["losses"], **(QTRAJ if wire else TOL))
    np.testing.assert_allclose(got["norms"], ref["norms"], **(QTRAJ if wire else TOL))
    assert set(got["params"]) == set(ref["params"])
    for k, v in ref["params"].items():
        np.testing.assert_allclose(got["params"][k], v, err_msg=k,
                                   **(QTRAJ_PARAM if wire else PARAM_TOL))
    for r in range(1, world):
        np.testing.assert_array_equal(_got(worlds, world, case, r)["losses"], got["losses"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_first_gradient_equals_jax_entry_by_entry(worlds, case):
    """Each leaf's gradient of the first step (Adam's first moment after it,
    divided by ``1 - beta1``) equals the JAX engine's entry by entry."""
    world, _, over, _, ref_name = CASES[case]
    got = _got(worlds, world, case)["moments"][1]["mu"]
    ref = worlds["refs"][ref_name]["mu1"]
    tol = QTOL if over.get("moe_qcomm") in ("int8", "fp8") else GRAD1_TOL
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k] / 0.1, v / 0.1, err_msg=k, **tol)


def _rank_rows(mesh, world):
    """Each rank's block of the batch rows (by its batch-axes coordinate)."""
    dp = mesh.get("data", 1)
    per = world // dp
    return [(r // per) for r in range(world)], dp


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_routed_layers_match_jax(worlds, name):
    """Each batch rank's output rows, input gradient rows and the aux loss
    equal JAX's layer; the router's gradient is whole on every rank and the
    expert weights' gradients, concatenated over the expert ranks, equal
    JAX's (over the all-to-all's transpose in the explicit region)."""
    world, mesh, layer, fmt, _, _ = LAYERS[name]
    ref = worlds["layer_refs"][name]
    tol = LAYER_TOL if fmt == "none" else QTOL
    block_of, dp = _rank_rows(mesh, world)
    rows = ref["out"].shape[0] // dp
    w_e = mesh.get("expert", 1)
    for r in range(world):
        got = _got(worlds, world, "layer_" + name, r)
        sl = slice(block_of[r] * rows, (block_of[r] + 1) * rows)
        np.testing.assert_allclose(got["out"], ref["out"][sl], err_msg=f"out {r}", **tol)
        np.testing.assert_allclose(got["dx"], ref["dx"][sl], err_msg=f"dx {r}", **tol)
        np.testing.assert_allclose(got["aux"], ref["aux"], err_msg=f"aux {r}", **LAYER_TOL)
    # the weights' gradients: each batch rank's (its tokens' and its share
    # of the aux loss's) summed over the batch ranks; an expert rank's
    # experts concatenated in expert order (rank = batch block * W + e)
    for k in ("d_router", "d_w_gate", "d_w_up", "d_w_down"):
        total = 0.0
        for db in range(dp):
            parts = [_got(worlds, world, "layer_" + name, db * w_e + e)[k]
                     for e in range(w_e if k != "d_router" else 1)]
            total = total + np.concatenate(parts, axis=0)
        assert np.abs(total).max() > 0.1 * np.abs(ref[k]).max(), k
        np.testing.assert_allclose(total, ref[k], err_msg=k, **tol)


@pytest.mark.parametrize("name", ["block_d2", "block_e2", "block_e2d2"])
def test_the_gate_is_global_as_in_jax(worlds, name):
    """The repaired gate: every rank's choices for its tokens (expert, slot,
    kept) and the expert counts equal JAX's gate over the global tokens,
    with tokens dropped at capacity factor 0.5."""
    world, mesh = LAYERS[name][:2]
    ref = worlds["layer_refs"][name]
    block_of, dp = _rank_rows(mesh, world)
    disp = ref["dispatch"]  # [N, E, C]
    n = disp.shape[0] // dp
    assert disp.sum() < disp.shape[0] * 2  # some choices drop
    for r in range(world):
        got = _got(worlds, world, "layer_" + name, r)
        np.testing.assert_array_equal(got["counts"], ref["counts"])
        assert got["capacity"] == disp.shape[2]
        mine = disp[block_of[r] * n:(block_of[r] + 1) * n]
        want = np.zeros_like(mine)
        for t in range(n):
            for c in range(got["expert"].shape[1]):
                if got["keep"][t, c]:
                    want[t, got["expert"][t, c], got["position"][t, c]] = True
        np.testing.assert_array_equal(want, mine)


def test_expert_collectives_are_counted_by_op_and_axis(worlds):
    counts = {n: _got(worlds, CASES[n][0], n)["counts"] for n in CASES}
    assert counts["expert2"]["all_reduce@expert"] > 0  # the routed layer's g
    assert counts["ep2_int8"]["all_to_all@expert"] > 0  # the dispatch and combine
    assert counts["data2"]["all_gather@data"] > 0  # the gate's global logits
    assert counts["e2m2"]["all_reduce@expert+model"] > 0


def test_a_checkpoint_saved_at_expert_2_resumes_at_expert_1(worlds):
    engine = _torch_engine(worlds["jp"], config(None, GLOBAL_MICRO))
    engine.load_checkpoint(str(worlds["tmp"] / "ckpt_e2"))
    assert engine.global_steps == 2
    resumed = _torch_steps(engine, worlds["ckpt_data"][2:])
    np.testing.assert_allclose(resumed, _got(worlds, 2, "ckpt")["losses"][2:], **TOL)


def test_a_one_device_checkpoint_resumes_at_expert_2(worlds):
    for r in (0, 1):
        got = _got(worlds, 2, "resume", r)
        assert got["steps"] == 4
        np.testing.assert_allclose(got["losses"], worlds["one_losses"][2:], **TOL)


def test_the_expert_plan_equals_jax_leaf_for_leaf():
    """``plan_sharding`` with the expert and model rules (JAX's
    ``tp_rules`` for MoE) over ``expert`` 2 x ``fsdp`` 2 at stages 1 and 3."""
    jcfg = j_preset("tiny_moe", dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jt.init_params(jax.random.PRNGKey(0), jcfg))
    tcfg = get_preset("tiny_moe", dtype=torch.float32)
    tshapes = tt.init_params(tcfg, device="meta")
    for stage in (1, 3):
        z = {"stage": stage, "param_persistence_threshold": 0}
        jplan = jzero.plan_sharding(shapes, jds.config.config.ZeroConfig(**z),
                                    JMeshSpec(expert=2, fsdp=2), jt.tp_rules(jcfg))
        tplan = tzero.plan_sharding(tshapes, ZeroConfig(**z), MeshSpec(expert=2, fsdp=2),
                                    tt.tp_rules(tcfg))
        for attr in ("param_specs", "master_specs"):
            jflat = W._flat(jax.tree_util.tree_map(tuple, getattr(jplan, attr),
                                                   is_leaf=lambda x: isinstance(x, tuple)))
            tflat = W._flat(getattr(tplan, attr))
            assert {k: tuple(v) for k, v in tflat.items()} == \
                {k: tuple(v) for k, v in jflat.items()}, (stage, attr)


@pytest.mark.parametrize("world", [2, 4])
def test_what_stays_refused_names_item_7(worlds, world):
    for r in range(world):
        got = _got(worlds, world, "refusals", r)
        assert set(got) == ({"ep_model"} if world == 4 else {"serve_v2", "serve_v1", "lamb"})
        for k, v in got.items():
            assert v.startswith("NotImplementedError") and "item 7" in v, (k, v)
