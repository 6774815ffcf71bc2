"""Tensor parallelism across processes: the port's engine on worlds of 2
and 4 gloo ranks on the CPU with a ``model`` axis, against the JAX engine
on a ``model`` mesh of the forced CPU devices (``tests/conftest.py``), in
fp32 with JAX's ``init_params(PRNGKey(0))``; and the rules (``tp_rules``,
``infer_tp_rules``, the ZeRO plan with them) against JAX's, rule for rule.

One 2-rank world runs ``tiny``, ``tiny_gpt2`` (tied embeddings, learned
positions), ``tiny_parallel`` (parallel block, partial rotary, biases),
``domino_chunks`` 2 and a batch with masked labels (at ZeRO stage 1) at
``model`` 2, ``tiny`` over a ``model`` axis of 1 beside ``data`` 2 (the
card's world-1 path: a ``mesh`` section that names ``model``), ZeRO++ at
stage 3 and 1-bit Adam over a ``model`` axis of 1 against the same runs
without one, a checkpoint saved at
``model`` 2 and one loaded there from a one-device save, and what stays
refused; one 4-rank world runs ``tiny`` at ``model`` 4 (its 2 kv heads
replicated and narrowed: a rank's one q head reads one kv head) and
``model`` 2 x ``fsdp`` 2 at ZeRO stage 3.  The replicated and narrowed
leaves of every rank's shard must be bit-equal across the ranks of its
tensor-parallel group after every step.

JAX trains ``tiny`` at ``model`` 4 with ``wk`` / ``wv`` sharded below a
head (GSPMD keeps the values whole); the port keeps them replicated and
narrowed, so the two plans differ on those leaves: the test compares
values, not layouts.

Serving, in the same worlds (``tiny``, fp32, against the JAX engines
unsharded): greedy decoding is TOKEN-IDENTICAL to JAX's one-device engine
-- the v2 engine's packed prefill and decode ticks at ``model`` 2 and 4
(at 4, the 2 kv heads are fewer than the ranks: a rank's pool holds the
kv head its one q head reads), its scheduler with prefix caching and
chunked prefill (the packed-context attention), int8 / fp8 / fp6 weights
at ``model`` 2 (the scales of each whole kernel, the FP6 row kernels
packed per K-chunk), ``comm_tiles`` 2 over int8 weights, and
``init_inference``'s dense cache.  Each rank's tokens equal every other
rank's, in a sampled run too (each rank samples the gathered logits with
the same generator).  The quantized transport (``quant_comm`` int8 / fp8:
``qcomm.q_psum_tiled`` over ``model``) equals JAX's under ``shard_map``
to two ulps, its int8 payload byte for byte (``test_torch_comm.py``'s
tolerance), and an engine of int8 weights serving through it draws JAX's
tokens on a ``model`` 2 mesh with the same transport (as in JAX, the
transport moves the quantized kernels' partial sums; a plain kernel's
reduce exactly).  Every world has a timeout: ranks that drew different
tokens fail, not hang.

Tolerances (fp32), those of ``test_torch_zero.py``: losses and gradient
norms atol 1e-5 / rtol 1e-4 (the ranks' partial sums add in another order
than XLA's); parameters after 3 AdamW steps atol 2e-4 / rtol 1e-4: Adam
divides by ``sqrt(v) + eps``, which magnifies an ulp of a near-zero
gradient entry (here the partial products summed over ``model`` move the
last bits of such entries; the port's one-device engine against its own
``model`` 2 engine differs by 8.4e-5 in one element of ``tiny`` after 3
steps).  A resumed run's losses equal the uninterrupted run's to TOL (the
two run at different ``model`` sizes).
"""
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

import deepspeed_tpu as jds
from deepspeed_tpu.comm import qcomm as jq
from deepspeed_tpu.config.config import ZeroConfig as JZeroConfig
from deepspeed_tpu.inference.engine import init_inference as j_init_inference
from deepspeed_tpu.inference.engine_v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.sampling import SamplingParams as JSampling
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.models.presets import get_preset as j_preset
from deepspeed_tpu.parallel import auto_tp as jauto
from deepspeed_tpu.parallel.topology import MeshSpec as JMeshSpec
from deepspeed_tpu.parallel.sharding import shard_map_compat
from deepspeed_tpu.parallel.topology import initialize_mesh
from deepspeed_tpu.runtime import zero as jzero

import torch_world as W
import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.config.config import ZeroConfig
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.parallel import auto_tp as tauto
from deepspeed_tpu_torch.parallel.topology import MeshSpec
from deepspeed_tpu_torch.runtime import zero as tzero
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread)

TOL = dict(atol=1e-5, rtol=1e-4)
PARAM_TOL = dict(atol=2e-4, rtol=1e-4)
STEPS = 3
GAS = 2
# a key bias shifts every logit of a query's row alike, which the softmax
# cancels: its gradient is zero up to rounding, which Adam's normalized
# step turns into updates of up to lr each, in either package's own order
ZERO_GRAD_LEAVES = {"layers/attn/bk"}
GLOBAL_MICRO = 4


def config(stage=0, micro=GLOBAL_MICRO, mesh=None, **over):
    cfg = {"train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": GAS,
           "optimizer": {"type": "adamw", "params": {"lr": 3e-3, "weight_decay": 0.1}},
           "gradient_clipping": 0.5, "bf16": {"enabled": False}, "steps_per_print": 1000,
           "zero_optimization": {"stage": stage, "param_persistence_threshold": 0}}
    if mesh is not None:
        cfg["mesh"] = mesh
    cfg.update(over)
    return cfg


def _batches(n, seed=7, labels=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if not labels:
            out.append({"input_ids": rng.integers(0, 256, (GAS, GLOBAL_MICRO, 17)).astype(np.int64)})
            continue
        ids = rng.integers(0, 256, (GAS, GLOBAL_MICRO, 16)).astype(np.int64)
        lab = rng.integers(0, 256, (GAS, GLOBAL_MICRO, 16)).astype(np.int64)
        lab[:, :2, 3:] = -100
        lab[1, 2, 5:] = -100
        out.append({"input_ids": ids, "labels": lab})
    return out


def _save_batches(path, batches):
    np.savez(path, **{f"{i}/{k}": v for i, b in enumerate(batches) for k, v in b.items()})


def _jax_run(jcfg, jp, cfg, batches, devices=2, **mesh):
    engine, *_ = jds.initialize(model=jt.CausalLM(jcfg),
                                params=jax.tree_util.tree_map(jnp.asarray, jp), config=cfg,
                                mesh=initialize_mesh(devices=jax.devices()[:devices], **mesh))
    losses, norms = [], []
    for b in batches:
        losses.append(float(engine.train_batch({k: v.astype(np.int32) for k, v in b.items()})))
        norms.append(engine.get_global_grad_norm())
    params = W._flat(jax.tree_util.tree_map(np.asarray, engine.state.params))
    return {"losses": losses, "norms": norms, "params": params}


def _torch_engine(preset, jp, cfg):
    model = tt.CausalLM(get_preset(preset, dtype=torch.float32, attn_impl="flash",
                                   remat="selective"))
    params = tt.params_from_numpy(jp, model.cfg, device="cpu")
    engine, *_ = tds.initialize(model=model, params=params, config=cfg, device="cpu")
    return engine


def _torch_steps(engine, batches):
    return [float(engine.train_batch({k: torch.from_numpy(v) for k, v in b.items()}))
            for b in batches]


RTOL = dict(rtol=1e-6, atol=2.4e-7)
NEW = 6
V2 = dict(max_seqs=4, num_blocks=48, block_size=8, prefill_buckets=(32, 64))
SCHED = dict(V2, enable_prefix_caching=True, prefill_chunk=16)
# the quantized transport moves the partial sums of quantized kernels (a
# plain kernel reduces exactly, as in JAX)
QCOMM = dict(V2, quantize_weights="int8")


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(1, 256, n).tolist() for n in (5, 19, 12, 30)]


def _shared_prompts():
    """A shared system prompt: later requests hit the prefix cache, and the
    longer ones continue in chunks."""
    rng = np.random.default_rng(1)
    system = rng.integers(1, 256, 24).tolist()
    return [system + rng.integers(1, 256, n).tolist() for n in (3, 11, 20)]


def _jax_tokens(jcfg, jp, kw, prompts, scheduler=False, quantize=None):
    kw = {k: v for k, v in kw.items() if k not in ("comm_tiles", "quant_comm")}
    eng = JEngine(jp, jcfg, **kw)
    sampling = JSampling(max_new_tokens=NEW)
    if scheduler:
        s = eng.scheduler
        for u, toks in enumerate(prompts, 1):
            s.submit(u, toks, sampling)
        res = s.run()
        return {u: list(res[u]) for u in res}
    first = eng.put(list(range(1, len(prompts) + 1)), prompts, sampling)
    ticks = [eng.step(sampling) for _ in range(NEW - 1)]
    return {u: [first[u]] + [t[u] for t in ticks if u in t] for u in first}


# name -> (world, engine kwargs, prompts, scheduler, quantize)
V2_CASES = {
    "tp2": (2, V2, "plain", False, None),
    "tp2_sched": (2, SCHED, "shared", True, None),
    "tp2_int8": (2, dict(V2, quantize_weights="int8"), "plain", False, "int8"),
    "tp2_fp8": (2, dict(V2, quantize_weights="fp8"), "plain", False, "fp8"),
    "tp2_fp6": (2, dict(V2, quantize_weights="fp6"), "plain", False, "fp6"),
    "tp2_tiles": (2, dict(V2, quantize_weights="int8", comm_tiles=2), "plain", False, "int8"),
    "tp4": (4, V2, "plain", False, None),
    "tp4_sched": (4, SCHED, "shared", True, None),
}


# name -> (preset, world, port mesh, stage, extra config, JAX mesh, batches)
CASES = {
    "tiny": ("tiny", 2, {"model": 2}, 0, {}, dict(model=2), "plain"),
    "gpt2": ("tiny_gpt2", 2, {"model": 2}, 0, {}, dict(model=2), "plain"),
    "parallel": ("tiny_parallel", 2, {"model": 2}, 0, {}, dict(model=2), "plain"),
    "domino": ("tiny", 2, {"model": 2}, 0, {"tensor_parallel": {"domino_chunks": 2}}, None,
               "plain"),
    "masked": ("tiny", 2, {"model": 2}, 1, {}, dict(model=2), "tok"),
    # the card's world-1 path: a model axis of one, its collectives groups
    # of one, beside a data axis of 2; held to the ``tiny`` case's JAX run
    # (the same global batch and step on a model mesh of 2)
    "tp1": ("tiny", 2, {"model": 1}, 0, {}, None, "plain"),
    "tiny4": ("tiny", 4, {"model": 4}, 0, {}, None, "plain"),
    "m2f2s3": ("tiny", 4, {"model": 2, "fsdp": 2}, 3, {}, None, "plain"),
}
# the cases held to the ``tiny`` case's JAX run: the same global batch,
# optimizer and step on another layout or in batch chunks (JAX's ``model``
# 4, ``model`` 2 x ``fsdp`` 2 and ``domino_chunks`` 2 runs differ from its
# ``model`` 2 run by at most 1.4e-6 in a loss and 5.3e-5 in a parameter,
# inside TOL and PARAM_TOL)
SAME_AS_TINY = ("tp1", "tiny4", "m2f2s3", "domino")


# a model axis of one beside what JAX runs with it: ZeRO++'s quantized
# weights and gradients at stage 3, 1-bit Adam at stage 0; each held to
# the same run without a model entry
ZPP = {"stage": 3, "param_persistence_threshold": 0, "zero_quantized_weights": True,
       "zero_quantized_gradients": True}
ONEBIT = {"type": "onebitadam", "params": {"lr": 3e-3, "freeze_step": 2, "weight_decay": 0.01}}
MODEL1 = {"zeropp": dict(zero_optimization=ZPP), "onebit": dict(optimizer=ONEBIT)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_world")
    data = {"plain": _batches(STEPS), "tok": _batches(STEPS, seed=11, labels=True),
            "ckpt": _batches(4, seed=13)}
    for k, v in data.items():
        _save_batches(tmp / f"{k}.npz", v)
    jps = {}
    for preset in ("tiny", "tiny_gpt2", "tiny_parallel"):
        jcfg = j_preset(preset, dtype=jnp.float32)
        jps[preset] = (jcfg, jax.tree_util.tree_map(
            np.asarray, jt.init_params(jax.random.PRNGKey(0), jcfg)))
        W.save_tree(tmp / f"{preset}.npz", jps[preset][1])
    # the reverse resume: a one-device engine saves after 2 steps
    one = _torch_engine("tiny", jps["tiny"][1], config())
    one_losses = _torch_steps(one, data["ckpt"])
    fresh = _torch_engine("tiny", jps["tiny"][1], config())
    _torch_steps(fresh, data["ckpt"][:2])
    fresh.save_checkpoint(str(tmp / "ckpt_one"))

    by_world = {2: [], 4: []}
    for name, (preset, world, mesh, stage, extra, _, batches) in CASES.items():
        dp = world // mesh["model"]
        by_world[world].append(dict(
            name=name, kind="tp_train", preset=preset, params=str(tmp / f"{preset}.npz"),
            batches=str(tmp / f"{batches}.npz"),
            config=config(stage, GLOBAL_MICRO // dp, mesh, comms_logger={"enabled": True},
                          **extra)))
    by_world[2] += [
        dict(name="ckpt", kind="tp_train", preset="tiny", params=str(tmp / "tiny.npz"),
             batches=str(tmp / "ckpt.npz"), config=config(0, mesh={"model": 2}),
             ckpt=str(tmp / "ckpt_tp"), ckpt_after=2),
        dict(name="resume", kind="fn", fn="tp_resume", params=str(tmp / "tiny.npz"),
             batches=str(tmp / "ckpt.npz"), ckpt=str(tmp / "ckpt_one"),
             config=config(0, mesh={"model": 2})),
        dict(name="refusals", kind="fn", fn="tp_refusals"),
    ]
    for name, over in MODEL1.items():
        for mesh in (None, {"model": 1}):
            by_world[2].append(dict(
                name=name + ("_m1" if mesh else ""), kind="train", params=str(tmp / "tiny.npz"),
                batches=str(tmp / "plain.npz"), save_params=False,
                config=config(0, GLOBAL_MICRO // 2, mesh, comms_logger={"enabled": True},
                              **over)))
    prompts, v1_prompts, partials = _serving_cases(tmp, by_world)
    # the worlds run while the JAX references are built: the unsharded
    # serving engines' in a JAX process of their own, the rest here
    spawn = multiprocessing.get_context("spawn")
    with ThreadPoolExecutor(len(by_world)) as pool, \
            ProcessPoolExecutor(1, mp_context=spawn) as jax_child:
        futures = {w: pool.submit(W.spawn, w, cases, tmp / f"w{w}", timeout=600)
                   for w, cases in by_world.items()}
        serving = jax_child.submit(_v2_refs, str(tmp / "tiny.npz"), prompts, v1_prompts)
        refs = {}
        for name, (preset, world, _, stage, extra, jmesh, batches) in CASES.items():
            if jmesh is not None:
                jcfg, jp = jps[preset]
                refs[name] = _jax_run(jcfg, jp, config(stage, **extra), data[batches],
                                      devices=world, **jmesh)
        for name in SAME_AS_TINY:
            refs[name] = refs["tiny"]
        refs.update(_model2_refs(jps["tiny"][1], prompts["plain"]))
        refs.update(serving.result(timeout=600))
        ranks = {w: f.result() for w, f in futures.items()}
    return {"ranks": ranks, "refs": refs, "tmp": tmp, "jps": jps, "data": data,
            "one_losses": one_losses, "partials": partials}


def _serving_cases(tmp, by_world):
    """The serving cases of both worlds (``tiny.npz`` is the training
    cases' weights); returns their prompts and the transport's partials."""
    prompts = {"plain": _prompts(), "shared": _shared_prompts()}
    partials = np.random.default_rng(5).standard_normal((2, 3, 96)).astype(np.float32)
    np.savez(tmp / "psum.npz", y=partials)
    common = dict(params=str(tmp / "tiny.npz"), preset="tiny")
    for name, (world, kw, pr, sched, _) in V2_CASES.items():
        by_world[world].append(dict(name=name, kind="tp_serve", engine_kw=kw,
                                    prompts=prompts[pr], scheduler=sched, **common))
    v1_prompts = [p[:9] for p in prompts["plain"][1:]]
    by_world[2] += [
        dict(name="sampled", kind="tp_serve", engine_kw=V2, prompts=prompts["plain"],
             temperature=0.8, **common),
        dict(name="qcomm_int8", kind="tp_serve", engine_kw=dict(QCOMM, quant_comm="int8"),
             prompts=prompts["plain"], **common),
        dict(name="qcomm_fp8", kind="tp_serve", engine_kw=dict(QCOMM, quant_comm="fp8"),
             prompts=prompts["plain"], **common),
        dict(name="v1", kind="tp_serve", engine_kw={}, prompts=v1_prompts, v1=True, **common),
        dict(name="psum", kind="fn", fn="tp_psum", inputs=str(tmp / "psum.npz"), tiles=3),
        dict(name="serve_refusals", kind="fn", fn="tp_serve_refusals"),
    ]
    by_world[4].append(dict(name="v1_4", kind="tp_serve", engine_kw={}, prompts=v1_prompts,
                            v1=True, **common))
    return prompts, v1_prompts, partials


def _v2_refs(params_npz, prompts, v1_prompts):
    """JAX's unsharded engines' tokens for ``V2_CASES`` and
    ``init_inference`` (run in a process of its own: the forced CPU devices
    come with ``XLA_FLAGS``)."""
    jax.config.update("jax_platforms", "cpu")
    jp = W.load_tree(params_npz)
    jcfg = j_preset("tiny", dtype=jnp.float32, max_seq_len=256)
    refs = {name: _jax_tokens(jcfg, jp, kw, prompts[pr], sched, quant)
            for name, (_, kw, pr, sched, quant) in V2_CASES.items()
            if name not in ("tp4", "tp4_sched", "tp2_tiles")}
    refs["tp4"] = refs["tp2"]
    refs["tp2_tiles"] = refs["tp2_int8"]
    refs["tp4_sched"] = refs["tp2_sched"]
    j1 = j_init_inference(jt.CausalLM(jcfg), jp)
    refs["v1"] = np.asarray(j1.generate(jnp.asarray(v1_prompts, jnp.int32),
                                        JSampling(max_new_tokens=NEW))).tolist()
    return refs


def _model2_refs(jp, prompts):
    """JAX's tokens for the quantized transport: its engine over a ``model``
    2 mesh with the same int8 weights and ``quant_comm`` (the quantized
    kernels' partial sums ride the lossy codec)."""
    jcfg = j_preset("tiny", dtype=jnp.float32, max_seq_len=256)
    grid = initialize_mesh(devices=jax.devices()[:2], model=2)
    refs = {}
    for fmt in ("int8", "fp8"):
        eng = JEngine(jp, jcfg, grid=grid, quant_comm=fmt, **QCOMM)
        sampling = JSampling(max_new_tokens=NEW)
        first = eng.put(list(range(1, len(prompts) + 1)), prompts, sampling)
        ticks = [eng.step(sampling) for _ in range(NEW - 1)]
        refs[f"qcomm_{fmt}"] = {u: [first[u]] + [t[u] for t in ticks if u in t]
                                for u in first}
    return refs


def _world_of(name):
    if name in CASES:
        return CASES[name][1]
    if name in V2_CASES:
        return V2_CASES[name][0]
    return 4 if name.endswith("_4") else 2


def _got(worlds, name, rank=0):
    return worlds["ranks"][_world_of(name)][rank][name]


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_axis_trains_as_the_jax_engine(worlds, case):
    """Losses, norms and the whole masters after 3 steps equal the JAX
    engine's on a ``model`` mesh; every rank reports the same numbers."""
    got, ref = _got(worlds, case), worlds["refs"][case]
    np.testing.assert_allclose(got["losses"], ref["losses"], **TOL)
    np.testing.assert_allclose(got["norms"], ref["norms"], **TOL)
    assert set(got["params"]) == set(ref["params"])
    for k, v in ref["params"].items():
        if k in ZERO_GRAD_LEAVES:
            # rounding noise that Adam turns into steps of up to lr each
            bound = 3e-3 * STEPS * 1.01
            assert np.abs(got["params"][k]).max() <= bound >= np.abs(v).max(), k
            continue
        np.testing.assert_allclose(got["params"][k], v, err_msg=k, **PARAM_TOL)
    world = CASES[case][1]
    for r in range(1, world):
        other = _got(worlds, case, r)
        np.testing.assert_array_equal(other["losses"], got["losses"])
        for k, v in got["params"].items():
            np.testing.assert_array_equal(other["params"][k], v, err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_replicated_leaves_stay_bit_equal_across_the_model_group(worlds, case):
    """The norms, biases after the all-reduce, the position table and the
    narrowed kv projections are whole on every rank of a tensor-parallel
    group and bit-equal there after every step."""
    preset, world, mesh = CASES[case][:3]
    tp = mesh["model"]
    for r in range(world):
        got = _got(worlds, case, r)
        peer = _got(worlds, case, r - r % tp)  # the group's first rank
        assert got["tp"][:2] == (tp, r % tp)
        for step, leaves in enumerate(got["replicated"]):
            assert leaves, case
            for k, v in leaves.items():
                np.testing.assert_array_equal(v, peer["replicated"][step][k],
                                              err_msg=f"{case} rank {r} step {step} {k}")


def test_model_4_narrows_two_kv_heads_over_four_ranks(worlds):
    got = _got(worlds, "tiny4")
    assert got["tp"] == (4, 0, False, True)
    narrowed = {k for k in got["replicated"][0] if k.startswith("layers/attn/w")}
    assert narrowed == {"layers/attn/wk", "layers/attn/wv"}
    assert _got(worlds, "tiny")["tp"] == (2, 0, True, True)


def test_the_model_collectives_are_counted_by_op_and_axis(worlds):
    """The f / g pair, the vocab-parallel embedding and loss all-reduce over
    ``model``; the data-parallel reductions stay on the batch axes, one
    group of one rank each at ``model`` 2 of 2."""
    counts = _got(worlds, "tiny")["counts"]
    assert counts["all_reduce@model"] > 0
    assert set(counts) == {"all_reduce@model", "all_reduce@data+fsdp+sub"}
    # per micro-batch: the token count; per step: the loss and the gradient
    assert counts["all_reduce@data+fsdp+sub"] == STEPS * (GAS + 2)
    assert _got(worlds, "tiny", 1)["counts"] == counts
    assert _got(worlds, "tiny")["dp"] == 1 and _got(worlds, "m2f2s3")["dp"] == 2


def test_masked_labels_take_the_vocab_parallel_token_mean(worlds):
    got, ref = _got(worlds, "masked"), worlds["refs"]["masked"]
    np.testing.assert_allclose(got["losses"], ref["losses"], **TOL)


def test_a_checkpoint_saved_at_model_2_resumes_at_model_1(worlds):
    """``model`` 2 saves after 2 of 4 steps; a one-device engine loads the
    logical tensors and its last 2 losses equal the uninterrupted run's."""
    engine = _torch_engine("tiny", worlds["jps"]["tiny"][1], config())
    engine.load_checkpoint(str(worlds["tmp"] / "ckpt_tp"))
    assert engine.global_steps == 2
    resumed = _torch_steps(engine, worlds["data"]["ckpt"][2:])
    np.testing.assert_allclose(resumed, _got(worlds, "ckpt")["losses"][2:], **TOL)


def test_a_one_device_checkpoint_resumes_at_model_2(worlds):
    for r in (0, 1):
        got = _got(worlds, "resume", r)
        assert got["steps"] == 2
        np.testing.assert_allclose(got["losses"], worlds["one_losses"][2:], **TOL)


@pytest.mark.parametrize("case", sorted(MODEL1))
def test_a_model_axis_of_one_composes_with_zeropp_and_onebit(worlds, case):
    """JAX runs ZeRO++ and the 1-bit optimizers beside any model axis; at a
    model axis of one the port's tensor-parallel path runs them too (its
    all-reduces over ``model`` made), with the losses and norms of the
    same run without a model entry."""
    got, ref = _got(worlds, case + "_m1"), _got(worlds, case)
    assert got["counts"].get("all_reduce@model", 0) > 0
    assert not any(k.endswith("@model") for k in ref["counts"])
    np.testing.assert_allclose(got["losses"], ref["losses"], **TOL)
    np.testing.assert_allclose(got["norms"], ref["norms"], **TOL)


def test_what_stays_refused_at_model_2_names_item_7(worlds):
    for r in (0, 1):
        got = _got(worlds, "refusals", r)
        assert set(got) == {"moe", "sparse", "onebit", "lamb", "loss_fn"}
        for name in ("sparse", "onebit", "lamb"):
            assert "item 7" in got[name], (name, got[name])
        # MoE layers train under a model axis now
        # (tests/test_torch_expert.py holds them to JAX)
        assert got["moe"] == "trained"
        assert "model=" in got["loss_fn"]


# ---------------------------------------------------------------------------
# serving over the model axis
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", sorted(V2_CASES))
def test_tensor_parallel_serving_is_token_identical_to_jax_unsharded(worlds, case):
    """Greedy tokens equal JAX's one-device engine's, on every rank; every
    block returns to the pool."""
    want = worlds["refs"][case]
    for r in range(_world_of(case)):
        got = _got(worlds, case, r)
        assert {int(u): t for u, t in got["tokens"].items()} == want, (case, r)
        assert got["blocks_in_use"] == 0


def test_the_pools_hold_each_rank_s_kv_heads(worlds):
    """``tiny``'s 2 kv heads: one a rank at ``model`` 2; at ``model`` 4 the
    one its q head reads."""
    assert _got(worlds, "tp2")["pool_heads"] == 1
    assert _got(worlds, "tp4")["pool_heads"] == 1


def test_row_parallel_partials_reduce_over_the_model_axis(worlds):
    """Each layer's two row-parallel matmuls reduce over ``model`` and the
    logits gather their vocab shards, once a dispatch: 2 packs of prefill
    plus 5 decode ticks over 2 layers.  ``comm_tiles`` 2 reduces a
    quantized kernel's output in two tiles (a plain kernel in one, as in
    JAX)."""
    counts = _got(worlds, "tp2")["counts"]
    assert counts["all_reduce@model"] % (2 * 2) == 0 and counts["all_reduce@model"] > 0
    assert counts["all_gather@model"] * 4 == counts["all_reduce@model"]
    assert _got(worlds, "tp2_int8")["counts"] == counts
    tiles = _got(worlds, "tp2_tiles")["counts"]
    assert tiles["all_reduce@model"] == 2 * counts["all_reduce@model"]


@pytest.mark.parametrize("case", ["v1", "v1_4"])
def test_init_inference_over_a_model_axis_is_token_identical_to_jax(worlds, case):
    for r in range(_world_of(case)):
        assert _got(worlds, case, r)["tokens"] == worlds["refs"]["v1"], (case, r)


def test_a_sampled_run_draws_the_same_tokens_on_every_rank(worlds):
    a, b = _got(worlds, "sampled", 0)["tokens"], _got(worlds, "sampled", 1)["tokens"]
    assert a == b
    assert a != worlds["refs"]["tp2"]  # it sampled


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_an_engine_serves_through_the_quantized_transport(worlds, fmt):
    """The int8 kernels' partial sums ride the lossy transport: every
    rank's greedy tokens equal JAX's engine over a ``model`` 2 mesh with
    the same weights and ``quant_comm``, and the sums moved by
    all-gather."""
    want = worlds["refs"][f"qcomm_{fmt}"]
    for r in range(2):
        got = _got(worlds, f"qcomm_{fmt}", r)
        assert {int(u): t for u, t in got["tokens"].items()} == want, (fmt, r)
    assert _got(worlds, f"qcomm_{fmt}")["counts"].get("all_gather@model", 0) > 0


def test_the_vocab_parallel_loss_at_one_rank_is_the_plain_cross_entropy(monkeypatch):
    """Over a model axis of one (its all-reduces the identity) the
    vocab-parallel loss, the gradient of its logits and of what made them
    equal ``cross_entropy_loss``'s bit for bit in fp32, masked labels
    included (a loss formed in another order differs in the last bits)."""
    from deepspeed_tpu_torch.parallel.context import ParallelContext
    from deepspeed_tpu_torch.parallel.tensor_parallel import TensorParallel

    cfg = get_preset("tiny", vocab_size=1000)
    par = ParallelContext(sizes={"model": 1}, coords={"model": 0},
                          tp=TensorParallel(None, cfg, rank=0, size=1))
    monkeypatch.setattr(par, "_all_reduce", lambda x, axis, op="sum": x.clone())
    gen = torch.Generator().manual_seed(0)
    h = torch.randn(512, 64, generator=gen)
    w = torch.randn(64, 1000, generator=gen) / 8
    labels = torch.randint(0, 1000, (512,), generator=gen)
    labels[:37] = -100

    def run(loss_of):
        hh, ww = h.clone().requires_grad_(True), w.clone().requires_grad_(True)
        logits = hh @ ww
        logits.retain_grad()
        loss = loss_of(logits)
        loss.backward()
        return loss.detach(), logits.grad, hh.grad, ww.grad

    def vocab_parallel(logits):
        nll, n = tt.vocab_parallel_cross_entropy(logits, labels, par)
        return nll / n.clamp(min=1.0)

    plain = run(lambda logits: tt.cross_entropy_loss(logits, labels))
    for a, b in zip(run(vocab_parallel), plain):
        assert torch.equal(a, b)


def _jax_psum(partials, tiles):
    mesh = Mesh(np.array(jax.devices()[:2]), ("model",))

    def body(y):
        out = {fmt: jq.q_psum_tiled(y[0], "model", fmt, tiles=tiles)
               for fmt in ("none", "int8", "fp8")}
        return {k: v[None] for k, v in out.items()}

    fn = shard_map_compat(body, mesh, in_specs=(JP("model"),), out_specs=JP("model"))
    out = {k: np.asarray(v) for k, v in jax.jit(fn)(jnp.asarray(partials)).items()}
    out["q"], out["s"] = zip(*(jq.quantize_payload(p, "int8") for p in partials))
    return out


def test_quant_comm_partial_sums_equal_jax_and_the_payload_its_bytes(worlds):
    ref = _jax_psum(worlds["partials"], 3)
    for r in range(2):
        got = _got(worlds, "psum", r)
        for fmt in ("none", "int8", "fp8"):
            np.testing.assert_allclose(got[fmt], ref[fmt][r], err_msg=f"{fmt} rank {r}",
                                       **RTOL)
        q, s = got["payload"]
        np.testing.assert_array_equal(q.reshape(-1), np.asarray(ref["q"][r]).reshape(-1))
        np.testing.assert_array_equal(s.reshape(-1), np.asarray(ref["s"][r]).reshape(-1))


def test_what_a_tensor_parallel_engine_refuses_names_item_7(worlds):
    for r in range(2):
        got = _got(worlds, "serve_refusals", r)
        assert set(got) == {"speculation", "megastep", "deadline", "moe", "step_n"}
        for name, msg in got.items():
            assert "item 7" in msg, (name, msg)


# ---------------------------------------------------------------------------
# the rules, on the host
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("preset", ["tiny", "tiny_moe", "tiny_gpt2"])
def test_tp_rules_equal_jax(preset):
    j = [(pat, tuple(spec)) for pat, spec in jt.tp_rules(j_preset(preset))]
    t = [(pat, tuple(spec)) for pat, spec in tt.tp_rules(get_preset(preset))]
    assert t == j


@pytest.mark.parametrize("preset,tp", [("tiny", 2), ("tiny", 4), ("tiny_gpt2", 2),
                                       ("tiny_parallel", 4)])
def test_a_rank_s_kernels_lie_as_jax_s_autotp_rules(preset, tp):
    """A rank's layout takes its kernels from AutoTP with the head hints
    (JAX's v2 engine's call): every kernel JAX's ``infer_tp_rules`` shards
    is sharded on the same dim on every rank; a kv kernel its head gate
    keeps whole is narrowed; every other kernel is whole."""
    from deepspeed_tpu_torch.parallel.tensor_parallel import TensorParallel

    jcfg = j_preset(preset)
    shapes = jax.eval_shape(lambda k: jt.CausalLM(jcfg).init_params(k), jax.random.PRNGKey(0))
    rules = jauto.infer_tp_rules(shapes, tp, vocab_size=jcfg.vocab_size,
                                 num_heads=jcfg.num_heads, num_kv_heads=jcfg.num_kv_heads)
    jdims = {pat[1:-1].replace("\\", ""): list(spec).index("model") for pat, spec in rules}
    cfg = get_preset(preset)
    tree = tt.init_params(cfg, device="meta")
    kernels = [p for p, x in W._flat(tree).items()
               if x.dim() == 3 or p in ("embed/embedding", "lm_head/kernel")]
    assert kernels
    for r in range(tp):
        pls = {"/".join(p): pl for p, pl in TensorParallel(None, cfg, rank=r,
                                                            size=tp).placements(tree).items()}
        for path in kernels:
            pl = pls[path]
            if path in jdims:
                assert (pl.kind, pl.dim) == ("shard", jdims[path]), path
            elif path.split("/")[-1] in ("wk", "wv") and jcfg.num_kv_heads % tp:
                assert pl.kind == "narrow", path
            else:
                assert pl.kind == "rep", path


def _jtree(name):
    if name == "model":
        cfg = j_preset("tiny")
        return jax.eval_shape(lambda k: jt.CausalLM(cfg).init_params(k),
                              jax.random.PRNGKey(0)), cfg
    if name == "foreign":
        return {"h": {"attn": {"q_proj": jnp.zeros((64, 64)), "o_proj": jnp.zeros((64, 64))},
                      "mlp": {"fc1": jnp.zeros((64, 128)), "fc2": jnp.zeros((128, 64)),
                              "fc1_bias": jnp.zeros((128,))},
                      "ln": {"weight": jnp.zeros((64,))}}}, None
    if name == "indivisible":
        return {"w": jnp.zeros((7, 13))}, None
    return {"layers": {"attn": {"wq": jnp.zeros((3, 64, 64)), "wk": jnp.zeros((3, 64, 32)),
                                "wv": jnp.zeros((3, 64, 32)), "wo": jnp.zeros((3, 64, 64)),
                                "bk": jnp.zeros((3, 32))}}}, None


def _ttree(jtree):
    return jax.tree_util.tree_map(lambda x: torch.zeros(tuple(x.shape)), jtree)


@pytest.mark.parametrize("tree,kw", [
    ("model", dict(model_axis_size=2, vocab_size=256)),
    ("model", dict(model_axis_size=2, vocab_size=256, num_heads=4, num_kv_heads=2)),
    ("model", dict(model_axis_size=4, vocab_size=256, num_heads=4, num_kv_heads=2)),
    ("foreign", dict(model_axis_size=4)),
    ("indivisible", dict(model_axis_size=4)),
    ("heads", dict(model_axis_size=4, num_heads=4, num_kv_heads=2)),
    ("heads", dict(model_axis_size=4)),
    ("heads", dict(model_axis_size=4, num_heads=2, num_kv_heads=2)),
], ids=lambda x: str(x))
def test_infer_tp_rules_answers_as_jax_rule_for_rule(tree, kw):
    jtree, _ = _jtree(tree)
    j = [(pat, tuple(spec)) for pat, spec in jauto.infer_tp_rules(jtree, **kw)]
    t = [(pat, tuple(spec)) for pat, spec in tauto.infer_tp_rules(_ttree(jtree), **kw)]
    assert t == j


@pytest.mark.parametrize("fmt", ["int8", "fp6"])
def test_infer_tp_rules_on_quantized_trees_follow_the_kernels(fmt):
    """A quantized kernel's scale shards with a column kernel and stays
    whole for a row one, as JAX's (the FP6 planes rule by shape too)."""
    from deepspeed_tpu.ops.quantizer import quantize_serving_params as j_quantize
    from deepspeed_tpu_torch.ops.quantizer import quantize_serving_params as t_quantize

    jcfg = j_preset("tiny", dtype=jnp.float32)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    kw = dict(model_axis_size=2, vocab_size=256, num_heads=4, num_kv_heads=2)
    shapes = jax.eval_shape(lambda p: j_quantize(p, fmt), jp)  # the rules read shapes alone
    j = [(pat, tuple(spec)) for pat, spec in jauto.infer_tp_rules(shapes, **kw)]
    tcfg = get_preset("tiny", dtype=torch.float32)
    tp = tt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    t = [(pat, tuple(spec)) for pat, spec in tauto.infer_tp_rules(t_quantize(tp, fmt), **kw)]
    assert t == j
    if fmt == "int8":
        assert ("^layers/attn/wq/s$", (None, "model")) in t


@pytest.mark.parametrize("stage,mesh", [(0, dict(model=2)), (1, dict(model=2, fsdp=2)),
                                        (3, dict(model=2, fsdp=2)),
                                        (3, dict(model=4, fsdp=2))], ids=str)
def test_plans_with_tp_rules_equal_jax_leaf_by_leaf(stage, mesh):
    jcfg = j_preset("llama3_proxy_410m", dtype=jnp.float32, num_layers=2)
    shapes = jax.eval_shape(lambda: jt.init_params(jax.random.PRNGKey(0), jcfg))
    jplan = jzero.plan_sharding(shapes, JZeroConfig(stage=stage), JMeshSpec(**mesh),
                                jt.tp_rules(jcfg))
    tshapes = jax.tree_util.tree_map(lambda s: tuple(s.shape), shapes)
    tplan = tzero.plan_sharding(tshapes, ZeroConfig(stage=stage), MeshSpec(**mesh),
                                tt.tp_rules(get_preset("llama3_proxy_410m", num_layers=2)))
    for name in ("param_specs", "master_specs"):
        j = W._flat(jax.tree_util.tree_map(
            tuple, getattr(jplan, name),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
        t = W._flat(getattr(tplan, name))
        assert {k: tuple(v) for k, v in t.items()} == j
