"""A world of gloo ranks on the CPU for the port's multi-rank tests.

``spawn(world, cases, tmp_path)`` starts ``world`` processes
(``torch.multiprocessing``, a ``file://`` rendezvous under ``tmp_path``, so
concurrent test workers never collide), each of which runs every case in
order and writes what it measured; the parent reads rank 0's results (and
every rank's where a case asks).  This module imports torch and the port
only: a spawned child re-imports it, and no child imports JAX.

A case is a dict: ``name``, ``kind`` (a function of this module named
``case_<kind>``) and its arguments (plain data; weights and batches are
``.npz`` files the parent wrote).
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch


def save_tree(path, tree) -> None:
    """A nested dict of arrays as one ``.npz`` keyed by ``a/b/c``."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = np.asarray(v)

    walk(tree, "")
    np.savez(path, **flat)


def load_tree(path):
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _run(rank: int, world: int, rdv: str, spec_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))
    from deepspeed_tpu_torch.comm import comm

    comm.init_distributed(init_method=f"file://{rdv}", device="cpu")
    with open(spec_path, "rb") as fh:
        cases = pickle.load(fh)
    results = {}
    for case in cases:
        results[case["name"]] = globals()["case_" + case["kind"]](rank, world, out_dir, **{
            k: v for k, v in case.items() if k not in ("name", "kind")})
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(results, fh)
    comm.destroy()


def spawn(world: int, cases, tmp_path, timeout: float = None):
    """Run ``cases`` on a world of ``world`` gloo ranks; returns
    ``[results of rank r]``, each ``{case name: what the case returned}``.
    With ``timeout`` (seconds) a world still running then is terminated
    and ``TimeoutError`` raised: ranks that diverge fail, never hang."""
    import time

    import torch.multiprocessing as mp

    out_dir = str(tmp_path)
    os.makedirs(out_dir, exist_ok=True)
    spec = os.path.join(out_dir, "cases.pkl")
    with open(spec, "wb") as fh:
        pickle.dump(cases, fh)
    ctx = mp.spawn(_run, args=(world, os.path.join(out_dir, "rdv"), spec, out_dir),
                   nprocs=world, join=False)
    deadline = None if timeout is None else time.monotonic() + timeout
    while not ctx.join(None if deadline is None else max(deadline - time.monotonic(), 0.1)):
        if deadline is not None and time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
            raise TimeoutError(f"a world of {world} ranks still ran after {timeout} s")
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as fh:
            out.append(pickle.load(fh))
    return out


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------
def _model(preset, dtype="float32", **over):
    from deepspeed_tpu_torch.models import transformer as tt
    from deepspeed_tpu_torch.models.presets import get_preset

    return tt.CausalLM(get_preset(preset, dtype=getattr(torch, dtype), **over))


def _engine(config, params_npz, preset="tiny", remat="selective", attn_impl="flash",
            over=None):
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.models import transformer as tt

    model = _model(preset, remat=remat, attn_impl=attn_impl, **(over or {}))
    params = tt.params_from_numpy(load_tree(params_npz), model.cfg, device="cpu")
    engine, *_ = tds.initialize(model=model, params=params, config=config, device="cpu")
    return engine


def _batches(npz):
    with np.load(npz) as z:
        n = len({k.split("/")[0] for k in z.files})
        return [{k.split("/")[1]: torch.from_numpy(z[k]) for k in z.files
                 if k.split("/")[0] == str(i)} for i in range(n)]


def case_train(rank, world, out_dir, config, params, batches, preset="tiny",
               remat="selective", save_params=True, ckpt=None, ckpt_after=None, over=None,
               load=None, moments_at=()):
    """Train on every batch; losses, norms, the comms logger's counts beside
    the plan's prediction, resident parameter bytes, the final masters
    (whole leaves) and, with ``ckpt``, a checkpoint after ``ckpt_after``
    steps.  ``over`` overrides fields of the preset; ``load`` is a
    checkpoint to resume from first (then the batches after its step);
    ``moments_at`` the steps after which Adam's moments are kept (whole
    leaves, ``{step: {"mu": ..., "nu": ...}}``)."""
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.runtime.zero import predicted_comm_counts

    engine = _engine(config, params, preset=preset, remat=remat, over=over)
    steps = _batches(batches)
    if load is not None:  # resumed: the batches after the checkpoint's step
        engine.load_checkpoint(load)
        steps = steps[engine.global_steps:]
    logger = comm.get_comms_logger(engine.grid)
    if logger is not None:
        logger.reset()
    predicted = predicted_comm_counts(engine, len(steps))
    losses, norms, moments = [], [], {}
    for i, b in enumerate(steps):
        losses.append(float(engine.train_batch(b)))
        norms.append(engine.get_global_grad_norm())
        if i + 1 in moments_at:  # a collective: every rank gathers
            state = engine.logical_opt_state()
            moments[i + 1] = {m: {k: v.detach().numpy().copy()
                                  for k, v in _flat(state[m]).items()} for m in ("mu", "nu")}
        if ckpt is not None and i + 1 == ckpt_after:
            engine.save_checkpoint(ckpt)
            if logger is not None:  # the save's gathers are not the steps'
                predicted = {k: predicted.get(k, 0) + v for k, v in logger.counts().items()}
    out = {"losses": losses, "norms": norms, "counts": logger.counts() if logger else {},
           "predicted": predicted, "skipped": engine.skipped_steps,
           "loss_scale": engine.loss_scale, "dp": engine.dp_world_size,
           "steps": engine.global_steps}
    if moments and rank == 0:
        out["moments"] = moments
    zs = engine._zero
    if zs is not None:
        out["resident"] = zs.resident_param_bytes()
        out["live_gathered"] = len(zs._gathered_layers)
        out["plan"] = {k: tuple(v) for k, v in _flat(zs.plan.param_specs).items()}
        out["master_plan"] = {k: tuple(v) for k, v in _flat(zs.plan.master_specs).items()}
    if engine._onebit is not None:
        out["errors"] = {k: engine._onebit.state[k].numpy().copy()
                         for k in ("worker_error", "server_error")}
        # the momentum's norm in float64: what the last step's norm reports
        out["m_norm"] = float(torch.linalg.vector_norm(engine._onebit.state["m"].double()))
    tree = engine.master_tree()
    if save_params and rank == 0:
        out["params"] = {k: v.detach().numpy().copy() for k, v in _flat(tree).items()}
    return out


def case_fn(rank, world, out_dir, fn, **kw):
    """A function of this module over the world: ``fn_<fn>(rank, world,
    **kw)``."""
    return globals()["fn_" + fn](rank, world, **kw)


def fn_overflow(rank, world, stage):
    """fp16 on a loss whose gradient only rank 1 makes infinite: every rank
    skips the step, keeps its parameters and halves the scale alike."""
    import deepspeed_tpu_torch as tds

    w0 = torch.linspace(-1.0, 1.0, 8)

    def loss_fn(p, batch, rng):
        return (p["w"].float() * batch["x"]).sum()

    config = {"train_micro_batch_size_per_gpu": 1, "fp16": {"enabled": True, "hysteresis": 1},
              "bf16": {"enabled": False}, "steps_per_print": 1000,
              "zero_optimization": {"stage": stage, "param_persistence_threshold": 0},
              "optimizer": {"type": "adamw", "params": {"lr": 0.1}}}
    engine, *_ = tds.initialize(loss_fn=loss_fn, params={"w": w0.clone()}, config=config,
                                device="cpu")
    x = torch.ones(1, 8)
    if rank == 1:
        x[0, 0] = float("inf")
    scale0 = engine.loss_scale
    engine.train_batch({"x": x[None]})
    engine.get_last_loss()  # settles the step's metrics (its skip count)
    bad = (engine.skipped_steps, engine.loss_scale / scale0,
           torch.equal(engine.master_tree()["w"], w0))
    engine.train_batch({"x": torch.ones(1, 1, 8)})
    engine.get_last_loss()
    return {"first": bad, "then_skipped": engine.skipped_steps,
            "then_moved": not torch.equal(engine.master_tree()["w"], w0)}


def _grid(axes):
    from deepspeed_tpu_torch.parallel.sharding import set_current_mesh
    from deepspeed_tpu_torch.parallel.topology import initialize_mesh

    grid = initialize_mesh(device="cpu", **axes)
    set_current_mesh(grid)
    return grid


def fn_primitives(rank, world):
    """Every collective of ``comm/comm.py`` on ``x = arange(8) + 100 *
    rank``, and the comms logger's record of them."""
    from deepspeed_tpu_torch.comm import comm

    _grid({"data": world})
    comm.configure(type("C", (), {"enabled": True})())
    x = torch.arange(8, dtype=torch.float32) + 100 * rank
    out = {
        "sum": comm.all_reduce(x.clone(), "data"),
        "mean": comm.all_reduce(x.clone(), "data", op="mean"),
        "max": comm.all_reduce(x.clone(), "data", op="max"),
        "min": comm.all_reduce(x.clone(), "data", op="min"),
        "rs": comm.reduce_scatter(x.clone(), "data"),
        "rs1": comm.reduce_scatter(x.reshape(2, 4).clone(), "data", scatter_dimension=1),
        "ag": comm.all_gather(x[:3], "data"),
        "ag_stack": comm.all_gather(x[:3], "data", tiled=False),
        "ag1": comm.all_gather(x.reshape(2, 4), "data", axis=1),
        "a2a": comm.all_to_all(x.clone(), "data"),
        "a2a_t": comm.all_to_all(x.reshape(2, 4).clone(), "data", split_axis=0, concat_axis=1),
        "bcast": comm.broadcast(x.clone(), "data", src=1),
        "next": comm.send_recv_next(x[:2], "data"),
        "prev": comm.send_recv_prev(x[:2], "data"),
        "axis_rank": comm.axis_rank("data"),
        "ranks": (comm.get_rank(), comm.get_world_size(), comm.get_local_rank()),
    }
    comm.barrier("data")
    out["logged"] = {k: (r.count, r.bytes) for k, r in comm.get_comms_logger().ops.items()}
    comm.configure(None)
    return {k: (v.numpy().copy() if torch.is_tensor(v) else v) for k, v in out.items()}


def fn_qcomm(rank, world, inputs):
    """The quantized collectives of ``comm/qcomm.py`` on this rank's rows
    of ``inputs`` (an ``.npz``), as ``test_torch_comm.py``'s JAX side runs
    them under ``shard_map``."""
    from deepspeed_tpu_torch.comm import compressed, qcomm
    from deepspeed_tpu_torch.ops.sparse_grads import embedding_lookup

    _grid({"data": world})
    with np.load(inputs) as z:
        x = {k: torch.from_numpy(z[k][rank]) for k in z.files}
    out = {}
    for fmt in ("int8", "fp8", "none"):
        out[f"ag_{fmt}"] = qcomm.q_all_gather(x["a"], "data", fmt, tiled=True)
        out[f"rs_{fmt}"], out[f"rs_err_{fmt}"] = qcomm.q_reduce_scatter(
            x["b"], "data", fmt, mean=True, error=x["e"])
        out[f"ar_{fmt}"] = qcomm.q_all_reduce(x["b"], "data", fmt)
        out[f"a2a_{fmt}"] = qcomm.q_all_to_all(x["b"], "data", fmt)
    out["psum_tiled"] = qcomm.q_psum_tiled(x["b"].reshape(4, -1), "data", "int8", tiles=3)
    out["ring"] = qcomm.ring_permute(x["a"], "data")
    # the straight-through backward of the quantized all-to-all
    xb = x["b"].clone().requires_grad_(True)
    (qcomm.q_all_to_all(xb, "data", "int8") * x["a2a_w"]).sum().backward()
    out["a2a_grad"] = xb.grad
    # the exact wire's gradient: the reverse all-to-all
    xb = x["b"].clone().requires_grad_(True)
    (qcomm.q_all_to_all(xb, "data", "none") * x["a2a_w"]).sum().backward()
    out["a2a_grad_none"] = xb.grad
    mean, werr, serr = compressed.compressed_allreduce(
        x["m"], x["we"], x["se"], "data")
    out.update(c_mean=mean, c_werr=werr, c_serr=serr)
    table = x["table"].clone().requires_grad_(True)
    (embedding_lookup(table, x["ids"], axis_name="data") * x["g"]).sum().backward()
    out["sparse_grad"] = table.grad
    return {k: v.detach().float().numpy().copy() for k, v in out.items()}


def fn_refusals(rank, world):
    """What does not train across ranks yet: each ``initialize`` raises
    ``NotImplementedError`` naming item 7 on every rank."""
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.linear.lora import LoRACausalLM

    model = _model("tiny")
    base = {"train_micro_batch_size_per_gpu": 1, "bf16": {"enabled": False}}
    cases = {
        "offload": dict(base, zero_optimization={"stage": 2, "offload_optimizer": "cpu"}),
        "compression": dict(base, compression_training={"weight_quantization": {
            "shared_parameters": {"enabled": True},
            "different_groups": {"g": {"params": {"start_bits": 8, "target_bits": 8},
                                       "modules": ["attn"]}}}}),
        "pld": dict(base, progressive_layer_drop={"enabled": True}),
        "eigenvalue": dict(base, eigenvalue={"enabled": True}),
        "compile": dict(base, compile={"backend": "aot_eager"}),
        "lamb": dict(base, zero_optimization={"stage": 1}, optimizer={"type": "lamb"}),
        "hybrid": dict(base, hybrid_engine={"enabled": True}),
    }
    out = {}
    for name, cfg in cases.items():
        try:
            tds.initialize(model=model, config=cfg, device="cpu")
            out[name] = "trained"
        except NotImplementedError as e:
            out[name] = str(e)
    try:
        lora = LoRACausalLM(model)
        tds.initialize(model=lora, config=base, device="cpu")
        out["lora"] = "trained"
    except NotImplementedError as e:
        out["lora"] = str(e)
    return out


def fn_loader(rank, world):
    """``initialize(training_data=...)`` in a world: the loader draws this
    rank's rows of each global batch (``[gas, micro]``)."""
    import deepspeed_tpu_torch as tds

    rows = [{"input_ids": np.full(9, i, np.int64)} for i in range(32)]
    engine, _, loader, _ = tds.initialize(
        model=_model("tiny"), training_data=rows, device="cpu",
        config={"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
                "bf16": {"enabled": False}, "seed": 5})
    batch = next(iter(loader))
    loss = float(engine.train_batch(batch))
    return {"ids": batch["input_ids"][..., 0].numpy().copy(), "len": len(loader),
            "loss": loss, "state": loader.state_dict()}


def fn_deferred(rank, world, stage):
    """``initialize(model=...)`` without ``params`` in a world at
    ``stage``: each rank draws the leaves one at a time and keeps its
    slices of each, which equal the slices of the tree drawn whole; the
    parameters ``zero.Init.materialize`` returns build the same engine."""
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.runtime import zero

    model = _model("tiny")
    conf = {"train_micro_batch_size_per_gpu": 1, "bf16": {"enabled": False}, "seed": 4,
            "steps_per_print": 1000,
            "zero_optimization": {"stage": stage, "param_persistence_threshold": 0}}
    largest = []  # the leaves a rank held whole as they were drawn
    init_params = model.init_params

    def watched(seed=0, device=None, keep=None):
        def kept(path, w):
            largest.append(w.numel())
            return keep(path, w)

        return init_params(seed=seed, device=device, keep=kept if keep else None)

    model.init_params = watched
    deferred, *_ = tds.initialize(model=model, config=conf, device="cpu")
    model.init_params = init_params
    whole, *_ = tds.initialize(model=model, params=init_params(seed=4, device="cpu"),
                               config=conf, device="cpu")
    with zero.Init(conf, deferred.grid) as zi:
        params = zi.materialize(model.init_params, seed=4)
    built, *_ = tds.initialize(model=model, params=params, config=conf, device="cpu")
    zs = deferred._zero
    return {"deferred": isinstance(params, zero.DeferredParams),
            "shapes_meta": all(v.is_meta for v in _flat(params.shapes).values()),
            "equal_whole": torch.equal(zs.masters, whole._zero.masters),
            "equal_init": torch.equal(built._zero.masters, whole._zero.masters),
            "compute_equal": all(torch.equal(zs.compute[k], whole._zero.compute[k])
                                 for k in zs.compute),
            "largest_leaf": max(largest), "drawn": sum(largest),
            "total": sum(g.numel for g in zs.groups), "slice": zs.masters.numel()}



def case_tp_train(rank, world, out_dir, config, params, batches, preset="tiny",
                  remat="selective", ckpt=None, ckpt_after=None):
    """``case_train`` with a ``model`` axis: also each step's replicated and
    narrowed leaves of this rank's shard (they must stay equal on every
    rank of a tensor-parallel group), the comms logger's counts, and the
    whole masters on every rank."""
    from deepspeed_tpu_torch.comm import comm

    engine = _engine(config, params, preset=preset, remat=remat)
    tp = engine.tp
    whole = engine._tp_shapes
    kept = [p for p, pl in tp.placements(whole).items() if pl.kind != "shard"]
    logger = comm.get_comms_logger(engine.grid)
    losses, norms, replicated = [], [], []
    for i, b in enumerate(_batches(batches)):
        losses.append(float(engine.train_batch(b)))
        norms.append(engine.get_global_grad_norm())
        local = _local_masters(engine)
        replicated.append({"/".join(p): local["/".join(p)] for p in kept})
        if ckpt is not None and i + 1 == ckpt_after:
            engine.save_checkpoint(ckpt)
    out = {"losses": losses, "norms": norms, "replicated": replicated,
           "counts": logger.counts() if logger is not None else {},
           "tp": (tp.size, tp.rank, tp.kv_sharded, tp.vocab_sharded),
           "dp": engine.dp_world_size}
    out["params"] = {k: v.detach().numpy().copy() for k, v in _flat(engine.master_tree()).items()}
    return out


def _local_masters(engine):
    """This rank's fp32 masters as ``{path: array}`` of its TP shard (ZeRO's
    slices gathered over the shard group)."""
    zs = engine._zero
    tree = engine.params if zs is None else zs.unflatten(zs.gather_flat(zs.masters),
                                                         zs.plan.shape_tree)
    return {k: v.detach().numpy().copy() for k, v in _flat(tree).items()}


def fn_tp_resume(rank, world, params, batches, ckpt, config):
    """A one-device checkpoint loaded at ``model`` 2 (each rank cuts its
    shard of the logical tensors) and trained on the last 2 batches."""
    engine = _engine(config, params)
    engine.load_checkpoint(ckpt)
    steps = engine.global_steps
    losses = [float(engine.train_batch(b)) for b in _batches(batches)[2:]]
    return {"steps": steps, "losses": losses}


def fn_tp_refusals(rank, world):
    """What stays refused under a model axis: a sparse layout, the 1-bit
    optimizers, Lamb, a raw loss function (MoE layers, refused here once,
    now train: ``moe`` reads ``trained``)."""
    import deepspeed_tpu_torch as tds

    base = {"train_micro_batch_size_per_gpu": 1, "bf16": {"enabled": False},
            "mesh": {"model": 2}}
    cases = {
        "moe": (_model("tiny_moe"), base),
        "sparse": (_model("tiny"), dict(base, sparse_attention={"mode": "fixed", "block": 16})),
        "onebit": (_model("tiny"), dict(base, optimizer={"type": "onebitadam"})),
        "lamb": (_model("tiny"), dict(base, optimizer={"type": "lamb"})),
    }
    out = {}
    for name, (model, cfg) in cases.items():
        try:
            tds.initialize(model=model, config=cfg, device="cpu")
            out[name] = "trained"
        except NotImplementedError as e:
            out[name] = str(e)
    model = _model("tiny")
    try:
        tds.initialize(model=model, loss_fn=lambda p, b, r: 0.0, config=base, device="cpu")
        out["loss_fn"] = "trained"
    except Exception as e:  # a ConfigError
        out["loss_fn"] = str(e)
    return out


def case_tp_serve(rank, world, out_dir, params, preset, engine_kw, prompts,
                  temperature=0.0, scheduler=False, v1=False, tp=None):
    """A tensor-parallel serving engine over ``model`` = ``tp`` (default the
    world): the v2 engine's ``put`` / ``step`` ticks (or its scheduler, with
    whatever prefix caching and chunking ``engine_kw`` turn on), or with
    ``v1`` ``init_inference``'s ``generate``; returns each uid's tokens and
    the engine's comms counts."""
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.inference.engine import init_inference
    from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.sampling import SamplingParams
    from deepspeed_tpu_torch.models import transformer as tt

    grid = _grid({"model": tp or world})
    comm.configure(type("C", (), {"enabled": True})(), mesh=grid)
    model = _model(preset)
    p = tt.params_from_numpy(load_tree(params), model.cfg, device="cpu")
    new = 6
    sampling = SamplingParams(temperature=temperature, top_k=20 if temperature else 0,
                              max_new_tokens=new)
    if v1:
        eng = init_inference(model, p, mesh=grid, device="cpu", seed=3)
        out = {"tokens": eng.generate(np.asarray(prompts), sampling).tolist()}
    else:
        eng = InferenceEngineV2(p, model.cfg, grid=grid, device="cpu", seed=3, **engine_kw)
        if scheduler:
            s = eng.scheduler
            for u, toks in enumerate(prompts, 1):
                s.submit(u, toks, sampling)
            res = s.run()
            out = {"tokens": {u: list(res[u]) for u in res}}
        else:
            first = eng.put(list(range(1, len(prompts) + 1)), prompts, sampling)
            ticks = [eng.step(sampling) for _ in range(new - 1)]
            out = {"tokens": {u: [first[u]] + [t[u] for t in ticks if u in t]
                              for u in first}}
        out["pool_heads"] = int(eng.kv[0][0].shape[2])
        out["blocks_in_use"] = eng.close()["blocks_in_use"]
    out["counts"] = comm.get_comms_logger(grid).counts()
    return out


def fn_tp_psum(rank, world, inputs, tiles):
    """``qcomm.q_psum_tiled`` over ``model`` on this rank's partial sums
    (``inputs[rank]``), for each format; and the int8 payload K6's plain
    version makes of them."""
    from deepspeed_tpu_torch.comm import qcomm

    _grid({"model": world})
    with np.load(inputs) as z:
        y = torch.from_numpy(z["y"][rank])
    out = {fmt: qcomm.q_psum_tiled(y, "model", fmt, tiles=tiles).numpy().copy()
           for fmt in ("none", "int8", "fp8")}
    q, s = qcomm.quantize_payload(y, "int8")
    out["payload"] = (q.numpy().copy(), s.numpy().copy())
    return out


def fn_tp_serve_refusals(rank, world):
    """What a tensor-parallel engine refuses, naming item 7."""
    from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models import transformer as tt

    grid = _grid({"model": world})
    out = {}
    cases = {
        "speculation": ("tiny", dict(enable_speculation=True)),
        "megastep": ("tiny", dict(serve={"decode_megastep": 4})),
        "deadline": ("tiny", dict(serve={"deadline_ms": 500.0})),
        "moe": ("tiny_moe", {}),
    }
    for name, (preset, kw) in cases.items():
        model = _model(preset)
        try:
            InferenceEngineV2(tt.init_params(model.cfg, device="cpu"), model.cfg, grid=grid,
                              device="cpu", num_blocks=8, block_size=8, **kw)
            out[name] = "served"
        except NotImplementedError as e:
            out[name] = str(e)
    model = _model("tiny")
    eng = InferenceEngineV2(tt.init_params(model.cfg, device="cpu"), model.cfg, grid=grid,
                            device="cpu", num_blocks=8, block_size=8)
    try:
        eng.step_n(2)
        out["step_n"] = "served"
    except NotImplementedError as e:
        out["step_n"] = str(e)
    eng.close()
    return out


# ---------------------------------------------------------------------------
# sequence and expert parallelism (tests/test_torch_sequence.py,
# tests/test_torch_expert.py)
# ---------------------------------------------------------------------------
def _context(mesh, cfg=None, ep=False):
    from deepspeed_tpu_torch.parallel.context import ParallelContext
    from deepspeed_tpu_torch.parallel.expert_parallel import ExpertParallel

    grid = _grid(mesh)
    return ParallelContext(grid, ep=ExpertParallel(grid, cfg) if ep else None)


def _grads_np(**named):
    return {k: v.detach().float().numpy().copy() for k, v in named.items()}


def fn_seq_attn(rank, world, inputs, mesh, body, sparse=None, cap=None, segments=False):
    """One attention body over the seq axis on this rank's positions of the
    global q / k / v in ``inputs`` (``body``: ``ulysses`` over the plain
    body, or with ``sparse`` over the block-sparse one, or ``ring``): its
    output slice and the gradients of ``sum(out * w)`` for its slices."""
    import functools

    from deepspeed_tpu_torch.ops.attention import dot_product_attention
    from deepspeed_tpu_torch.ops.sparse_attention import (FixedSparsityConfig,
                                                          block_sparse_attention)
    from deepspeed_tpu_torch.sequence.layer import DistributedAttention
    from deepspeed_tpu_torch.sequence.ring import ring_attention

    par = _context(mesh)
    with np.load(inputs) as z:
        x = {k: torch.from_numpy(z[k]) for k in z.files}
    s = x["q"].shape[1]
    n = s // par.seq
    sl = slice(par.seq_rank * n, (par.seq_rank + 1) * n)
    q, k, v = (x[t][:, sl].clone().requires_grad_(True) for t in ("q", "k", "v"))
    kw = {"causal": True}
    if cap is not None:
        kw["logits_soft_cap"] = cap
    if segments:
        kw["segment_ids"] = x["seg"]
    if body == "ring":
        out = ring_attention(q, k, v, par=par, **kw)
    else:
        base = dot_product_attention if sparse is None else functools.partial(
            block_sparse_attention, config=FixedSparsityConfig(**sparse))
        out = DistributedAttention(base, par)(q, k, v, **kw)
    (out.float() * x["w"][:, sl]).sum().backward()
    return _grads_np(out=out, dq=q.grad, dk=k.grad, dv=v.grad)


def fn_moe_layer(rank, world, inputs, mesh, layer, fmt="none", cf=8.0):
    """One routed layer across ranks on the global ``x`` of ``inputs``
    (this rank's rows along the batch axes): ``layer`` ``block`` (``moe_block_grid``:
    the global gate, this rank's experts with an expert axis) or ``ep``
    (``routed_ffn_ep`` in ``fmt``).  Returns the output rows, the aux loss,
    the gradients of ``sum(out * w) + aux`` (the input's rows, the router's,
    the rank's experts'), and with ``block`` the gate's decisions for this
    rank's tokens."""
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.moe import layer as L
    from deepspeed_tpu_torch.moe.sharded_moe import _gating

    with np.load(inputs) as z:
        x = {k: torch.from_numpy(z[k]) for k in z.files}
    e = x["w_gate"].shape[0]
    cfg = get_preset("tiny_moe", dtype=torch.float32, moe_num_experts=e,
                     moe_capacity_factor=cf, hidden_size=x["x"].shape[-1],
                     intermediate_size=x["w_gate"].shape[-1])
    par = _context(mesh, cfg, ep="expert" in mesh)
    b = x["x"].shape[0] // (par.axis_size(par.batch_axes) if par.batch_axes else 1)
    r = par.axis_rank(par.batch_axes) if par.batch_axes else 0
    rows = slice(r * b, (r + 1) * b)
    e0, el = (par.ep.e0, par.ep.local) if par.ep is not None else (0, e)
    lw = {"router": x["router"].clone().requires_grad_(True)}
    for name in ("w_gate", "w_up", "w_down"):
        lw[name] = x[name][e0:e0 + el].clone().requires_grad_(True)
    xr = x["x"][rows].clone().requires_grad_(True)
    if layer == "ep":
        out, aux = L.routed_ffn_ep(lw, xr, cfg, par, fmt=fmt)
    else:
        out, aux = L.moe_block(lw, xr, cfg, par)
    # the aux loss weighted by the rank's share of the batch: the ranks'
    # losses sum to JAX's ``sum(out * w) + aux``
    dp = par.axis_size(par.batch_axes) if par.batch_axes else 1
    ((out * x["w"][rows]).sum() + aux / dp).backward()
    res = _grads_np(out=out, aux=aux, dx=xr.grad, **{f"d_{k}": v.grad for k, v in lw.items()})
    if layer == "block":
        with torch.no_grad():
            logits = L.gather_tokens(par, L.router_logits(xr.reshape(-1, xr.shape[-1]),
                                                           lw["router"]).reshape(b, -1, e))
            gate = _gating(logits, cfg.moe_top_k, cf, 4, True, None)
            mine = L.own_tokens(par, b, xr.shape[1], xr.device)
            res.update(expert=gate.expert[mine].numpy(), position=gate.position[mine].numpy(),
                       keep=gate.keep[mine].numpy(), counts=gate.expert_counts.numpy(),
                       capacity=gate.capacity)
    return res


def fn_seq_refusals(rank, world):
    """What a seq / expert axis refuses: a length the axis does not divide,
    a block-sparse layout under ring (JAX's ConfigError), ALiBi (under
    ulysses, and under ``none`` over the axis), a raw loss
    function, the 1-bit optimizers, and the routed region beside seq."""
    import deepspeed_tpu_torch as tds

    base = {"train_micro_batch_size_per_gpu": 1, "bf16": {"enabled": False},
            "mesh": {"seq": world}}
    out = {}

    def attempt(name, fn):
        try:
            fn()
            out[name] = "ran"
        except Exception as e:  # the refusal's type and text
            out[name] = f"{type(e).__name__}: {e}"

    def length():
        engine, *_ = tds.initialize(model=_model("tiny", sequence_parallel="ulysses"),
                                    config=base, device="cpu")
        engine.train_batch({"input_ids": torch.zeros(1, 1, 16, dtype=torch.long)})

    attempt("length", length)
    attempt("sparse_ring", lambda: tds.initialize(
        model=_model("tiny", sequence_parallel="ring"),
        config=dict(base, sparse_attention={"mode": "fixed", "block": 16}), device="cpu"))

    def alibi():
        engine, *_ = tds.initialize(
            model=_model("tiny", position="alibi", sequence_parallel="ulysses"), config=base,
            device="cpu")
        engine.train_batch({"input_ids": torch.zeros(1, 1, 17, dtype=torch.long)})

    attempt("alibi", alibi)

    def alibi_none():
        engine, *_ = tds.initialize(
            model=_model("tiny", position="alibi", attn_impl="reference"), config=base,
            device="cpu")
        engine.train_batch({"input_ids": torch.zeros(1, 1, 17, dtype=torch.long)})

    attempt("alibi_none", alibi_none)
    model = _model("tiny", sequence_parallel="ulysses")
    attempt("loss_fn", lambda: tds.initialize(
        model=model, loss_fn=lambda p, b, r: model.loss_fn(p, b, r), config=base,
        device="cpu"))
    attempt("onebit", lambda: tds.initialize(
        model=_model("tiny", sequence_parallel="ring"),
        config=dict(base, optimizer={"type": "onebitadam"}), device="cpu"))
    if world == 4:
        attempt("ep_seq", lambda: tds.initialize(
            model=_model("tiny_moe", moe_qcomm="int8"),
            config=dict(base, mesh={"seq": 2, "expert": 2}), device="cpu"))
    return out


def fn_expert_refusals(rank, world):
    """What an expert or model axis refuses for MoE, naming item 7: MoE
    served over a model axis (v2 and v1 engines), Lamb over the expert
    axis's shards, and (at 4 ranks) the routed region beside a model
    axis."""
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.inference import init_inference
    from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models import transformer as tt

    out = {}

    def attempt(name, fn):
        try:
            fn()
            out[name] = "ran"
        except Exception as e:  # the refusal's type and text
            out[name] = f"{type(e).__name__}: {e}"

    base = {"train_micro_batch_size_per_gpu": 1, "bf16": {"enabled": False}}
    if world == 4:
        attempt("ep_model", lambda: tds.initialize(
            model=_model("tiny_moe", moe_qcomm="int8"),
            config=dict(base, mesh={"expert": 2, "model": 2}), device="cpu"))
        return out
    model = _model("tiny_moe")
    params = tt.init_params(model.cfg, device="cpu")
    grid = _grid({"model": world})
    attempt("serve_v2", lambda: InferenceEngineV2(params, model.cfg, grid=grid, device="cpu",
                                                  num_blocks=8, block_size=8))
    attempt("serve_v1", lambda: init_inference(model, params, mesh=grid, device="cpu"))
    attempt("lamb", lambda: tds.initialize(
        model=_model("tiny_moe"), config=dict(base, mesh={"expert": world},
                                              optimizer={"type": "lamb"}), device="cpu"))
    return out
