"""deepspeed_tpu_torch — the PyTorch / CUDA port of ``deepspeed_tpu``.

A second package beside the JAX one, mirroring its module layout
(``models``, ``moe``, ``ops``, ``inference``, ``runtime``, ``config``,
``sequence``, ``parallel``, ``serving``, ``telemetry``, ``comm``,
``autotuning``, ``checkpoint``, ``data``, ``analysis``, ``nvme``, ``utils``,
``accelerator``, ``monitor``, ``profiling``) so each module's
counterpart is found by name.  It imports ``torch`` and
never ``jax`` or ``deepspeed_tpu``.  Entry points run on a CUDA device
unless the caller passes ``device="cpu"``; every Pallas kernel of the ported
paths is a hand-written CUDA kernel under ``csrc/`` (see ``ops/kernels``).

Ported so far:

- the dense v1 engine ``inference.init_inference`` (every family, ALiBi
  and the parallel block included);
- Mixtral-style MoE on one card (``moe``: top-k gating with capacity,
  the routed layer, dropless serving; the ``mixtral_8x7b`` preset trains,
  serves and imports from Hugging Face);
- serving: ``inference.engine_v2.InferenceEngineV2`` (paged KV cache, packed
  prefill, prefix caching, chunked prefill, batched decode, decode bursts,
  speculation, quantized weights, a KV pool seq-sharded over a
  ``parallel.topology`` grid) and its ``inference.scheduler.ServeScheduler``
  with JAX's fault-tolerance layer (``inference.faults``);
- the serve front end: ``serving.build_router`` (workers in this process)
  and ``serving.build_remote_router`` (subprocess workers behind the DSTP
  socket transport, ``serving.transport``), with prefix affinity,
  prefill/decode disaggregation through the paged-KV handoff, worker-death
  replay, ``telemetry`` (registry, traces, the fleet plane);
- autotuning: the online controller (``autotuning.attach_controller``) and
  the roofline-seeded offline search (``autotune_serving`` /
  ``autotune_model``);
- training: ``initialize`` -> ``runtime.engine.DeepSpeedTorchEngine``
  (``train_batch``, ``train_on_loader``, and the reference's ``forward`` /
  ``backward`` / ``step``, ``eval_batch``, ``no_sync``) over
  ``models.transformer.CausalLM`` on one GPU, with its data loader
  (``runtime.dataloader``, a resumable position) and checkpoints
  (``checkpoint``: crash-safe save / load, sync or async, the fp32 export
  and Hugging Face safetensors import / export), and ZeRO-Offload
  (``runtime.offload``: the CPU tier streams fp32 masters and moments from
  pinned host memory through the card; the NVMe tier keeps them in swap
  files under the host AdamW, ``ops.host_adam``, and the async I/O engine,
  ``nvme``, built from ``csrc/host`` by ``ops.op_builder``);
- the instrumented, scheduled training step: timers with
  ``wall_clock_breakdown`` / ``memory_breakdown`` (``utils.timer``,
  ``utils.memory``), the flops profiler (``profiling``), the monitors
  (``monitor``: TensorBoard, CSV, WandB, Comet), curriculum learning
  (``data``: the scheduler, the indexed dataset, the data analyzer and its
  difficulty-filtered sampling), progressive layer drop
  (``runtime.progressive_layer_drop``) and ``accelerator.get_accelerator``;
- the static analysis (``analysis``: the AST lints, the race lint and the
  scheduler scenario explorer) over this package;
- compression-aware and parameter-efficient training: ``compression``
  (QAT, activation quantization, pruning, layer reduction with
  distillation), the eigenvalue estimator (``runtime.eigenvalue``), LoRA
  (``linear``), the hybrid engine's generate on the live weights
  (``runtime.hybrid_engine``) and random-LTD (``data.random_ltd``);
- data parallelism across processes: ``comm`` over ``torch.distributed``
  (NCCL on CUDA, gloo on the CPU), the ``data`` x ``fsdp`` x ``sub``
  process grid (``parallel``), ZeRO stages 0-3 (``runtime.zero``), ZeRO++
  (``runtime.zeropp``), the 1-bit optimizers (``runtime.onebit``) and the
  launcher's process per device;
- tensor parallelism across processes: the ``model`` axis of the grid,
  AutoTP's rules (``parallel.auto_tp``), a rank's shard of the tree
  (``parallel.tensor_parallel``), manual Megatron TP in the model (the
  ``f`` / ``g`` pair, the vocab-parallel embedding and loss,
  ``domino_chunks``) composed with ZeRO, and serving over the axis in the
  v2 engine and ``init_inference`` (row-parallel partial sums reduced
  exactly or through the quantized transport).
"""
from __future__ import annotations

import os
from typing import Any, Callable, Optional

__version__ = "0.1.0"  # the JAX package's


def _adopt_elastic_batch(cfg, dp_world_size: int) -> None:
    """The elastic batch size and micro-batch into ``cfg``, as JAX's
    ``initialize`` (``deepspeed_tpu/__init__.py:236-280``, the reference's
    engine.py:594-604): the elastic values always win; batch keys the user
    also set are an ``ElasticityConfigError`` unless
    ``ignore_non_elastic_batch_info``.  The world size handed to
    ``compute_elastic_config`` is ``dp_world_size * model_parallel_size``
    (v0.2 divides by the model-parallel size itself)."""
    from .elasticity import ElasticityConfigError, compute_elastic_config
    from .utils.logging import log_dist

    mp = int(cfg.elasticity.get("model_parallel_size", 1))
    final_batch, valid_gpus, micro = compute_elastic_config(
        {"elasticity": cfg.elasticity}, world_size=dp_world_size * mp, return_microbatch=True)
    user_batch_info = any(v is not None for v in (
        cfg.train_batch_size, cfg.train_micro_batch_size_per_gpu,
        cfg.gradient_accumulation_steps))
    if user_batch_info and not cfg.elasticity.get("ignore_non_elastic_batch_info", False):
        raise ElasticityConfigError(
            "elasticity is enabled but batch sizes are also set in the config; remove "
            "train_batch_size/train_micro_batch_size_per_gpu/gradient_accumulation_steps "
            "or set elasticity.ignore_non_elastic_batch_info")
    if micro is None:
        raise ElasticityConfigError(
            f"no micro batch in {cfg.elasticity.get('micro_batch_sizes')} divides elastic "
            f"batch {final_batch} at world size {dp_world_size}")
    cfg.train_batch_size = final_batch
    cfg.train_micro_batch_size_per_gpu = micro
    cfg.gradient_accumulation_steps = final_batch // (micro * dp_world_size)
    log_dist(f"elasticity: train_batch_size={final_batch} micro={micro} "
             f"valid world sizes={valid_gpus}")


def _mesh_axes_from_config(cfg, world: int, zero_stage: int):
    """The grid's axis sizes (JAX ``_mesh_axes_from_config``,
    ``__init__.py:20-62``): explicit sizes win (``model``, ``seq`` and
    ``expert`` among them); the
    leftover ranks go to ``fsdp`` under ZeRO >= 1, else to ``data``;
    ``zero_hpz_partition_size`` / ``mics_shard_size`` factor the fsdp
    extent into ``(fsdp, sub)``."""
    import math

    from .config.config import ConfigError

    m = cfg.mesh
    fixed = {}
    for ax in ("model", "seq", "expert"):
        v = getattr(m, ax)
        if v and v > 1:
            fixed[ax] = v
    if m.data:
        fixed["data"] = m.data
    if m.fsdp:
        fixed["fsdp"] = m.fsdp
    used = math.prod(fixed.values()) if fixed else 1
    if "data" not in fixed and "fsdp" not in fixed:
        if zero_stage >= 1:
            fixed["fsdp"], fixed["data"] = world // used, 1
        else:
            fixed["data"] = world // used
    elif "data" not in fixed:
        fixed["data"] = world // used
    elif "fsdp" not in fixed:
        fixed["fsdp"] = world // used
    zo = cfg.zero_optimization
    group = max(zo.zero_hpz_partition_size, zo.mics_shard_size)
    if group > 1:
        total = fixed.get("fsdp", 1)
        if total % group:
            raise ConfigError(f"hpZ/MiCS group size {group} does not divide the fsdp "
                              f"extent {total}")
        fixed["fsdp"] = total // group
        fixed["sub"] = group
    return fixed


def _in_world(mesh) -> bool:
    """A process of a torch.distributed world: a grid was given, the group
    is up, or the launcher's env names the rank."""
    from .comm import comm

    return (mesh is not None or comm.is_initialized()
            or ("WORLD_SIZE" in os.environ and "RANK" in os.environ))


def initialize(model=None, params: Any = None, config: Any = None, device=None,
               loss_fn: Optional[Callable] = None, mesh=None, training_data=None,
               eval_fn: Optional[Callable] = None, collate_fn: Optional[Callable] = None):
    """Build the training engine — ``deepspeed_tpu.initialize`` on one GPU.

    ``model`` is a ``models.transformer.CausalLM`` (or pass ``loss_fn`` and
    ``params``), or the path of a Hugging Face checkpoint directory: its
    ``config.json`` gives the model (``checkpoint.config_from_hf``) and its
    safetensors are streamed onto the device one tensor at a time
    (``checkpoint.load_hf_checkpoint``).  ``params=None`` otherwise
    initialises fp32 parameters from ``config['seed']`` on the device (in a
    world at ZeRO stage >= 1, each rank draws the leaves one at a time and
    keeps its slices of each: ``runtime.zero.DeferredParams``).
    ``device`` is CUDA unless the caller names another.  Returns
    ``(engine, engine, dataloader, lr_scheduler)`` like the reference.
    ``training_data`` (an indexable dataset) becomes a
    ``runtime.dataloader.DeepSpeedTpuDataLoader`` (``collate_fn``, the
    config's micro-batch, GAS and seed; dp world size 1), returned and
    attached as ``engine.training_dataloader`` so that its position rides
    the checkpoints.  ``eval_fn`` (the ``loss_fn`` contract) is what
    ``engine.eval_batch`` runs, ``loss_fn`` by default.
    ``config['sparse_attention']`` sets the block-sparse layout on
    ``model.cfg`` (JAX ``initialize``); it needs ``model=``.
    ``engine.monitor`` is a ``monitor.MonitorMaster`` over the config's
    four monitor sections.  With curriculum learning on and a
    ``data_efficiency.curriculum_learning.data_analysis_path`` (a
    ``data.DataAnalyzer`` output directory), the loader's sampler admits
    only the samples whose analyzed metric (``difficulty_metric``, else the
    ``curriculum_type``) is within the scheduler's current difficulty
    (``data.curriculum_index_filter``).
    ``compression_training.activation_quantization`` (enabled) sets
    ``model.cfg.act_quant_bits`` to its first group's ``bits``; a model
    with ``trainable_mask`` (``linear.LoRACausalLM``) trains only the
    leaves it marks; with ``hybrid_engine.enabled`` the engine returned is a
    ``runtime.hybrid_engine.DeepSpeedHybridEngine`` around it (JAX
    ``__init__.py:120-133``, ``:284-294``, ``:337-350``).  An enabled
    ``elasticity`` section sets the batch size, micro-batch and GAS
    (``_adopt_elastic_batch``); the ``compile`` section compiles the
    engine's model loss (``runtime.engine.DeepSpeedTorchEngine._jit``).

    A process of a world (``WORLD_SIZE`` and ``RANK`` in its environment,
    as the launcher, the elastic agent and the multinode runners set them,
    or ``mesh=``, or a ``torch.distributed`` group already up) joins it
    (``comm.init_distributed``: NCCL on ``cuda:LOCAL_RANK``, gloo with
    ``device="cpu"``), builds the process grid (``mesh``, else the
    config's ``mesh`` section with JAX's factoring: the ranks to ``fsdp``
    under ZeRO >= 1, else to ``data``, hpZ / MiCS splitting ``(fsdp,
    sub)``; ``_mesh_axes_from_config``) and trains one model across it:
    the batch triple and the elastic batch take the grid's data-parallel
    size, the loader gives each rank its slice, and the engine shards by
    the ZeRO stage (``runtime/zero.py``).  Each rank's ``train_batch``
    takes its own micro-batches (or the global batch, of which it takes its
    rows).  The ``comms_logger`` section counts the collectives
    (``comm.comm.get_comms_logger``).  The hybrid engine and the features
    the engine lists are refused across ranks (ROADMAP queue 1 item 7).

    A ``model`` axis (a ``mesh`` section that names ``model``, at any
    size, 1 included, or a grid with ``model`` > 1) trains
    tensor-parallel: ``model`` must be a ``CausalLM``, whose ``tp``
    becomes this rank's ``parallel.tensor_parallel.TensorParallel``; the
    engine keeps the rank's shard of the tree (cut from ``params``, or
    from the tree drawn whole on the host) and ZeRO slices that.  The
    data-parallel size is ``data`` x ``fsdp`` x ``sub``: every rank of a
    tensor-parallel group reads the same rows.  ``tensor_parallel.
    domino_chunks`` sets the model's ``domino_chunks``, as in JAX."""
    from .config.config import ConfigError, parse_config
    from .monitor.monitor import MonitorMaster
    from .ops.kernels import resolve_device
    from .runtime.dataloader import DeepSpeedTpuDataLoader
    from .runtime.engine import DeepSpeedTorchEngine

    from .comm import comm

    cfg = parse_config(config)
    grid = None
    dp_world_size = 1
    if mesh is not None:
        from .parallel.topology import ProcessGrid

        if not isinstance(mesh, ProcessGrid):
            raise NotImplementedError(
                f"mesh={type(mesh).__name__}: training takes a process grid "
                "(parallel.topology.initialize_mesh() in a torch.distributed world); other "
                "meshes are not ported (ROADMAP queue 1 item 7)")
    if _in_world(mesh):
        from .parallel.sharding import set_current_mesh
        from .parallel.topology import initialize_mesh

        comm.init_distributed(device=device)
        device = resolve_device(device)
        if mesh is None:
            axes = _mesh_axes_from_config(cfg, comm.get_world_size(),
                                          cfg.zero_optimization.stage)
            mesh = initialize_mesh(device=device, **axes)
        grid = mesh
        set_current_mesh(grid)
        comm.configure(cfg.comms_logger, mesh=grid)
        dp_world_size = grid.dp_world_size
        if cfg.hybrid_engine.enabled:
            raise NotImplementedError("hybrid_engine across ranks is not ported yet "
                                      "(ROADMAP queue 1 item 7)")
    if cfg.elasticity.get("enabled"):
        _adopt_elastic_batch(cfg, dp_world_size)
    cfg.finalize(dp_world_size)
    device = resolve_device(device)
    if isinstance(model, str):
        import json

        from .checkpoint.hf_import import config_from_hf, load_hf_checkpoint
        from .models.transformer import CausalLM

        with open(os.path.join(model, "config.json")) as fh:
            model_cfg = config_from_hf(json.load(fh))
        hf_dir, model = model, CausalLM(model_cfg)
        if params is None:
            params, model.cfg = load_hf_checkpoint(hf_dir, model_cfg, device=device)
    if cfg.sparse_attention.mode:
        # a layout changes the model's forward: it needs the model, never a
        # raw loss_fn it could not reach (JAX ``initialize``)
        if model is None or not hasattr(model, "cfg"):
            raise ConfigError("sparse_attention requires model= (a models.CausalLM); it "
                              "cannot be injected into a raw loss_fn")
        if getattr(model.cfg, "sequence_parallel", "none") == "ring":
            raise ConfigError("sparse_attention composes with ulysses but not ring "
                              "(ring attention supplies its own attention body)")
        model.cfg = model.cfg.replace(sparse_attention=cfg.sparse_attention.build())
    aq = cfg.compression_training.activation_quantization or {}
    if (aq.get("shared_parameters", {}).get("enabled") and model is not None
            and hasattr(getattr(model, "cfg", None), "act_quant_bits")):
        # activation fake-quant lives in the model's forward (the engine's
        # manager transforms weights only)
        from .compression.compress import Technique, act_quant_bits

        if hasattr(model, "inner"):
            raise ConfigError("activation_quantization needs the model whose forward it "
                              "quantizes: a wrapped model (LoRACausalLM) runs its inner "
                              "model's forward, which would not read the bits")
        model.cfg = model.cfg.replace(act_quant_bits=act_quant_bits(Technique.parse(aq)))
    if cfg.tensor_parallel.domino_chunks > 1:
        if model is None or not hasattr(model, "cfg"):
            raise ConfigError("tensor_parallel.domino_chunks requires model= (a "
                              "models.CausalLM); it cannot chunk a raw loss_fn")
        if getattr(model.cfg, "moe_num_experts", 0) > 0:
            raise ConfigError("domino_chunks does not compose with MoE: capacity-based "
                              "routing per chunk would change token dropping vs the "
                              "full-batch build (not an overlap-only transformation)")
        model.cfg = model.cfg.replace(domino_chunks=cfg.tensor_parallel.domino_chunks)
    tp = None
    if hasattr(model, "tp"):
        model.tp = None
    if grid is not None and (grid.spec.model > 1 or cfg.mesh.model_given):
        # a model axis: the model's loss runs this rank's shard of the tree
        # between the Megatron collectives (models/transformer.py)
        from .parallel.tensor_parallel import TensorParallel

        if model is None or not hasattr(model, "tp") or (
                loss_fn is not None and loss_fn != model.loss_fn):
            raise ConfigError("a model axis needs model= (a models.CausalLM) whose loss the "
                              "engine runs: a raw loss_fn has no layers to split")
        tp = model.tp = TensorParallel(grid, model.cfg)
    ep = None
    if hasattr(model, "par"):
        model.par = None
    if grid is not None and hasattr(model, "par") and hasattr(model, "cfg"):
        # the model's view of the seq / expert / token axes: its loss reads
        # this rank's slice of the sequence, its routed experts run across
        # ranks (an expert axis named, at any size, 1 included, cuts them)
        from .parallel.context import ParallelContext

        if getattr(model.cfg, "moe_num_experts", 0) > 0 and (
                grid.spec.expert > 1 or cfg.mesh.expert_given):
            from .parallel.expert_parallel import ExpertParallel

            ep = ExpertParallel(grid, model.cfg)
        model.par = ParallelContext(grid, tp=tp, ep=ep)
    if loss_fn is None:
        if model is None:
            raise ValueError("initialize() needs model= or (loss_fn, params)")
        loss_fn = model.loss_fn
    from .runtime.zero import DeferredParams

    # each rank keeps its slices of each leaf as it is drawn (under a model
    # axis the tree is drawn whole on the host and cut to the rank's shard)
    sliced = grid is not None and cfg.zero_optimization.stage >= 1 and tp is None and ep is None
    if params is None:
        if model is None:
            raise ValueError("initialize() needs params with a bare loss_fn")
        if sliced and DeferredParams.supports(model.init_params):
            # each rank draws the leaves one at a time and keeps its slices
            params = DeferredParams(model.init_params, cfg.seed)
        else:  # in a world every rank draws the same tree on the host
            params = model.init_params(seed=cfg.seed,
                                       device="cpu" if grid is not None else device)
    if isinstance(params, DeferredParams) and not sliced:  # an engine of whole leaves
        params = params.draw("cpu" if grid is not None else device)
    trainable_mask = None
    if model is not None and hasattr(model, "trainable_mask"):
        trainable_mask = model.trainable_mask(params)
    engine = DeepSpeedTorchEngine(loss_fn, params, cfg, device, eval_fn=eval_fn,
                                  trainable_mask=trainable_mask, grid=grid, model=model)
    engine.monitor = MonitorMaster(cfg)
    engine.model = model  # the flops profiler reads .cfg for its module tree
    dataloader = None
    if training_data is not None:
        index_filter = None
        cl = cfg.data_efficiency.curriculum_learning or {}
        if cl.get("data_analysis_path") and engine.curriculum_scheduler is not None:
            from .data.data_analyzer import curriculum_index_filter

            index_filter = curriculum_index_filter(
                cl["data_analysis_path"],
                cl.get("difficulty_metric", cl.get("curriculum_type", "seqlen")),
                engine.curriculum_scheduler)
        dataloader = DeepSpeedTpuDataLoader(
            training_data, micro_batch_size=cfg.train_micro_batch_size_per_gpu,
            dp_world_size=dp_world_size, dp_rank=grid.dp_rank if grid is not None else 0,
            gradient_accumulation_steps=cfg.gradient_accumulation_steps,
            collate_fn=collate_fn, seed=cfg.seed, index_filter=index_filter,
            global_batches=grid is None)
        engine.training_dataloader = dataloader  # its position rides the checkpoints
    if cfg.hybrid_engine.enabled:
        from .runtime.hybrid_engine import DeepSpeedHybridEngine

        if cfg.hybrid_engine.inference_tp_size != 1:
            raise ConfigError("hybrid_engine.inference_tp_size is not supported: hybrid "
                              "serving follows the training mesh (set mesh.model for TP)")
        engine = DeepSpeedHybridEngine(engine, max_out_tokens=cfg.hybrid_engine.max_out_tokens)
    return engine, engine, dataloader, engine.lr_scheduler
