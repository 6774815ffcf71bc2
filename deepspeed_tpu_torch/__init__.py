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
  (``runtime.hybrid_engine``) and random-LTD (``data.random_ltd``).
"""
from __future__ import annotations

from typing import Any, Callable, Optional


def initialize(model=None, params: Any = None, config: Any = None, device=None,
               loss_fn: Optional[Callable] = None, mesh=None, training_data=None,
               eval_fn: Optional[Callable] = None, collate_fn: Optional[Callable] = None):
    """Build the training engine — ``deepspeed_tpu.initialize`` on one GPU.

    ``model`` is a ``models.transformer.CausalLM`` (or pass ``loss_fn`` and
    ``params``), or the path of a Hugging Face checkpoint directory: its
    ``config.json`` gives the model (``checkpoint.config_from_hf``) and its
    safetensors are streamed onto the device one tensor at a time
    (``checkpoint.load_hf_checkpoint``).  ``params=None`` otherwise
    initialises fp32 parameters from ``config['seed']`` on the device.
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
    ``__init__.py:120-133``, ``:284-294``, ``:337-350``).

    Refused with ``NotImplementedError``: ``mesh`` (one device only;
    ROADMAP queue 1 item 7)."""
    from .config.config import ConfigError, parse_config
    from .monitor.monitor import MonitorMaster
    from .ops.kernels import resolve_device
    from .runtime.dataloader import DeepSpeedTpuDataLoader
    from .runtime.engine import DeepSpeedTorchEngine

    if mesh is not None:
        raise NotImplementedError("a device mesh is not ported yet: the port trains on "
                                  "one device (ROADMAP queue 1 item 7)")
    cfg = parse_config(config)
    cfg.finalize(1)
    device = resolve_device(device)
    if isinstance(model, str):
        import json
        import os

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
    if loss_fn is None:
        if model is None:
            raise ValueError("initialize() needs model= or (loss_fn, params)")
        loss_fn = model.loss_fn
    if params is None:
        if model is None:
            raise ValueError("initialize() needs params with a bare loss_fn")
        params = model.init_params(seed=cfg.seed, device=device)
    trainable_mask = None
    if model is not None and hasattr(model, "trainable_mask"):
        trainable_mask = model.trainable_mask(params)
    engine = DeepSpeedTorchEngine(loss_fn, params, cfg, device, eval_fn=eval_fn,
                                  trainable_mask=trainable_mask)
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
            dp_world_size=1, gradient_accumulation_steps=cfg.gradient_accumulation_steps,
            collate_fn=collate_fn, seed=cfg.seed, index_filter=index_filter)
        engine.training_dataloader = dataloader  # its position rides the checkpoints
    if cfg.hybrid_engine.enabled:
        from .runtime.hybrid_engine import DeepSpeedHybridEngine

        if cfg.hybrid_engine.inference_tp_size != 1:
            raise ConfigError("hybrid_engine.inference_tp_size is not supported: hybrid "
                              "serving follows the training mesh (set mesh.model for TP)")
        engine = DeepSpeedHybridEngine(engine, max_out_tokens=cfg.hybrid_engine.max_out_tokens)
    return engine, engine, dataloader, engine.lr_scheduler
