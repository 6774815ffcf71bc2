"""deepspeed_tpu_torch — the PyTorch / CUDA port of ``deepspeed_tpu``.

A second package beside the JAX one, mirroring its module layout
(``models``, ``ops``, ``inference``, ``runtime``, ``config``, ``sequence``,
``parallel``, ``serving``, ``telemetry``, ``comm``, ``autotuning``,
``utils``) so each module's
counterpart is found by name.  It imports ``torch`` and
never ``jax`` or ``deepspeed_tpu``.  Entry points run on a CUDA device
unless the caller passes ``device="cpu"``; every Pallas kernel of the ported
paths is a hand-written CUDA kernel under ``csrc/`` (see ``ops/kernels``).

Ported so far:

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
  ``models.transformer.CausalLM`` on one GPU.
"""
from __future__ import annotations

from typing import Any, Callable, Optional


def initialize(model=None, params: Any = None, config: Any = None, device=None,
               loss_fn: Optional[Callable] = None, mesh=None, training_data=None,
               eval_fn: Optional[Callable] = None):
    """Build the training engine — ``deepspeed_tpu.initialize`` on one GPU.

    ``model`` is a ``models.transformer.CausalLM`` (or pass ``loss_fn`` and
    ``params``); ``params=None`` initialises fp32 parameters from
    ``config['seed']`` on the device.  ``device`` is CUDA unless the caller
    names another.  Returns ``(engine, engine, dataloader, lr_scheduler)``
    like the reference; the dataloader is None.  ``eval_fn`` (the
    ``loss_fn`` contract) is what ``engine.eval_batch`` runs, ``loss_fn`` by
    default.  ``config['sparse_attention']``
    sets the block-sparse layout on ``model.cfg`` (JAX ``initialize``); it
    needs ``model=``.

    Refused with ``NotImplementedError``: a Hugging Face directory as
    ``model`` and ``training_data`` (the data loader; ROADMAP queue 1
    item 9), and ``mesh`` (one device only; item 7)."""
    from .config.config import ConfigError, parse_config
    from .ops.kernels import resolve_device
    from .runtime.engine import DeepSpeedTorchEngine

    if isinstance(model, str):
        raise NotImplementedError("loading a Hugging Face directory is not ported yet "
                                  "(ROADMAP queue 1 item 9)")
    if mesh is not None:
        raise NotImplementedError("a device mesh is not ported yet: the port trains on "
                                  "one device (ROADMAP queue 1 item 7)")
    if training_data is not None:
        raise NotImplementedError("training_data (the data loader) is not ported yet "
                                  "(ROADMAP queue 1 item 9); pass batches to train_batch "
                                  "or an iterable to train_on_loader")
    cfg = parse_config(config)
    cfg.finalize(1)
    if cfg.sparse_attention.mode:
        # a layout changes the model's forward: it needs the model, never a
        # raw loss_fn it could not reach (JAX ``initialize``)
        if model is None or not hasattr(model, "cfg"):
            raise ConfigError("sparse_attention requires model= (a models.CausalLM); it "
                              "cannot be injected into a raw loss_fn")
        model.cfg = model.cfg.replace(sparse_attention=cfg.sparse_attention.build())
    device = resolve_device(device)
    if loss_fn is None:
        if model is None:
            raise ValueError("initialize() needs model= or (loss_fn, params)")
        loss_fn = model.loss_fn
    if params is None:
        if model is None:
            raise ValueError("initialize() needs params with a bare loss_fn")
        params = model.init_params(seed=cfg.seed, device=device)
    engine = DeepSpeedTorchEngine(loss_fn, params, cfg, device, eval_fn=eval_fn)
    engine.model = model
    return engine, engine, None, engine.lr_scheduler
