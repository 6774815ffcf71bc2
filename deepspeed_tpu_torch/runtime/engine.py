"""The training engine — counterpart of ``deepspeed_tpu/runtime/engine.py``
(``DeepSpeedTpuEngine``) for one GPU.

JAX jit-compiles the whole step; here it runs eagerly with autograd, the
same computation in the same order.  The ``compile`` section (a torch
backend, ``config.CompileConfig``) makes ``_jit`` wrap the model loss in
``torch.compile`` once, at construction; autograd then runs through the
compiled forward, whose graph calls the attention kernels as custom ops
(``dstpu::flash_fwd`` / ``sparse_fwd`` and their backward ops), and the
optimizer step stays outside it:

- fp32 master parameters; each micro-batch casts them to the compute type
  inside autograd (``_micro_backward``, JAX ``_micro_value_and_grad``
  :490-528), so the gradients land on the masters in fp32;
- gradient accumulation over the ``[gas, micro, ...]`` fold (``_gas_fold``
  :107): autograd sums each micro-batch's scaled gradient into the masters'
  fp32 ``.grad`` (JAX :603-626), and the divisor is ``scale * gas``;
- the fp32 masters, their gradients and the optimizer's moments are one
  flat buffer each (JAX's ``ravel_pytree``): every parameter is a view of
  the master buffer, and its ``.grad`` a view of the gradient buffer that
  autograd accumulates into in place.  The optimizer gets these leaf views
  and lays its moments out like the buffers (``ops/optimizers.py``), so an
  Adam-family update is one launch of the fused AdamW kernel (K8) with no
  copy of the gradients, an elementwise rule one pass, and Lamb's and
  Muon's leaf rules read the leaves;
- ``_apply_grads`` (JAX :530-573): unscale, fp16 overflow check, global
  norm, clip, optimizer update, overflow-skip select and loss-scale update,
  all on the device;
- the step counter (``device_step``), the learning rate (a function of
  it), the loss-scale state (``loss_scale_state``) and the step metrics are
  device tensors: the loop syncs with the host only at ``steps_per_print``
  boundaries (``async_metrics``) and in ``get_last_loss`` /
  ``get_global_grad_norm``.

``train_on_loader`` overlaps the host-to-device copy of batch k+1 with step
k (``runtime/prefetch.py``); the prefetcher keeps the loader's position
for each queued batch, so a checkpoint saved mid-loop records the oldest
unconsumed batch's position and closing the loop hands the unconsumed
batches back (JAX :1422-1522).  ``save_checkpoint`` / ``load_checkpoint``
delegate to ``checkpoint/saving.py`` with the reference's signatures.  On
one GPU the ZeRO stage changes no number.

``telemetry`` (JAX :176-181, :1026-1030): each ``train_batch`` is a
``train_batch`` span on the ``train`` track whose device reading is
deferred to a CUDA event (no per-step host sync) and lands in the
``train/step_ms`` histogram when the metrics flush at the
``steps_per_print`` boundary or in ``get_last_loss``; shared no-ops unless
``telemetry.enabled``.

ZeRO-Offload (``runtime/offload.py``; JAX :266-330, :698-752, :778-995):
under the CPU tier the masters and moments live in pinned host memory
(``self._offload``, a ``HostStream``) and ``_apply_grads`` streams them
through the card chunk by chunk; under the NVMe tier they are swap files
(``self._nvme_opt``) and ``_nvme_apply`` runs JAX's step: the gradients'
norm on the card, every leaf's copy to the host started before the norm
is read, the host AdamW walk leaf by leaf with each updated master's
upload started as it finishes, and with ``offload_pipeline`` the walk of
step k on a worker thread while step k+1's gradients compute against the
parameters one walk stale (``flush_nvme_pipeline`` joins it).  Both tiers
keep the compute-type parameters on the card as the autograd leaves
(``self._compute``) and fold each leaf's gradient into the fp32 gradient
buffer as it lands.

The reference's forward / backward / step API (JAX :1133-1346) runs the
same step in pieces: ``forward`` computes one micro-batch's loss and keeps
its autograd graph, ``backward`` adds its scaled gradient to the flat
gradient buffer, and ``step`` applies the sum at the accumulation boundary
through ``_apply_grads`` (the optimizer's update; K8 on the card for the
Adam family), as ``train_batch`` does.

The step's instruments and schedules (JAX :170-178, :403-446,
:1009-1131, :1356-1395), each off unless its config section turns it on:

- timers (``utils/timer.py``): ``step`` around ``train_batch``, fenced only
  under ``wall_clock_breakdown`` or at the profiler's step; ``fwd`` / ``bwd``
  around ``forward`` / ``backward``; logged and reset at ``steps_per_print``
  boundaries under ``wall_clock_breakdown``.  The throughput timer fences
  at those boundaries (every step without ``async_metrics``);
- ``memory_breakdown``: ``see_memory_usage`` at the boundaries;
- the flops profiler: the step ``flops_profiler.profile_step`` runs under
  ``profiling.executed_analysis`` (it counts and changes no result), then
  ``FlopsProfiler.engine_step_hook`` writes the report;
- the monitor (``engine.monitor``, attached by ``initialize``): each step's
  ``Train/Samples/train_loss`` / ``lr`` / ``loss_scale`` and the telemetry
  registry's snapshot, written when the metrics flush;
- curriculum learning (``data_efficiency.curriculum_learning``): the
  scheduler's difficulty at ``global_steps + 1``; under ``seqlen`` the
  batch is cut to it;
- progressive layer drop: each micro-batch gets a ``layer_keep`` mask
  drawn on the host from theta at the step count (JAX's ``state.step``:
  ``global_steps``, or, under fp16, ``device_step`` read back because an
  overflow skip does not advance it), from a CPU ``torch.Generator``
  seeded by (config seed, step, micro-batch) — JAX folds its step key the
  same way, so a resumed run draws the masks the uninterrupted one did;
  the model skips the dropped layers.  A loss
  function without a model's layer count gets ``pld_theta`` instead, as in
  JAX.

The model-shaping hooks (JAX :198-202, :294-305, :381-436, :508-512,
:1055-1116):

- ``compression_training`` (``compression/compress.py``): the manager's
  weight transform runs on the compute-type parameters of every
  micro-batch, after the cast and before the loss, on every path that runs
  a loss (``train_batch``, the forward / backward / step API, both offload
  tiers' compute copy), at ``device_step`` (JAX's ``state.step``: the
  updates applied before this one; an fp16 overflow skip does not advance
  it);
- ``eigenvalue`` (``runtime/eigenvalue.py``): every
  ``gas_boundary_resolution``-th ``train_batch``, the dominant Hessian
  eigenvalue of micro-batch 0's loss at the fp32 masters, appended to
  ``block_eigenvalues`` as ``(step, value)``; the loss runs the model with
  the plain attention body (a double backward cannot pass the flash
  Functions);
- a trainable mask (``initialize`` takes it from a model's
  ``trainable_mask``, ``linear/lora.py``): only the trainable leaves get an
  fp32 master, a gradient and optimizer state (the flat buffers hold them
  alone, so K8 runs over the adapters only); a frozen leaf stays on the
  device in its storage type without ``requires_grad``.
"""
from __future__ import annotations

import logging
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from ..config.config import Config, ConfigError
from ..ops.optimizers import _leaf_views, build_optimizer, set_path
from ..telemetry import Telemetry, device_ready
from ..utils.memory import memory_breakdown_report, see_memory_usage
from ..utils.timer import (BACKWARD_GLOBAL_TIMER, FORWARD_GLOBAL_TIMER, STEP_GLOBAL_TIMER,
                           SynchronizedWallClockTimer, ThroughputTimer)
from . import precision
from .dataloader import unwrap_loader_chain
from .lr_schedules import LRScheduler, get_lr_schedule_fn
from .offload import ComputeCopy, HostStream, NVMeOptimizer, PinnedPool, leaf_paths, swap_names
from .prefetch import DevicePrefetcher, MetricsBuffer, StagedBatch, host_scalar, stage

logger = logging.getLogger("deepspeed_tpu_torch")


def _gas_fold(batch: Dict[str, Any], gas: int, micro_global: int) -> Dict[str, Any]:
    """Fold a flat ``[global_batch, ...]`` batch into ``[gas, micro, ...]``
    unless it is folded already.  ``micro_global`` tells the two apart when
    it is 1: a folded batch then has a size-1 second axis."""
    x = next(iter(batch.values()))
    already = x.shape[0] == gas and (micro_global > 1 or (x.ndim >= 2 and x.shape[1] == 1))
    if already:
        return batch
    return {k: v.reshape((gas, v.shape[0] // gas) + tuple(v.shape[1:]))
            for k, v in batch.items()}


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    grad_norm: torch.Tensor
    lr: torch.Tensor
    loss_scale: torch.Tensor
    skipped: torch.Tensor  # fp16: the overflow skipped the update


def _leaves(tree, out: List[torch.Tensor]) -> List[torch.Tensor]:
    for v in tree.values():
        if isinstance(v, dict):
            _leaves(v, out)
        else:
            out.append(v)
    return out


class FlatMasters(NamedTuple):
    """fp32 masters as one buffer: ``params`` is the tree of leaf views
    (each a leaf that requires grad, listed in order in ``leaves``),
    ``grad`` the gradient buffer whose views, ``grads``, are the leaves'
    ``.grad``."""

    params: Any
    leaves: List[torch.Tensor]
    flat: torch.Tensor
    grad: torch.Tensor
    grads: List[torch.Tensor]


def _flat_masters(tree, device: torch.device) -> FlatMasters:
    """Copy a parameter tree into one flat fp32 buffer on ``device`` and
    give every leaf a view of it, with its ``.grad`` preset to a view of a
    zeroed gradient buffer (autograd then adds into it in place)."""
    total = sum(torch.as_tensor(x).numel() for x in _leaves(tree, []))
    flat = torch.empty(total, dtype=torch.float32, device=device)
    grad = torch.zeros(total, dtype=torch.float32, device=device)
    views: List[torch.Tensor] = []
    grads: List[torch.Tensor] = []
    offset = 0

    def place(node):
        nonlocal offset
        if isinstance(node, dict):
            return {k: place(v) for k, v in node.items()}
        x = torch.as_tensor(node).detach()
        n = x.numel()
        view = flat[offset:offset + n].view(x.shape)
        view.copy_(x)
        view.requires_grad_(True)
        view.grad = grad[offset:offset + n].view(x.shape)
        offset += n
        views.append(view)
        grads.append(view.grad)
        return view

    return FlatMasters(place(tree), views, flat, grad, grads)


class _Landing:
    """The gradients' host copies, leaf by leaf: iterating waits for each
    leaf's copy to land (its event) before yielding it."""

    def __init__(self, leaves: List[torch.Tensor], events: List[Any]):
        self.leaves, self.events = leaves, events

    def __len__(self) -> int:
        return len(self.leaves)

    def __iter__(self):
        for t, ev in zip(self.leaves, self.events):
            if ev is not None:
                ev.synchronize()
            yield t


def _with_cfg(model, cfg):
    """A shallow copy of a model adapter with ``cfg`` (and its wrapped
    model's, for an adapter that wraps one)."""
    import copy

    out = copy.copy(model)
    out.cfg = cfg
    inner = getattr(model, "inner", None)
    if inner is not None and getattr(inner, "cfg", None) is not None:
        out.inner = _with_cfg(inner, cfg)
    return out


def _fp32_on(tree, device: torch.device):
    """The tree's floating leaves as fp32 tensors on ``device`` (the
    masters themselves, detached, where they are that already)."""
    return {k: _fp32_on(v, device) if isinstance(v, dict)
            else v.detach().to(device=device, dtype=torch.float32) if v.is_floating_point()
            else v for k, v in tree.items()}


def _detached(tree):
    return {k: _detached(v) if isinstance(v, dict) else v.detach() for k, v in tree.items()}


class DeepSpeedTorchEngine:
    """A loss function and parameters made into a training loop.

    Contract: ``loss_fn(params, batch, rng) -> scalar loss``, a function of
    the compute-type parameters (``models.transformer.CausalLM.loss_fn``);
    ``rng`` is the engine's ``torch.Generator``; ``eval_fn`` (same
    contract, default ``loss_fn``) is what ``eval_batch`` runs."""

    def __init__(self, loss_fn: Callable, params, config: Config, device: torch.device,
                 eval_fn: Optional[Callable] = None, trainable_mask=None):
        self.config = config
        self.device = device
        self.loss_fn = loss_fn
        self.eval_fn = eval_fn
        self.model = None  # attached by initialize()
        self.timers = SynchronizedWallClockTimer()
        self.tput_timer = ThroughputTimer(batch_size=config.train_batch_size,
                                          steps_per_output=config.steps_per_print)
        self.monitor = None  # attached by initialize()
        self.flops_profiler = None  # the profiler of the last profile_step
        # unified telemetry: train_batch spans with deferred device readings
        self.telemetry = Telemetry(config.telemetry)
        self._h_step = self.telemetry.registry.histogram("train/step_ms")
        if self.telemetry.enabled:
            # settles the spans and writes a configured chrome_trace_path
            self.telemetry.register_exit_close()
        self.lr_schedule_fn = self._build_lr_schedule()
        self.lr_scheduler = LRScheduler(self.lr_schedule_fn)
        self.optimizer = build_optimizer(config.optimizer.type, config.optimizer.params)
        self.compute_dtype = precision.compute_dtype(config.precision_dtype)
        self.generator = torch.Generator(device=device).manual_seed(config.seed)
        zcfg = config.zero_optimization
        self._offload = None  # the CPU tier's HostStream
        self._nvme_opt = None  # the NVMe tier's NVMeOptimizer
        self._compute = None  # an offloaded engine's compute copy (ComputeCopy)
        self._trainable_paths = None  # under a trainable mask: the masters' paths
        if trainable_mask is not None and (zcfg.offload_nvme or zcfg.offload_cpu):
            raise NotImplementedError("a trainable mask (LoRA) with ZeRO-Offload is not "
                                      "ported yet (ROADMAP queue 1 item 9)")
        if trainable_mask is not None:
            self._init_masked(params, trainable_mask)
        elif zcfg.offload_nvme:
            self._init_nvme_offload(params)
        elif zcfg.offload_cpu:
            self._init_cpu_offload(params)
        else:
            self._masters = _flat_masters(params, device)
            self.params = self._masters.params
            self._params_list = self._masters.leaves
            self.opt_state = self.optimizer.init(self._params_list)
        fp16 = config.fp16
        self.loss_scale_state = precision.init_loss_scale(
            dynamic=fp16.enabled and fp16.loss_scale == 0,
            initial_scale_power=fp16.initial_scale_power,
            static_scale=fp16.loss_scale if fp16.enabled else 1.0,
            hysteresis=fp16.hysteresis, device=device)
        self.device_step = torch.zeros((), dtype=torch.int32, device=device)
        self.global_steps = 0
        self.skipped_steps = 0
        # the forward / backward / step API's bookkeeping (JAX :365-368)
        self._pending: Optional[torch.Tensor] = None  # forward's loss, graph attached
        self._micro_steps = 0
        self._grads_pending = False  # backward() added to the gradient buffer
        self._inside_no_sync = False
        self._last_metrics: Optional[StepMetrics] = None
        self._metrics_buffer = MetricsBuffer()
        self._h2d_stream = None  # the prefetcher's side stream, made at first use
        self._active_prefetcher: Optional[DevicePrefetcher] = None
        self._prefetch_loader = None  # what the active prefetcher draws from
        self.training_dataloader = None  # set by initialize(training_data=...)
        self._ckpt_engine = None  # checkpoint/engine.py, made at the first save / load
        self.progressive_layer_drop = None
        self.pld_masks: List[torch.Tensor] = []  # the last step's mask of each micro-batch
        if config.progressive_layer_drop.enabled:
            from .progressive_layer_drop import ProgressiveLayerDrop

            p = config.progressive_layer_drop
            self.progressive_layer_drop = ProgressiveLayerDrop(p.theta, p.gamma)
            logger.info("progressive layer drop enabled: theta=%s gamma=%s", p.theta, p.gamma)
        self._compression = None
        if config.compression_training.any_technique:
            from ..compression.compress import CompressionManager

            manager = CompressionManager(config.compression_training.as_dict())
            if manager.any_weight_transform:
                # activation quantization is wired into the model by initialize()
                self._compression = manager
                logger.info("compression: wq=%s prune=%s", manager.weight_quant.enabled,
                            manager.pruning.enabled)
        self.eigenvalue = None
        self.block_eigenvalues: List[Any] = []
        if config.eigenvalue.enabled:
            from .eigenvalue import Eigenvalue

            e = config.eigenvalue
            self.eigenvalue = Eigenvalue(
                verbose=e.verbose, max_iter=e.max_iter, tol=e.tol, stability=e.stability,
                gas_boundary_resolution=e.gas_boundary_resolution, layer_name=e.layer_name,
                layer_num=e.layer_num)
            logger.info("eigenvalue estimation enabled: max_iter=%d resolution=%d",
                        e.max_iter, e.gas_boundary_resolution)
        # (loss_fn, what _micro_loss calls for it): torch.compile'd under a
        # torch backend of the compile section, the loss itself otherwise;
        # made here, and again if a caller replaces ``loss_fn``
        self._jitted = (None, None)
        self._model_loss()
        self.curriculum_scheduler = None
        cl = config.data_efficiency.curriculum_learning or {}
        if config.data_efficiency.enabled and cl.get("enabled"):
            from ..data.curriculum_scheduler import CurriculumScheduler

            self.curriculum_scheduler = CurriculumScheduler(cl)
            self._curriculum_metric = cl.get("curriculum_type", "seqlen")
            logger.info("curriculum learning enabled: metric=%s schedule=%s",
                        self._curriculum_metric, cl.get("schedule_type"))
        logger.info("engine ready: zero_stage=%d dtype=%s micro_batch=%d gas=%d device=%s",
                    config.zero_optimization.stage, config.precision_dtype,
                    config.train_micro_batch_size_per_gpu,
                    config.gradient_accumulation_steps, device)

    def _model_loss(self) -> Callable:
        """``loss_fn`` through ``_jit``, compiled once per function."""
        if self._jitted[0] is not self.loss_fn:
            self._jitted = (self.loss_fn, self._jit(self.loss_fn))
        return self._jitted[1]

    def _jit(self, fn: Callable) -> Callable:
        """``fn`` itself unless the compile section names a torch backend
        that is on (JAX ``_jit``, engine.py:464, which jits unless
        ``disable``); then ``torch.compile(fn, backend, **kwargs)``.  A
        dynamo error raises, and so does dynamo's recompile limit (each
        engine's model is another guard on the same code; past the limit
        dynamo would run the frame eager without a word): nothing falls
        back to eager quietly."""
        c = self.config.compile
        if not c.compiles:
            return fn
        import torch._dynamo

        if torch._dynamo.config.suppress_errors:
            raise ConfigError("compile: torch._dynamo.config.suppress_errors is set, so a "
                              "failed trace would run eager without a word; unset it")
        if self.progressive_layer_drop is not None:
            raise ConfigError("compile with progressive_layer_drop: each micro-batch's layer "
                              "mask would trace another graph; run PLD eager")
        logger.info("compile: the model loss under torch.compile(backend=%r, %s)", c.backend,
                    c.kwargs)
        flag = ("fail_on_recompile_limit_hit" if hasattr(torch._dynamo.config,
                                                        "fail_on_recompile_limit_hit")
                else "fail_on_cache_limit_hit")
        return torch._dynamo.config.patch(**{flag: True})(
            torch.compile(fn, backend=c.backend, **c.kwargs))

    def _init_masked(self, params, mask) -> None:
        """Masters for the trainable leaves only (JAX :294-305, and optax's
        ``masked`` optimizer, :198-202): the flat fp32 buffers hold the
        leaves whose mask is true; a frozen leaf goes to the device in its
        own type, without ``requires_grad``, so autograd computes no
        gradient for it."""
        trainable: Dict[str, Any] = {}
        frozen: Dict[tuple, torch.Tensor] = {}
        paths: List[str] = []

        def split(node, m, path):
            for k, v in node.items():
                if isinstance(v, dict):
                    split(v, m[k], path + (k,))
                elif m[k]:
                    set_path(trainable, path + (k,), v)
                    paths.append("/".join(path + (k,)))
                else:
                    frozen[path + (k,)] = torch.as_tensor(v).detach().to(self.device)

        split(params, mask, ())
        self._masters = _flat_masters(trainable, self.device)
        views = iter(self._masters.leaves)

        def join(node, path):
            out = {}
            for k, v in node.items():
                p = path + (k,)
                out[k] = join(v, p) if isinstance(v, dict) else frozen[p] if p in frozen \
                    else next(views)
            return out

        self.params = join(params, ())
        self._params_list = self._masters.leaves
        self._trainable_paths = paths
        self.opt_state = self.optimizer.init(self._params_list)
        logger.info("trainable mask: %d of %d leaves train (%d elements), %d frozen",
                    len(paths), len(paths) + len(frozen), self._masters.flat.numel(),
                    len(frozen))

    # ------------------------------------------------------------------
    # ZeRO-Offload (runtime/offload.py)
    # ------------------------------------------------------------------
    def _offloaded_leaves(self, params):
        """(paths, the parameters' leaves, the fp32 gradient buffer on the
        card, its leaf views) of an offloaded engine."""
        paths = leaf_paths(params)
        leaves = [torch.as_tensor(x) for _, x in paths]
        grad = torch.zeros(sum(x.numel() for x in leaves), dtype=torch.float32,
                           device=self.device)
        return [p for p, _ in paths], leaves, grad, _leaf_views([grad], leaves)

    def _compute_copy(self, paths, leaves, grads):
        cc = ComputeCopy([(p, x.shape) for p, x in zip(paths, leaves)], self.compute_dtype,
                         self.device, grads)
        cc.load(leaves)
        return cc

    def _init_cpu_offload(self, params) -> None:
        """The CPU tier (JAX :266-330): masters and moments in pinned host
        memory, the compute copy and the fp32 gradients on the card."""
        paths, leaves, grad, grads = self._offloaded_leaves(params)
        self._offload = HostStream(self.optimizer, [x.shape for x in leaves], self.device)
        host = self._offload.leaves
        with torch.no_grad():
            for h, x in zip(host, leaves):
                h.copy_(x)
        tree: Dict[str, Any] = {}
        for p, h in zip(paths, host):
            set_path(tree, p, h)
        self._compute = self._compute_copy(paths, leaves, grads)
        self._masters = FlatMasters(tree, host, self._offload.masters, grad, grads)
        self.params = tree
        self._params_list = host
        self.opt_state = self._offload.state
        logger.info("ZeRO-Offload(cpu): %d fp32 masters and optimizer state in %s host "
                    "memory (%d bytes), %d chunks a step", len(host),
                    "pinned" if self.device.type == "cuda" else "CPU",
                    self._offload.host_bytes, len(self._offload.chunks))

    def _init_nvme_offload(self, params) -> None:
        """The NVMe tier (JAX ``_init_nvme_offload`` :780-830): the compute
        copy on the card, the fp32 masters and Adam moments on disk."""
        from concurrent.futures import ThreadPoolExecutor

        cfg = self.config
        if cfg.fp16.enabled:
            raise ConfigError("offload_optimizer=nvme requires bf16 (no fp16 loss scaling)")
        if cfg.optimizer.type.lower() not in ("adam", "adamw"):
            raise ConfigError(
                f"offload_optimizer=nvme supports adam/adamw (host fused kernel), "
                f"got {cfg.optimizer.type}")
        op = cfg.optimizer.params or {}
        zcfg = cfg.zero_optimization
        self._nvme_opt = NVMeOptimizer(
            zcfg.offload_nvme_path, lr=float(op.get("lr", 1e-3)),
            betas=tuple(op.get("betas", (0.9, 0.999))), eps=float(op.get("eps", 1e-8)),
            weight_decay=float(op.get("weight_decay", 0.0)),
            num_threads=cfg.aio.thread_count, queue_depth=cfg.aio.queue_depth)
        paths, leaves, grad, grads = self._offloaded_leaves(params)
        self._compute = self._compute_copy(paths, leaves, grads)
        self._nvme_opt.init(swap_names(paths), leaves)
        self._grad, self._grads = grad, grads
        self._masters = None
        self.params = self._compute.tree  # the compute copy; masters are on disk
        self._params_list = self._compute.leaves
        self.opt_state = {}
        self._nvme_paths = paths
        cuda = self.device.type == "cuda"
        self._nvme_d2h = torch.cuda.Stream(device=self.device) if cuda else None
        self._nvme_upload = torch.cuda.Stream(device=self.device) if cuda else None
        wire = torch.bfloat16 if zcfg.offload_grad_dtype == "bf16" else torch.float32
        self._nvme_pool = PinnedPool(self.device)
        # the host's landing buffers for the gradients: two when pipelined
        # (step k's walk reads one while step k+1's copies fill the other)
        self._nvme_host_grads = [self._nvme_pool.full(grad.numel(), 0.0, wire)
                                 for _ in range(2 if zcfg.offload_pipeline else 1)]
        self._nvme_wire = wire
        self._nvme_calls = 0
        self._nvme_pending = None
        self._nvme_walk_span = None
        # bounded: instrumentation for tests and diagnostics, not a step log
        self._nvme_timeline: deque = deque(maxlen=512)
        self._nvme_executor = None
        self._compute_spare = None
        if zcfg.offload_pipeline:
            # one worker: walks are strictly ordered (step k joins before
            # step k+1's walk is submitted)
            self._nvme_executor = ThreadPoolExecutor(max_workers=1,
                                                     thread_name_prefix="dst-nvme-walk")
            self._compute_spare = self._compute_copy(paths, leaves, grads)
            logger.info("nvme offload: pipelined (delayed parameter update: the host Adam "
                        "walk overlaps the next step's gradients)")

    def _nvme_apply(self, divisor):
        """The NVMe tier's step after the micro-batches' backward (JAX
        ``_make_nvme_train_step`` :832-975): gradients averaged, their
        norm, every leaf's copy to the host started, the previous walk
        joined (pipelined), then the host AdamW walk of this step, on the
        worker thread when pipelined, here otherwise."""
        cfg = self.config
        pipelined = self._nvme_executor is not None
        grad = self._grad.div_(divisor)
        grad_norm = precision.global_grad_norm([grad])
        wire = grad if self._nvme_wire == torch.float32 else grad.to(self._nvme_wire)
        host = self._nvme_host_grads[self._nvme_calls % len(self._nvme_host_grads)]
        self._nvme_calls += 1
        if pipelined:
            self._nvme_timeline.append(("dispatch", time.perf_counter()))
        landed = self._nvme_copy_down(wire, host)
        joined = self._join_nvme_walk()  # the host blocks; the card is busy
        gn = float(grad_norm)
        clip = cfg.gradient_clipping
        coef = min(1.0, clip / (gn + 1e-6)) if clip and clip > 0 else 1.0
        lr = float(self.lr_schedule_fn(self.device_step))
        step_num = int(self.device_step) + 1
        done = torch.cuda.Event() if self._nvme_upload is not None else None
        if done is not None:  # the walk's uploads wait for this step's reads of the params
            done.record(torch.cuda.current_stream(self.device))
        if pipelined:
            if joined is not None:
                self._adopt_walk(joined)
            target = self._compute_spare
            self._nvme_pending = self._nvme_executor.submit(
                self._timed_walk, landed, lr, step_num, coef, target, done)
        else:
            self._adopt_walk(self._host_walk(landed, lr, step_num, coef, self._compute, done))
        self.device_step += 1
        lr_t = torch.tensor(lr, dtype=torch.float32, device=self.device)
        return grad_norm, lr_t, torch.zeros((), dtype=torch.bool, device=self.device)

    def _nvme_copy_down(self, wire: torch.Tensor, host: torch.Tensor) -> "_Landing":
        """Start each leaf's gradient copy into ``host`` (a side stream on
        the card), then zero the gradient buffer behind them."""
        views = []
        events = []
        off = 0
        side = self._nvme_d2h
        if side is not None:
            side.wait_stream(torch.cuda.current_stream(self.device))
        for g in self._grads:
            n = g.numel()
            dst = host[off:off + n].view(g.shape)
            if side is not None:
                with torch.cuda.stream(side):
                    dst.copy_(wire[off:off + n].view(g.shape), non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(side)
                events.append(ev)
            else:
                dst.copy_(wire[off:off + n].view(g.shape))
                events.append(None)
            views.append(dst)
            off += n
        if side is not None:  # the buffer is zeroed (and ``wire`` freed) behind the copies
            torch.cuda.current_stream(self.device).wait_stream(side)
        self._grad.zero_()
        return _Landing(views, events)

    def _host_walk(self, grads: "_Landing", lr: float, step_num: int, coef: float,
                   target, ready):
        """Step k's host side: swap I/O, the host AdamW, and each updated
        master's upload into ``target`` (a ``ComputeCopy``) as soon as it is
        done.  Returns ``(target, event)``: the event marks the uploads on
        the card."""
        up = self._nvme_upload
        if up is not None:
            up.wait_event(ready)
        leaves = target.leaves

        def on_leaf(i, master):
            with (torch.cuda.stream(up) if up is not None else nullcontext()), torch.no_grad():
                leaves[i].copy_(master.view(leaves[i].shape))

        self._nvme_opt.step(grads, lr, step_num, coef, on_leaf=on_leaf)
        ev = None
        if up is not None:
            ev = torch.cuda.Event()
            ev.record(up)
        return target, ev

    def _timed_walk(self, grads, lr, step_num, coef, target, ready):
        t0 = time.perf_counter()
        self._nvme_timeline.append(("walk_start", t0))
        out = self._host_walk(grads, lr, step_num, coef, target, ready)
        t1 = time.perf_counter()
        self._nvme_timeline.append(("walk_end", t1))
        self._nvme_walk_span = (t0, t1)
        return out

    def _adopt_walk(self, walk) -> None:
        """Make a finished walk's compute copy the live one."""
        target, ev = walk
        if ev is not None:
            torch.cuda.current_stream(self.device).wait_event(ev)
        if target is not self._compute:
            self._compute_spare, self._compute = self._compute, target
        self.params = self._compute.tree
        self._params_list = self._compute.leaves

    def _join_nvme_walk(self):
        """The pending background walk's result (pipelined), or None."""
        pending = getattr(self, "_nvme_pending", None)
        if pending is None:
            return None
        self._nvme_pending = None
        return pending.result()

    def flush_nvme_pipeline(self) -> None:
        """Complete any background host walk and adopt its parameters
        (before checkpoint save / load, eval and exports, so the visible
        state is exact and no worker races the swap files)."""
        walk = self._join_nvme_walk()
        if walk is not None:
            self._adopt_walk(walk)

    def _before_state_io(self) -> None:
        """Make the host-side state complete before the host reads or
        writes it: join the NVMe walk, land the CPU tier's write-backs."""
        self.flush_nvme_pipeline()
        if self._offload is not None:
            self._offload.settle()

    def _after_state_load(self) -> None:
        """After a checkpoint load: the CPU tier's compute copy from the
        loaded host masters."""
        if self._offload is not None:
            self._offload.refresh(self._compute.flat)

    def _build_lr_schedule(self) -> Callable:
        sched = self.config.scheduler
        if sched.type is None and "lr" in (self.config.optimizer.params or {}):
            return get_lr_schedule_fn(None, {"lr": self.config.optimizer.params["lr"]})
        return get_lr_schedule_fn(sched.type, sched.params)

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def _compute_params(self):
        """The compute-type parameters the loss runs on: the cast of the
        masters (autograd reaches the masters through it), or an offloaded
        engine's compute copy."""
        if self._compute is not None:
            return self._compute.loss_tree
        return precision.cast_floating(self.params, self.compute_dtype)

    def _pld_step(self) -> int:
        """The step count PLD's theta reads (JAX's ``state.step``): the
        applied updates, which under fp16 lag ``global_steps`` by the
        overflow skips (a host read of ``device_step``)."""
        if self.config.fp16.enabled:
            return int(self.device_step)
        return self.global_steps

    def _micro_loss(self, micro: Dict[str, torch.Tensor], index: int = 0) -> torch.Tensor:
        """Loss of micro-batch ``index`` of the step through the compute-type
        parameters, its autograd graph attached; under PLD the micro-batch
        carries the layer mask drawn for it."""
        pld = self.progressive_layer_drop
        if pld is not None:
            theta = pld.theta_at(self._pld_step())
            cfg = getattr(self.model, "cfg", None)
            if cfg is None:
                micro = dict(micro, pld_theta=theta)
            else:
                from .progressive_layer_drop import layer_keep_mask, pld_generator

                gen = pld_generator(self.config.seed, self.global_steps + 1, index)
                keep = layer_keep_mask(gen, cfg.num_layers, theta)
                self.pld_masks.append(keep)
                micro = dict(micro, layer_keep=keep)
        params = self._compute_params()
        if self._compression is not None:
            # QAT fake-quant / pruning (STE) at the applied-update count
            params = self._compression.transform(params, self.device_step)
        return self._model_loss()(params, micro, self.generator)

    def _micro_backward(self, micro: Dict[str, torch.Tensor], scale,
                        index: int = 0) -> torch.Tensor:
        """Loss of micro-batch ``index``; ``(loss * scale).backward()`` adds
        its gradient, through the compute-type cast, to the masters'
        ``.grad``."""
        loss = self._micro_loss(micro, index)
        (loss * scale if scale is not None else loss).backward()
        return loss.detach().float()

    def _apply_grads(self, divisor):
        cfg = self.config
        fp16 = cfg.fp16.enabled
        grad = self._masters.grad.div_(divisor)
        finite = precision.grads_finite([grad]) if fp16 else None
        grad_norm = precision.global_grad_norm([grad])
        if cfg.gradient_clipping and cfg.gradient_clipping > 0:
            grad.mul_(precision.clip_factor(grad_norm, cfg.gradient_clipping))
        lr = self.lr_schedule_fn(self.device_step)
        if self._offload is not None:  # the CPU tier: the state streamed through the card
            self._offload.update(grad, self._masters.grads, self._compute.flat, lr, finite)
        else:
            self.optimizer.step(self._params_list, self._masters.grads, self.opt_state, lr,
                                finite)
        grad.zero_()
        if fp16 and cfg.fp16.loss_scale == 0:
            self.loss_scale_state = precision.update_loss_scale(
                self.loss_scale_state, finite, loss_scale_window=cfg.fp16.loss_scale_window,
                min_scale=cfg.fp16.min_loss_scale, init_hysteresis=cfg.fp16.hysteresis)
        if finite is None:
            self.device_step += 1
            skipped = torch.zeros((), dtype=torch.bool, device=self.device)
        else:
            self.device_step += finite.to(torch.int32)
            skipped = ~finite
        return grad_norm, lr, skipped

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        if isinstance(batch, StagedBatch):
            return batch.wait()
        cfg = self.config
        batch = _gas_fold(batch, cfg.gradient_accumulation_steps,
                          cfg.train_micro_batch_size_per_gpu * cfg.dp_world_size)
        return stage(batch, self.device).batch

    def train_batch(self, batch) -> torch.Tensor:
        """One optimizer step on a global batch ``[gas, micro, ...]`` (or
        flat ``[gas * micro, ...]``); returns the mean loss as a device
        scalar."""
        batch = self._to_device(batch)
        cfg = self.config
        if self.curriculum_scheduler is not None:
            difficulty = self.curriculum_scheduler.update_difficulty(self.global_steps + 1)
            if self._curriculum_metric == "seqlen":
                from ..data.curriculum_scheduler import truncate_to_seqlen

                batch = truncate_to_seqlen(batch, difficulty)
        gas = cfg.gradient_accumulation_steps
        fp16 = cfg.fp16.enabled
        scale = self.loss_scale_state.scale if fp16 else None
        fp = cfg.flops_profiler
        profiling_now = fp.enabled and self.global_steps + 1 == fp.profile_step
        counting = nullcontext({})
        if profiling_now:
            from ..profiling.flops_profiler import executed_analysis

            counting = executed_analysis(self.device)
        self.pld_masks = []
        self.tput_timer.start()
        self.timers(STEP_GLOBAL_TIMER).start()
        # the dispatch wall time lands now; the device reading waits for
        # the metrics flush (no per-step host sync)
        tb_span = self.telemetry.recorder.start(
            "train_batch", track="train", hist=self._h_step, step=self.global_steps + 1)
        with self.telemetry.step_annotation("train_batch", self.global_steps + 1), \
                counting as executed:
            loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
            for i in range(gas):
                loss_sum += self._micro_backward({k: v[i] for k, v in batch.items()}, scale, i)
            divisor = scale * gas if fp16 else float(gas)
            if self._nvme_opt is not None:
                grad_norm, lr, skipped = self._nvme_apply(divisor)
            else:
                grad_norm, lr, skipped = self._apply_grads(divisor)
        loss_scale = self.loss_scale_state.scale if fp16 else torch.ones((), device=self.device)
        metrics = StepMetrics(loss_sum / gas, grad_norm, lr, loss_scale, skipped)
        tb_span.end(sync_obj=device_ready(metrics.loss) if self.telemetry.enabled else None)
        self._last_metrics = metrics
        self.global_steps += 1
        self.lr_scheduler.step()
        self._metrics_buffer.append(
            self.global_steps, metrics,
            keep_history=fp16 or (self.monitor is not None and self.monitor.enabled))
        if self.progressive_layer_drop is not None:
            self.progressive_layer_drop.update_state(self.global_steps)
        if (self.eigenvalue is not None
                and self.global_steps % self.eigenvalue.gas_boundary_resolution == 0):
            self._compute_block_eigenvalue(batch)
        # the profiler divides its FLOPs by this window: a fenced device time
        self.timers(STEP_GLOBAL_TIMER).stop(
            sync_obj=metrics.loss if (cfg.wall_clock_breakdown or profiling_now) else None)
        print_boundary = self.global_steps % cfg.steps_per_print == 0
        async_metrics = cfg.train_data.async_metrics
        self.tput_timer.stop(
            sync_obj=metrics.loss if (not async_metrics or print_boundary) else None)
        if cfg.memory_breakdown and print_boundary:
            see_memory_usage(f"after step {self.global_steps}", force=True, device=self.device)
        if not async_metrics or print_boundary:
            self._flush_step_metrics()
        if profiling_now:
            # before the timers' log below: log(reset=True) zeroes the step
            # timer the profiler reads its latency from
            self._run_flops_profiler(batch, executed)
        if cfg.wall_clock_breakdown and print_boundary:
            self.timers.log([FORWARD_GLOBAL_TIMER, BACKWARD_GLOBAL_TIMER, STEP_GLOBAL_TIMER],
                            reset=True)
        return metrics.loss

    def _eigen_loss_fn(self) -> Callable:
        """The loss the eigenvalue estimator differentiates twice: the
        model's with the plain attention body, or the engine's loss when it
        is not the model's."""
        model = self.model
        if model is None or getattr(model, "cfg", None) is None or \
                self.loss_fn != getattr(model, "loss_fn", None):
            return self.loss_fn
        return _with_cfg(model, model.cfg.replace(attn_impl="reference")).loss_fn

    def _compute_block_eigenvalue(self, batch) -> None:
        """The curvature estimate at the accumulation boundary (JAX
        :1096-1116): micro-batch 0, the fp32 masters cast to the compute
        type inside the loss; ``(step, value)`` goes to
        ``block_eigenvalues``."""
        micro = {k: v[0] for k, v in batch.items()}
        loss_fn = self._eigen_loss_fn()
        dtype = self.compute_dtype

        def eig_loss(p, b, r):
            return loss_fn(precision.cast_floating(p, dtype), b, r)

        self.flush_nvme_pipeline()
        masters = _fp32_on(self.params, self.device)
        ev, _ = self.eigenvalue.compute_eigenvalue(eig_loss, masters, micro,
                                                   generator=self.generator)
        self.block_eigenvalues.append((self.global_steps, ev))
        logger.info("eigenvalue at step %d: %.4e", self.global_steps, ev)

    def _run_flops_profiler(self, batch, executed) -> None:
        """The flops profiler at ``profile_step`` (JAX :1118-1131): the
        step's fenced duration, its counts, the report."""
        from ..profiling.flops_profiler import FlopsProfiler

        prof = FlopsProfiler(model=self.model, engine=self)
        # this step's fenced duration, not the mean (step 1 carries the
        # first calls' setup: set profile_step >= 2 for a clean reading)
        prof._duration = self.timers(STEP_GLOBAL_TIMER).last()
        prof.engine_step_hook(self, batch, executed)
        self.flops_profiler = prof

    def _flush_step_metrics(self) -> None:
        """Host accounting of the buffered metrics: fp16 skip counts, the
        ``steps_per_print`` log line and the monitor's events, a step at a
        time in order (JAX :1356-1395); the deferred telemetry spans settle
        at the same boundary."""
        self.telemetry.flush()
        emit = self.monitor is not None and self.monitor.enabled
        events = []
        for step, m in self._metrics_buffer.flush():
            if self.config.fp16.enabled and m.skipped:
                self.skipped_steps += 1
            if step % self.config.steps_per_print == 0:
                logger.info("step=%d loss=%.4f lr=%.3e grad_norm=%.3f", step, m.loss, m.lr,
                            m.grad_norm)
            if emit:
                events.extend([("Train/Samples/train_loss", m.loss, step),
                               ("Train/Samples/lr", m.lr, step),
                               ("Train/Samples/loss_scale", m.loss_scale, step)])
        if emit and self.telemetry.enabled:
            # the registry's aggregates ride the same (label, value, step) fan-out
            events.extend(self.telemetry.registry.snapshot(self.global_steps))
        if events:
            self.monitor.write_events(events)

    # ------------------------------------------------------------------
    # the reference's forward / backward / step API (JAX :1133-1283)
    # ------------------------------------------------------------------
    def forward(self, micro_batch) -> torch.Tensor:
        """One micro-batch's loss (``[micro, ...]`` arrays), through the
        compute-type cast of the masters as ``_micro_backward`` computes it;
        its autograd graph waits for ``backward``.  A second ``forward``
        before ``backward`` replaces the pending one.  Returns the loss as a
        detached fp32 device scalar.  Refused under the NVMe tier, as in
        JAX."""
        if self._nvme_opt is not None:
            raise NotImplementedError(
                "offload_optimizer=nvme supports the fused train_batch() path only")
        self.timers(FORWARD_GLOBAL_TIMER).start()
        self.pld_masks = []
        self._pending = self._micro_loss(stage(micro_batch, self.device).batch,
                                         self._micro_steps % self.config.gradient_accumulation_steps)
        self.timers(FORWARD_GLOBAL_TIMER).stop()
        return self._pending.detach().float()

    __call__ = forward

    def backward(self, loss=None) -> None:
        """Add the pending micro-batch's gradient, scaled by the fp16 loss
        scale (or 1), to the flat fp32 gradient buffer and count a micro
        step.  ``loss`` is accepted for the reference's signature; the
        gradient is the pending ``forward``'s."""
        assert self._pending is not None, "backward() without a prior forward()"
        self.timers(BACKWARD_GLOBAL_TIMER).start()
        loss, self._pending = self._pending, None
        (loss * self.loss_scale_state.scale if self.config.fp16.enabled else loss).backward()
        self._micro_steps += 1
        self._grads_pending = True
        self.timers(BACKWARD_GLOBAL_TIMER).stop()

    def is_gradient_accumulation_boundary(self) -> bool:
        """Whether ``step`` applies the gradients now: every
        ``gradient_accumulation_steps`` micro steps, never inside
        ``no_sync``."""
        if self._inside_no_sync:
            return False
        return self._micro_steps % self.config.gradient_accumulation_steps == 0

    @contextmanager
    def no_sync(self):
        """The reference's contract: illegal at ZeRO stage >= 2 (there the
        partitioning is the reduction), not re-entrant, ``step()`` inside it
        raises, and no micro step inside it is a boundary.  On one device
        there is no reduction to defer, so it changes no number."""
        stage_ = self.config.zero_optimization.stage
        if stage_ >= 2:
            raise RuntimeError(
                f"no_sync is incompatible with the gradient partitioning of ZeRO stage {stage_}")
        if self._inside_no_sync:
            raise RuntimeError("no_sync context manager reentry is unsupported")
        self._inside_no_sync = True
        try:
            yield
        finally:
            self._inside_no_sync = False

    def step(self) -> None:
        """At the accumulation boundary, apply the summed gradients (divided
        by scale x GAS) as ``train_batch`` does, count the step (and an fp16
        overflow skip: a host read) and step the LR scheduler; off the
        boundary, nothing."""
        if self._inside_no_sync:
            raise RuntimeError("it is illegal to call engine.step() within no_sync")
        if not self.is_gradient_accumulation_boundary():
            return
        if not self._grads_pending:
            raise RuntimeError("step() at the accumulation boundary without a backward() "
                               "since the last step")
        gas = self.config.gradient_accumulation_steps
        fp16 = self.config.fp16.enabled
        _, _, skipped = self._apply_grads(self.loss_scale_state.scale * gas if fp16
                                          else float(gas))
        self._grads_pending = False
        self.global_steps += 1
        if fp16 and bool(skipped):
            self.skipped_steps += 1
        self.lr_scheduler.step()

    def eval_batch(self, batch) -> torch.Tensor:
        """``eval_fn`` (or ``loss_fn``) of the compute-type parameters on one
        batch, without gradients; joins a pipelined NVMe walk and settles
        the deferred step metrics first."""
        self.flush_nvme_pipeline()
        self._flush_step_metrics()
        fn = self.eval_fn or self.loss_fn
        b = stage(batch, self.device).batch
        with torch.no_grad():
            return fn(self._compute_params(), b, self.generator)

    # ------------------------------------------------------------------
    # the pipelined loop
    # ------------------------------------------------------------------
    def _place_batch(self, batch) -> StagedBatch:
        """Fold and stage a batch on the prefetch worker: pinned host copy,
        host-to-device copy on a side stream (CUDA)."""
        cfg = self.config
        batch = _gas_fold(batch, cfg.gradient_accumulation_steps,
                          cfg.train_micro_batch_size_per_gpu * cfg.dp_world_size)
        return stage(batch, self.device, self._h2d_stream)

    def train_on_loader(self, data_loader, num_steps: Optional[int] = None):
        """Generator over ``train_batch`` steps on the batches of
        ``data_loader``, with ``train_data.prefetch_depth`` batches copied to
        the device ahead of the step.  Yields each step's loss as a device
        scalar; ``get_last_loss()`` gives a synced value.  When the generator
        closes, the batches prefetched and never consumed go back to the
        loader's position, and a checkpoint saved meanwhile records that
        same position.  A sampler with an ``index_filter`` (curriculum) or a
        ``CurriculumDataSampler`` reads the live difficulty at draw time, so
        it runs without prefetch, as in JAX (:1439-1450)."""
        from ..data.data_analyzer import CurriculumDataSampler

        def draws_at_live_difficulty(link) -> bool:
            sampler = getattr(link, "data_sampler", None)
            return (getattr(sampler, "index_filter", None) is not None
                    or isinstance(sampler, CurriculumDataSampler)
                    or isinstance(link, CurriculumDataSampler))

        depth = self.config.train_data.prefetch_depth
        if depth > 0 and any(draws_at_live_difficulty(link)
                             for link in unwrap_loader_chain(data_loader)):
            logger.info("train_on_loader: curriculum-driven sampling — no prefetch for this "
                        "loader (the eligible pool is built at the consuming step's difficulty)")
            depth = 0
        n = 0
        if depth == 0:
            try:
                for batch in data_loader:
                    yield self.train_batch(batch)
                    n += 1
                    if num_steps is not None and n >= num_steps:
                        return
            finally:
                self._flush_step_metrics()
            return
        if self._active_prefetcher is not None:
            raise RuntimeError("train_on_loader is already active on this engine; "
                               "close the previous generator first")
        if self.device.type == "cuda" and self._h2d_stream is None:
            self._h2d_stream = torch.cuda.Stream(device=self.device)
        # the position's owner, found along the wrapper chain the
        # checkpoint's drain check walks too (JAX :1479-1522)
        state_owner = next((link for link in unwrap_loader_chain(data_loader)
                            if callable(getattr(link, "state_dict", None))), None)
        pf = DevicePrefetcher(iter(data_loader), self._place_batch, depth=depth,
                              state_fn=state_owner.state_dict if state_owner else None)
        self._active_prefetcher = pf
        self._prefetch_loader = data_loader
        try:
            for staged in pf:
                yield self.train_batch(staged)
                n += 1
                if num_steps is not None and n >= num_steps:
                    return
        finally:
            stopped = pf.close()
            resume = pf.resume_state()
            self._active_prefetcher = None
            self._prefetch_loader = None
            if stopped and resume is not None and callable(
                    getattr(state_owner, "load_state_dict", None)):
                # the batches prefetched and never consumed go back to the loader
                state_owner.load_state_dict(resume)
            elif not stopped:
                logger.warning("prefetch worker did not stop within its timeout; the "
                               "loader's position is left as it is")
            self._flush_step_metrics()

    # ------------------------------------------------------------------
    # checkpoints (checkpoint/saving.py), with the reference's signatures
    # (runtime/engine.py:3218, :2872)
    # ------------------------------------------------------------------
    def save_checkpoint(self, save_dir, tag=None, client_state=None, save_latest: bool = True,
                        exclude_frozen_parameters: bool = False):
        """Save the training state, the step counters, the LR scheduler, the
        data position and ``client_state`` under ``save_dir/tag``; returns
        the tag's path.  Every parameter trains here, so
        ``exclude_frozen_parameters`` changes nothing."""
        from ..checkpoint.saving import save_checkpoint as _save

        self.flush_nvme_pipeline()
        return _save(self, save_dir, tag=tag, client_state=client_state or {},
                     save_latest=save_latest)

    def load_checkpoint(self, load_dir, tag=None, load_module_strict: bool = True,
                        load_optimizer_states: bool = True,
                        load_lr_scheduler_states: bool = True,
                        load_module_only: bool = False, custom_load_fn=None):
        """Restore a checkpoint in place; returns ``(path, client_state)``
        (``(None, {})`` when there is none).  ``load_module_only`` restores
        the parameters and counters without the optimizer and LR state.
        The load is always strict; ``custom_load_fn`` is refused."""
        from ..checkpoint.saving import load_checkpoint as _load

        if custom_load_fn is not None:
            raise NotImplementedError("custom_load_fn is not supported: the checkpoint's "
                                      "leaves load into the engine's own tensors")
        if load_module_only:
            load_optimizer_states = load_lr_scheduler_states = False
        # a pending walk would race the swap files being restored, and its
        # result would overwrite the loaded parameters at the next join
        self.flush_nvme_pipeline()
        return _load(self, load_dir, tag=tag, load_optimizer_states=load_optimizer_states,
                     load_lr_scheduler_states=load_lr_scheduler_states)

    def wait_pending_checkpoint(self) -> None:
        """Block until an async save has been written and published (the
        reference's ``NebulaCheckpointEngine`` commit)."""
        if self._ckpt_engine is not None:
            self._ckpt_engine.wait()

    # ------------------------------------------------------------------
    # reads
    # ------------------------------------------------------------------
    def get_last_loss(self) -> Optional[float]:
        """Synced loss of the newest step (flushes the deferred metrics)."""
        self._flush_step_metrics()
        if self._last_metrics is None:
            return None
        return host_scalar(self._last_metrics.loss)

    def get_global_grad_norm(self) -> Optional[float]:
        if self._last_metrics is None:
            return None
        self._flush_step_metrics()
        return host_scalar(self._last_metrics.grad_norm)

    def get_lr(self) -> List[float]:
        return self.lr_scheduler.get_last_lr()

    @property
    def loss_scale(self) -> float:
        """The current loss scale (1.0 without fp16); a host read."""
        return host_scalar(self.loss_scale_state.scale)

    def gradient_accumulation_steps(self) -> int:
        return self.config.gradient_accumulation_steps

    def train_micro_batch_size_per_gpu(self) -> int:
        return self.config.train_micro_batch_size_per_gpu

    @property
    def dp_world_size(self) -> int:
        return self.config.dp_world_size

    def module_params(self):
        """The parameters in the compute type (a detached copy of the
        masters' tree; the masters themselves when that is fp32; an
        offloaded engine's compute copy, detached views of it)."""
        self.flush_nvme_pipeline()
        if self._compute is not None:
            return _detached(self._compute.tree)
        with torch.no_grad():
            return precision.cast_floating(self.params, self.compute_dtype)

    def memory_breakdown(self) -> Dict[str, Any]:
        """Bytes of the fp32 masters and the optimizer state, and a device /
        host memory snapshot (JAX ``memory_breakdown_report``)."""
        return memory_breakdown_report(self)
