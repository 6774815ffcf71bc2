"""Config: one JSON / dict tree -> validated dataclasses — counterpart of
``deepspeed_tpu/config/config.py`` (``parse_config`` :1134), for the keys
the port runs:

- ``train_batch_size``, ``train_micro_batch_size_per_gpu``,
  ``gradient_accumulation_steps`` (any two determine the third; all three
  must satisfy ``train = micro * gas * dp``);
- ``optimizer``, ``scheduler``, ``bf16``, ``fp16``, ``gradient_clipping``,
  ``steps_per_print``, ``seed``, ``train_data.prefetch_depth`` /
  ``async_metrics``;
- ``sparse_attention`` (the block-sparse layout ``initialize`` wires into
  the model);
- ``zero_optimization.stage`` 0-3 and ``param_persistence_threshold``
  (across the ranks of a process grid, ``runtime/zero.py``; on one device
  outside a world, as on the JAX package's one-device mesh, every stage
  keeps the whole state on the device and changes no number), the ZeRO++
  keys (``zero_quantized_weights`` / ``_gradients``, ``zeropp_loco_param``,
  ``zero_hpz_partition_size``, ``mics_shard_size``; ``runtime/zeropp.py``),
  ``mesh`` (``MeshConfig``: ``data`` / ``fsdp`` sizes) and
  ``comms_logger`` (``CommsLoggerConfig``);
- ZeRO-Offload (``ZeroConfig``, JAX's parse and texts):
  ``offload_optimizer`` / ``offload_param`` (``"cpu"``, ``"nvme"`` for
  the optimizer, or the reference's nested ``{"device", "nvme_path",
  "pipeline", "pipeline_read", "pipeline_write"}``), ``offload_nvme_path``,
  ``offload_pipeline``, ``offload_grad_dtype``, and the ``aio`` section
  (``AIOConfig``: the async I/O engine's threads and queue depth);
- ``telemetry`` (``TelemetryConfig``: the training engine records its
  ``train_batch`` spans and ``train/step_ms`` histogram under it);
- ``autotune`` (``AutotuneConfig``: the offline search's knobs, consumed
  by ``autotuning.autotune_model`` / ``autotune_serving``, never by the
  runtime engine);
- the serving blocks ``serve`` (``ServeConfig``: megastep, deadlines,
  retries, shed mode and the watchdog), ``serve_engine``
  (``ServeEngineConfig``, the ``build_serve_engine`` seam) and ``router``
  (``RouterConfig``, ``serving.build_router``).  The JAX ``Config`` keeps
  only ``telemetry``; the port's also carries the three serving blocks so
  one file configures a front end.  ``serve.adaptation``
  (``AdaptationConfig``) configures the online controller
  (``autotuning.attach_controller``).

- ``checkpoint`` / ``nebula`` (``checkpoint.async_save`` or
  ``nebula.enabled`` selects the async checkpoint engine) and
  ``moe``, ``prescale_gradients``, ``dump_state``,
  ``activation_checkpointing`` (accepted and never read, as in JAX);
- the training step's instruments and schedules, in JAX's dataclasses:
  ``wall_clock_breakdown``, ``memory_breakdown``, ``flops_profiler``
  (``FlopsProfilerConfig``), the monitors ``tensorboard`` / ``csv_monitor``
  / ``wandb`` / ``comet`` (``MonitorSubConfig``), ``data_efficiency``
  (``DataEfficiencyConfig``; the legacy top-level ``curriculum_learning``
  maps onto it, as in JAX) and ``progressive_layer_drop`` (``PLDConfig``);
- the model-shaping sections, in JAX's dataclasses: ``compression_training``
  (``CompressionConfig``: the engine's weight transform and the activation
  bits ``initialize`` wires into the model), ``eigenvalue``
  (``EigenvalueConfig``: the engine's block eigenvalues) and
  ``hybrid_engine`` (``HybridEngineConfig``: ``initialize`` returns a
  ``runtime.hybrid_engine.DeepSpeedHybridEngine``);
- ``elasticity`` (JAX's dict: ``initialize`` adopts the elastic batch size
  and micro-batch, ``elasticity.compute_elastic_config``) and ``compile``
  (``CompileConfig``: the engine's ``_jit`` of the model loss).

An unknown key raises ``ConfigError`` naming it, as in JAX.  A key the JAX
package knows but the port does not run yet is accepted at JAX's default
and raises ``NotImplementedError`` naming it and its ROADMAP queue-1 item
when its value differs (``_UNPORTED_TOP``, ``_UNPORTED_ZERO``): a mesh
axis ``seq`` / ``expert`` / ``stage`` above 1 is item 7.  ``mesh.model``
and ``tensor_parallel`` (its ``domino_chunks``) run in a process world
(``initialize``); ``serve.quant_comm`` / ``comm_tiles`` and
``serve_engine.tp`` run on a serving engine over a ``model`` grid.  The
reference keys JAX accepts and ignores are accepted and ignored here too.
"""
from __future__ import annotations

import copy
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

AUTO = "auto"


class ConfigError(ValueError):
    pass


# Top-level keys and sections of the JAX Config the port does not run yet:
# (JAX's default value, or (JAX's dataclass name, its fields' defaults), and
# the ROADMAP queue-1 item that ports it).  A key is refused only when its
# value differs from JAX's default, which an enabled section always does; at
# the default it is accepted and changes nothing, as in JAX.
_UNPORTED_TOP: Dict[str, Any] = {}
# mesh axes the port does not run across ranks yet (pipeline parallelism):
# above 1 the ``mesh`` key is refused
_UNPORTED_MESH_AXES = ("stage",)
# zero_optimization keys the port does not run yet: (JAX's default, item)
_UNPORTED_ZERO: Dict[str, Any] = {}
# reference keys JAX accepts and deliberately ignores (config.py:1100)
_PASSTHROUGH_TOP = {
    "zero_allow_untested_optimizer", "zero_force_ds_cpu_optimizer", "communication_data_type",
    "sparse_gradients", "amp", "autotuning", "pipeline", "weight_quantization",
    "checkpoint_engine",
}
# legacy ZeRO keys JAX accepts and ignores (bucket sizes, overlap flags)
_PASSTHROUGH_ZERO = {
    "allgather_partitions", "overlap_comm", "reduce_scatter", "contiguous_gradients",
    "sub_group_size", "stage3_max_live_parameters", "stage3_prefetch_bucket_size",
    "reduce_bucket_size", "round_robin_gradients",
}


def _coerce(cls, value):
    """A dataclass from a dict, recursing into dataclass fields and raising
    on unknown keys."""
    if value is None:
        return cls()
    if dataclasses.is_dataclass(value):
        return value
    if not isinstance(value, dict):
        raise ConfigError(f"expected dict for {cls.__name__}, got {type(value)}")
    names = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in value.items():
        if k not in names:
            raise ConfigError(f"unknown config key '{k}' for {cls.__name__}")
        f = names[k]
        if f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
            probe = f.default_factory()  # type: ignore[misc]
            if dataclasses.is_dataclass(probe) and isinstance(v, dict):
                v = _coerce(type(probe), v)
        kwargs[k] = v
    return cls(**kwargs)


@dataclass
class ZeroConfig:
    """JAX's ``ZeroConfig`` (config.py:57) for the keys the port runs.

    Offload targets: None, ``"cpu"`` (the fp32 masters and the optimizer's
    moments in pinned host memory, streamed through the card each step) or,
    for the optimizer, ``"nvme"`` (masters and moments in swap files under
    ``offload_nvme_path``, updated by the host AdamW).  ``offload_param:
    "cpu"`` selects the CPU tier too: the fp32 masters are this design's
    one persistent parameter copy.  ``offload_pipeline`` (NVMe only)
    overlaps step k's host walk with step k+1's gradients (the delayed
    parameter update); ``offload_grad_dtype`` is the type the gradients
    travel to the host in."""

    stage: int = 0
    param_persistence_threshold: int = 10_000
    stage3_param_persistence_threshold: Optional[int] = None
    # ZeRO++ (runtime/zeropp.py): int8 weight gather (qwZ), int8 gradient
    # reduce (qgZ) with LoCo's error feedback, the hpZ secondary partition
    # and MiCS shard groups, JAX's keys and defaults
    zero_quantized_weights: bool = False
    zero_quantized_gradients: bool = False
    zeropp_loco_param: Optional[Dict[str, Any]] = None
    zero_hpz_partition_size: int = 1
    mics_shard_size: int = -1
    offload_optimizer: Any = None
    offload_param: Any = None
    offload_nvme_path: str = "/tmp/deepspeed_tpu_nvme"
    offload_pipeline: bool = False
    offload_grad_dtype: str = "fp32"

    def __post_init__(self):
        if not 0 <= self.stage <= 3:
            raise ConfigError(f"zero_optimization.stage must be 0-3, got {self.stage}")
        if self.stage3_param_persistence_threshold is not None:
            self.param_persistence_threshold = self.stage3_param_persistence_threshold
        for k in ("offload_optimizer", "offload_param"):
            v = getattr(self, k)
            if isinstance(v, dict):  # the reference nests {"device": "cpu", ...}
                if v.get("nvme_path"):
                    self.offload_nvme_path = v["nvme_path"]
                if k == "offload_optimizer" and (
                        v.get("pipeline") or v.get("pipeline_read") or v.get("pipeline_write")):
                    self.offload_pipeline = True
                setattr(self, k, v.get("device"))
        if self.offload_optimizer not in (None, "none", "cpu", "nvme"):
            raise ConfigError(f"bad offload_optimizer {self.offload_optimizer}")
        if self.offload_param not in (None, "none", "cpu"):
            raise ConfigError(
                f"bad offload_param {self.offload_param!r} (supported: cpu; "
                "params-to-nvme has no TPU implementation yet)")
        if self.offload_optimizer == "none":
            self.offload_optimizer = None
        if self.offload_param == "none":
            self.offload_param = None
        if self.offload_grad_dtype not in ("fp32", "bf16"):
            raise ConfigError(
                f"offload_grad_dtype must be fp32|bf16, got {self.offload_grad_dtype!r}")
        if self.offload_pipeline and self.offload_optimizer != "nvme":
            raise ConfigError(
                "offload_optimizer pipeline/pipeline_read/pipeline_write is "
                "implemented for device='nvme' only (the CPU tier's step is "
                "a single fused jit with nothing to overlap)")

    @property
    def offload_nvme(self) -> bool:
        """The NVMe tier is on."""
        return self.offload_optimizer == "nvme"

    @property
    def offload_cpu(self) -> bool:
        """The CPU tier is on (JAX ``wants_cpu_offload``, runtime/zero.py:128)."""
        return not self.offload_nvme and "cpu" in (self.offload_optimizer, self.offload_param)


@dataclass
class AIOConfig:
    """JAX's ``AIOConfig`` (config.py:958; the reference's
    ``runtime/swap_tensor/aio_config.py``): ``thread_count`` and
    ``queue_depth`` reach the async I/O engine behind the NVMe tier.
    ``block_size``, ``single_submit`` and ``overlap_events`` are libaio
    knobs with no counterpart in the thread pool, accepted for the
    reference's configs."""

    block_size: int = 1 << 20
    queue_depth: int = 32
    thread_count: int = 8
    single_submit: bool = False
    overlap_events: bool = True


@dataclass
class TrainDataConfig:
    """``prefetch_depth``: global batches copied to the device ahead of the
    step (0: ``train_on_loader`` runs synchronously).  ``async_metrics``:
    keep step metrics on the device until a ``steps_per_print`` boundary or
    an explicit ``get_last_loss``."""

    prefetch_depth: int = 2
    async_metrics: bool = True

    def __post_init__(self):
        if not 0 <= self.prefetch_depth <= 64:
            raise ConfigError(
                f"train_data.prefetch_depth must be in [0, 64], got {self.prefetch_depth}")


@dataclass
class PrecisionConfig:
    enabled: bool = False
    loss_scale: float = 0.0  # 0 -> dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    min_loss_scale: float = 1.0
    consecutive_hysteresis: bool = False
    auto_cast: bool = False


@dataclass
class OptimizerConfig:
    type: str = "adamw"
    params: Dict[str, Any] = field(default_factory=dict)


@dataclass
class SchedulerConfig:
    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)


@dataclass
class CheckpointConfig:
    """``async_save``: the async checkpoint engine (``checkpoint/engine.py``);
    the other two are accepted and change nothing, as in JAX."""

    use_node_local_storage: bool = False
    load_universal: bool = False
    async_save: bool = False


@dataclass
class NebulaConfig:
    """The reference's async checkpoint service: ``enabled`` selects the
    async checkpoint engine (JAX ``parse_config``); the rest is accepted."""

    enabled: bool = False
    persistent_storage_path: Optional[str] = None
    persistent_time_interval: int = 100
    num_of_version_in_retention: int = 2
    enable_nebula_load: bool = True
    load_path: Optional[str] = None


@dataclass
class ActivationCheckpointingConfig:
    """Accepted and never read, as in JAX (the model's ``remat`` is the
    switch)."""

    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False
    policy: str = "nothing_saveable"


@dataclass
class SparseAttentionConfig:
    """``sparse_attention``: mode ``""`` (absent) is off; the other modes
    name the layouts of ``ops/sparse_attention.py`` (JAX
    ``SparseAttentionConfig``, with its errors)."""

    mode: str = ""
    block: int = 16
    different_layout_per_head: bool = False
    # fixed
    num_local_blocks: int = 4
    num_global_blocks: int = 1
    # bigbird
    num_random_blocks: int = 1
    num_sliding_window_blocks: int = 3
    # bsLongformer
    global_block_indices: List[int] = field(default_factory=lambda: [0])
    # variable
    local_window_blocks: List[int] = field(default_factory=lambda: [4])

    def __post_init__(self):
        if self.mode not in ("", "dense", "fixed", "bigbird", "bsLongformer", "variable"):
            raise ConfigError(
                f"sparse_attention.mode '{self.mode}' not in "
                "dense|fixed|bigbird|bsLongformer|variable")
        if self.different_layout_per_head:
            raise ConfigError(
                "sparse_attention.different_layout_per_head is not supported: "
                "all heads share one block layout here")
        if self.block < 1:
            raise ConfigError(f"sparse_attention.block must be >= 1, got {self.block}")
        if any(w < 1 for w in self.local_window_blocks):
            raise ConfigError(
                f"sparse_attention.local_window_blocks must be positive, got "
                f"{self.local_window_blocks}")

    def build(self):
        """The layout object of this mode."""
        from ..ops.sparse_attention import (
            BigBirdSparsityConfig,
            BSLongformerSparsityConfig,
            DenseSparsityConfig,
            FixedSparsityConfig,
            VariableSparsityConfig,
        )

        if self.mode in ("", "dense"):
            return DenseSparsityConfig(block=self.block)
        if self.mode == "fixed":
            return FixedSparsityConfig(block=self.block, num_local_blocks=self.num_local_blocks,
                                       num_global_blocks=self.num_global_blocks)
        if self.mode == "bigbird":
            return BigBirdSparsityConfig(
                block=self.block, num_random_blocks=self.num_random_blocks,
                num_sliding_window_blocks=self.num_sliding_window_blocks,
                num_global_blocks=self.num_global_blocks)
        if self.mode == "bsLongformer":
            return BSLongformerSparsityConfig(
                block=self.block, num_sliding_window_blocks=self.num_sliding_window_blocks,
                global_block_indices=tuple(self.global_block_indices))
        return VariableSparsityConfig(block=self.block,
                                      local_window_blocks=tuple(self.local_window_blocks),
                                      num_global_blocks=self.num_global_blocks)


@dataclass
class MoEConfig:
    """``moe`` (JAX ``MoEConfig``): parsed with JAX's fields and defaults;
    nothing reads it, as in JAX (the model's ``moe_*`` fields are the
    switch).  An expert mesh axis above 1 stays refused with ``mesh``."""

    enabled: bool = False
    num_experts: int = 1
    top_k: int = 2
    capacity_factor: float = 1.0
    eval_capacity_factor: float = 1.0
    min_capacity: int = 4
    drop_tokens: bool = True
    aux_loss_coef: float = 0.01


@dataclass
class MonitorSubConfig:
    """One monitor section (``tensorboard``, ``csv_monitor``, ``wandb``,
    ``comet``; JAX's ``MonitorSubConfig``)."""

    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedTpuJob"
    # wandb extras
    team: Optional[str] = None
    group: Optional[str] = None
    project: Optional[str] = None
    # comet extras (reference monitor/config.py CometConfig)
    api_key: Optional[str] = None
    workspace: Optional[str] = None
    experiment_name: Optional[str] = None
    experiment_key: Optional[str] = None
    online: Optional[bool] = None
    mode: Optional[str] = None
    samples_log_interval: int = 100


@dataclass
class FlopsProfilerConfig:
    """``flops_profiler`` (JAX's ``FlopsProfilerConfig``): the engine counts
    step ``profile_step`` and writes the report to ``output_file`` (the log
    when None)."""

    enabled: bool = False
    profile_step: int = 1
    module_depth: int = -1
    top_modules: int = 1
    detailed: bool = True
    output_file: Optional[str] = None


@dataclass
class DataEfficiencyConfig:
    """``data_efficiency`` (JAX's): ``curriculum_learning`` is the
    ``data.CurriculumScheduler`` config plus ``enabled``,
    ``curriculum_type`` and ``data_analysis_path``."""

    enabled: bool = False
    curriculum_learning: Dict[str, Any] = field(default_factory=dict)


@dataclass
class PLDConfig:
    """``progressive_layer_drop`` (JAX's ``PLDConfig``)."""

    enabled: bool = False
    theta: float = 0.5
    gamma: float = 0.001


@dataclass
class CompressionConfig:
    """``compression_training`` (JAX's ``CompressionConfig``): each technique
    block in the reference's schema (``compression/compress.py``)."""

    enabled: bool = False
    weight_quantization: Dict[str, Any] = field(default_factory=dict)
    activation_quantization: Dict[str, Any] = field(default_factory=dict)
    sparse_pruning: Dict[str, Any] = field(default_factory=dict)
    row_pruning: Dict[str, Any] = field(default_factory=dict)
    head_pruning: Dict[str, Any] = field(default_factory=dict)
    channel_pruning: Dict[str, Any] = field(default_factory=dict)
    layer_reduction: Dict[str, Any] = field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in (
            "weight_quantization", "activation_quantization", "sparse_pruning", "row_pruning",
            "head_pruning", "channel_pruning", "layer_reduction")}

    @property
    def any_technique(self) -> bool:
        return bool(self.weight_quantization or self.activation_quantization
                    or self.sparse_pruning or self.row_pruning or self.head_pruning
                    or self.channel_pruning)


@dataclass
class EigenvalueConfig:
    """``eigenvalue`` (JAX's ``EigenvalueConfig``): the engine's
    power-iteration curvature estimate every ``gas_boundary_resolution``
    steps (``runtime/eigenvalue.py``)."""

    enabled: bool = False
    verbose: bool = False
    max_iter: int = 100
    tol: float = 1e-2
    stability: float = 1e-6
    gas_boundary_resolution: int = 1
    layer_name: str = ""
    layer_num: int = 0

    def __post_init__(self):
        if self.gas_boundary_resolution < 1:
            raise ConfigError(
                f"eigenvalue.gas_boundary_resolution must be >= 1, got "
                f"{self.gas_boundary_resolution}")
        if self.max_iter < 1:
            raise ConfigError(f"eigenvalue.max_iter must be >= 1, got {self.max_iter}")


# torch.compile backends the compile section takes; "xla" is JAX's default
# and names no torch backend (eager, the hand-written kernels as they are)
COMPILE_BACKENDS = ("inductor", "aot_eager", "eager")
# modes / options whose compiled graphs replay as CUDA graphs: a replay skips
# the custom ops' Python bodies, so ``ops.kernels.LAUNCHES`` would not count
# the kernels it runs
_GRAPH_REPLAY = {"backend": ("cudagraphs",), "mode": ("reduce-overhead", "max-autotune"),
                 "options": ("triton.cudagraphs",)}


@dataclass
class CompileConfig:
    """JAX's ``CompileConfig`` (config.py:924), the reference's
    ``runtime/compiler.py`` knobs, read as ``torch.compile``'s.

    ``backend`` "xla" (JAX's default) runs eager, with the hand-written
    kernels; a torch backend (``COMPILE_BACKENDS``) compiles the engine's
    model loss when ``enabled`` and not ``disable``; ``kwargs`` go to
    ``torch.compile`` (``fullgraph``, ``dynamic``, ``mode``, ``options``).
    JAX jits whatever ``enabled`` says and ``disable`` alone turns it off.
    Refused with ``ConfigError`` at parse time: any other backend, a
    ``kwargs`` key ``torch.compile`` does not take, and a CUDA-graph replay
    (backend "cudagraphs", mode "reduce-overhead" / "max-autotune",
    ``options["triton.cudagraphs"]``), whose replays would run the kernels
    without counting them."""

    enabled: bool = True
    disable: bool = False
    backend: str = "xla"
    kwargs: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.backend in _GRAPH_REPLAY["backend"] or \
                self.kwargs.get("mode") in _GRAPH_REPLAY["mode"] or \
                any((self.kwargs.get("options") or {}).get(k) for k in _GRAPH_REPLAY["options"]):
            raise ConfigError(
                "compile: a CUDA-graph replay (backend 'cudagraphs', mode 'reduce-overhead' "
                "or 'max-autotune', options['triton.cudagraphs']) is refused: a replay skips "
                "the kernels' op bodies, which count their launches in ops.kernels.LAUNCHES")
        if self.backend != "xla" and self.backend not in COMPILE_BACKENDS:
            raise ConfigError(f"compile.backend {self.backend!r}: use 'xla' (eager) or one of "
                              f"{COMPILE_BACKENDS}")
        if not isinstance(self.kwargs, dict):
            raise ConfigError(f"compile.kwargs must be a dict, got {type(self.kwargs)}")
        import inspect

        import torch

        taken = set(inspect.signature(torch.compile).parameters) - {"model", "backend"}
        unknown = sorted(set(self.kwargs) - taken)
        if unknown:
            raise ConfigError(f"compile.kwargs {unknown}: torch.compile takes {sorted(taken)}")

    @property
    def compiles(self) -> bool:
        """Whether the engine compiles its model loss."""
        return self.backend != "xla" and self.enabled and not self.disable


@dataclass
class HybridEngineConfig:
    """``hybrid_engine`` (JAX's ``HybridEngineConfig``): ``max_out_tokens``
    caps a generate's length; ``inference_tp_size`` must stay 1;
    ``release_inference_cache`` / ``pin_parameters`` /
    ``tp_gather_partition_size`` are accepted and never read, as in JAX."""

    enabled: bool = False
    max_out_tokens: int = 512
    inference_tp_size: int = 1
    release_inference_cache: bool = False
    pin_parameters: bool = True
    tp_gather_partition_size: int = 8


@dataclass
class MeshConfig:
    """JAX's ``MeshConfig`` (config.py:727): axis sizes, 0 inferred
    (``initialize`` gives the leftover ranks to ``fsdp`` under ZeRO >= 1,
    else to ``data``).  A section that names ``model`` trains
    tensor-parallel over that axis in a process world, at any size, 1
    included (``model_given``, set by ``parse_config``; not a field, so the
    section still equals JAX's).  ``seq`` and ``expert`` shard the
    sequence and the experts across ranks (a named ``expert`` cuts the
    experts at any size, ``expert_given``); ``stage`` above 1 is refused at
    parse time (ROADMAP queue 1 item 7: pipeline parallelism)."""

    data: int = 0
    fsdp: int = 0
    model: int = 1
    seq: int = 1
    expert: int = 1
    stage: int = 1
    # class attributes, not fields: the section named the axis (its path
    # then runs at any size, 1 included)
    model_given = False
    expert_given = False


@dataclass
class TensorParallelConfig:
    """JAX's ``TensorParallelConfig`` (config.py:751): ``domino_chunks``
    batch chunks a layer runs one after another (``initialize`` sets it on
    the model's config).  The ``mesh.model`` size is the axis;
    ``enabled`` and ``tp_size`` are accepted and read by nothing, as in
    JAX."""

    enabled: bool = False
    tp_size: int = 1
    domino_chunks: int = 1

    def __post_init__(self):
        if self.domino_chunks < 1:
            raise ConfigError(f"tensor_parallel.domino_chunks must be >= 1, got "
                              f"{self.domino_chunks}")


@dataclass
class CommsLoggerConfig:
    """JAX's ``CommsLoggerConfig`` (config.py:696): ``enabled`` counts each
    collective and its bytes (``comm.comm.CommsLogger``); ``prof_all``,
    ``debug`` and ``prof_ops`` are the reference's keys, accepted."""

    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: List[str] = field(default_factory=list)


@dataclass
class Config:
    train_batch_size: Optional[int] = None
    train_micro_batch_size_per_gpu: Optional[int] = None
    gradient_accumulation_steps: Optional[int] = None
    steps_per_print: int = 10
    gradient_clipping: float = 0.0
    seed: int = 42
    zero_optimization: ZeroConfig = field(default_factory=ZeroConfig)
    bf16: PrecisionConfig = field(default_factory=lambda: PrecisionConfig(enabled=True))
    fp16: PrecisionConfig = field(default_factory=PrecisionConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    train_data: TrainDataConfig = field(default_factory=TrainDataConfig)
    sparse_attention: SparseAttentionConfig = field(default_factory=SparseAttentionConfig)
    telemetry: "TelemetryConfig" = field(default_factory=lambda: TelemetryConfig())
    serve: "ServeConfig" = field(default_factory=lambda: ServeConfig())
    serve_engine: "ServeEngineConfig" = field(default_factory=lambda: ServeEngineConfig())
    router: "RouterConfig" = field(default_factory=lambda: RouterConfig())
    autotune: "AutotuneConfig" = field(default_factory=lambda: AutotuneConfig())
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    moe: MoEConfig = field(default_factory=MoEConfig)
    nebula: NebulaConfig = field(default_factory=NebulaConfig)
    aio: AIOConfig = field(default_factory=AIOConfig)
    # accepted and never read, as in JAX
    prescale_gradients: bool = False
    dump_state: bool = False
    activation_checkpointing: ActivationCheckpointingConfig = field(
        default_factory=ActivationCheckpointingConfig)
    # the training step's instruments and schedules
    wall_clock_breakdown: bool = False
    memory_breakdown: bool = False
    flops_profiler: FlopsProfilerConfig = field(default_factory=FlopsProfilerConfig)
    data_efficiency: DataEfficiencyConfig = field(default_factory=DataEfficiencyConfig)
    tensorboard: MonitorSubConfig = field(default_factory=MonitorSubConfig)
    csv_monitor: MonitorSubConfig = field(default_factory=MonitorSubConfig)
    wandb: MonitorSubConfig = field(default_factory=MonitorSubConfig)
    comet: MonitorSubConfig = field(default_factory=MonitorSubConfig)
    progressive_layer_drop: PLDConfig = field(default_factory=PLDConfig)
    # the model-shaping sections
    compression_training: CompressionConfig = field(default_factory=CompressionConfig)
    eigenvalue: EigenvalueConfig = field(default_factory=EigenvalueConfig)
    hybrid_engine: HybridEngineConfig = field(default_factory=HybridEngineConfig)
    # JAX's dict (``elasticity.ElasticityConfig`` validates it in initialize)
    elasticity: Dict[str, Any] = field(default_factory=dict)
    compile: CompileConfig = field(default_factory=CompileConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    tensor_parallel: TensorParallelConfig = field(default_factory=TensorParallelConfig)
    comms_logger: CommsLoggerConfig = field(default_factory=CommsLoggerConfig)
    dp_world_size: int = 1  # derived by finalize

    @property
    def precision_dtype(self) -> str:
        if self.fp16.enabled:
            return "float16"
        if self.bf16.enabled:
            return "bfloat16"
        return "float32"

    def finalize(self, dp_world_size: int = 1) -> "Config":
        """Triangulate the batch-size triple against ``dp_world_size``
        (JAX ``Config.finalize``)."""
        self.dp_world_size = dp_world_size
        tb, mb, gas = (self.train_batch_size, self.train_micro_batch_size_per_gpu,
                       self.gradient_accumulation_steps)
        if tb is not None and mb is not None and gas is not None:
            if tb != mb * gas * dp_world_size:
                raise ConfigError(
                    f"batch invariant violated: {tb} != {mb} * {gas} * {dp_world_size}")
        elif tb is not None and mb is not None:
            if tb % (mb * dp_world_size):
                raise ConfigError(
                    f"train_batch_size {tb} not divisible by micro_batch*dp {mb * dp_world_size}")
            gas = tb // (mb * dp_world_size)
        elif tb is not None and gas is not None:
            if tb % (gas * dp_world_size):
                raise ConfigError(
                    f"train_batch_size {tb} not divisible by gas*dp {gas * dp_world_size}")
            mb = tb // (gas * dp_world_size)
        elif mb is not None:
            gas = gas if gas is not None else 1
            tb = mb * gas * dp_world_size
        elif gas is not None:
            mb = 1
            tb = mb * gas * dp_world_size
        elif tb is not None:
            gas = 1
            if tb % dp_world_size:
                raise ConfigError(f"train_batch_size {tb} not divisible by dp {dp_world_size}")
            mb = tb // dp_world_size
        else:
            mb, gas = 1, 1
            tb = dp_world_size
        self.train_batch_size, self.train_micro_batch_size_per_gpu = tb, mb
        self.gradient_accumulation_steps = gas
        if self.fp16.enabled and self.bf16.enabled:
            raise ConfigError("fp16 and bf16 cannot both be enabled")
        return self


@dataclass
class TelemetryConfig:
    """Unified-telemetry knobs (``telemetry/``: metrics registry, tick
    spans, per-request serve traces) — JAX's ``TelemetryConfig``
    (config.py:171), with its defaults and checks.

    ``enabled`` turns on histogram/span/trace recording; the engines'
    ``stats`` counters count either way.  ``jsonl_path`` appends structured
    events (per-request summaries) one JSON object per line.
    ``chrome_trace_path`` writes the span + request timeline as Chrome
    trace-event JSON on close/exit.  ``jax_profiler`` keeps JAX's key name:
    it wraps train / serve dispatches in a labelled
    ``torch.profiler.record_function`` (and NVTX) range.
    ``exact_quantiles`` is the raw sample count histograms retain before
    degrading to the log-bucket estimate; ``max_spans`` bounds the span
    ring buffer."""

    enabled: bool = False
    jsonl_path: Optional[str] = None
    chrome_trace_path: Optional[str] = None
    jax_profiler: bool = False
    exact_quantiles: int = 4096
    max_spans: int = 65536

    def __post_init__(self):
        if self.exact_quantiles < 0:
            raise ConfigError(
                f"telemetry.exact_quantiles must be >= 0, got {self.exact_quantiles}")
        if self.max_spans < 1:
            raise ConfigError(f"telemetry.max_spans must be >= 1, got {self.max_spans}")


_ITEM7 = "(ROADMAP queue 1 item 7)"


@dataclass
class AdaptationConfig:
    """Online-autotuning controller knobs (``autotuning/controller.py``) —
    JAX's ``AdaptationConfig`` (config.py:205), with its defaults and
    checks.

    The controller samples the live telemetry registry every ``epoch_s``
    seconds (windowed TTFT/TBT percentiles, spec accept-rate, queue depth,
    pool headroom) and retunes the live-tier knobs (``prefill_chunk``,
    ``kv_watermark``, ``spec_max_draft``, shed thresholds,
    ``decode_megastep``) through ``ServeScheduler.apply_knobs``.  Every
    retune opens ``guard_epochs`` A/B guard epochs: if the SLO percentile
    the change was meant to improve regresses by more than
    ``regress_tolerance`` (ratio), the change rolls back and the knob
    enters ``cooldown_epochs`` of cooldown.  Rebuild-tier knobs (tp /
    serve_replicas / weight quant / ``quant_comm``) are only PROPOSED, and
    only when the roofline-predicted win clears ``rebuild_hysteresis``;
    the engine's owner thread executes a rebuild, never the controller
    thread (and the port's engine refuses tp / serve_replicas /
    ``quant_comm`` until ROADMAP queue 1 item 7)."""

    enabled: bool = False
    epoch_s: float = 0.25
    min_window: int = 4  # min windowed samples before any decision
    guard_epochs: int = 2
    regress_tolerance: float = 1.15  # guard metric ratio that triggers rollback
    cooldown_epochs: int = 4
    rebuild_hysteresis: float = 1.25  # predicted-cost ratio gating a rebuild proposal
    allow_rebuild: bool = True
    # SLO targets the retune heuristics steer toward (None = throughput-only)
    ttft_slo_ms: Optional[float] = None
    tbt_slo_ms: Optional[float] = None
    max_decode_megastep: int = 8
    max_spec_draft: int = 8

    def __post_init__(self):
        # JAX's checks, with its texts (config.py:239-256)
        if self.epoch_s <= 0:
            raise ConfigError(f"adaptation.epoch_s must be positive, got {self.epoch_s}")
        for k in ("min_window", "guard_epochs", "cooldown_epochs",
                  "max_decode_megastep", "max_spec_draft"):
            if int(getattr(self, k)) < 1:
                raise ConfigError(f"adaptation.{k} must be >= 1, got {getattr(self, k)}")
        for k in ("regress_tolerance", "rebuild_hysteresis"):
            if getattr(self, k) < 1.0:
                raise ConfigError(
                    f"adaptation.{k} must be >= 1.0 (a ratio), got {getattr(self, k)}")
        for k in ("ttft_slo_ms", "tbt_slo_ms"):
            v = getattr(self, k)
            if v is not None and v <= 0:
                raise ConfigError(f"adaptation.{k} must be positive or None, got {v}")


@dataclass
class AutotuneConfig:
    """Autotuner knobs (``autotuning/``: the roofline-seeded config search)
    — JAX's ``AutotuneConfig`` (config.py:596), with its defaults and
    checks.  Consumed by the offline entry points
    (``autotuning.autotune_model`` / ``autotune_serving``), never by the
    runtime engine.

    ``mode`` picks the workload (``training`` | ``serving``); ``rungs``
    are the successive-halving budget fractions (ascending, final must be
    1.0 = the full trial workload); ``top_k`` is the rung-0 cohort size
    taken from the roofline ranking; ``eta`` the halving divisor;
    ``max_trials`` caps total measured runs.  ``artifacts_dir`` points the
    roofline calibration at a directory of records that name an NVIDIA
    card (``chip_smoke.py``'s JSON lines; None = the H100 defaults).
    ``leaderboard_path`` is where the per-trial JSON leaderboard lands."""

    enabled: bool = False
    mode: str = "serving"
    metric: str = "throughput"
    max_trials: int = 16
    top_k: int = 8
    eta: int = 2
    rungs: List[float] = field(default_factory=lambda: [0.25, 1.0])
    seed: int = 0
    artifacts_dir: Optional[str] = None
    leaderboard_path: Optional[str] = None

    def __post_init__(self):
        # JAX's checks, with its texts (config.py:622-637)
        if self.mode not in ("training", "serving"):
            raise ConfigError(f"autotune.mode must be training|serving, got {self.mode!r}")
        if self.metric not in ("throughput", "latency"):
            raise ConfigError(
                f"autotune.metric must be throughput|latency, got {self.metric!r}")
        if self.max_trials < 1 or self.top_k < 1:
            raise ConfigError("autotune.max_trials/top_k must be >= 1")
        if self.eta < 2:
            raise ConfigError(f"autotune.eta must be >= 2, got {self.eta}")
        if (not self.rungs or list(self.rungs) != sorted(self.rungs)
                or self.rungs[0] <= 0 or abs(self.rungs[-1] - 1.0) > 1e-9):
            raise ConfigError(f"autotune.rungs must ascend and end at 1.0, got {self.rungs}")


@dataclass
class ServeConfig:
    """The serving stack's config block (``InferenceEngineV2(serve=...)``,
    a ``ServeConfig`` or a dict) — JAX's ``ServeConfig``
    (``deepspeed_tpu/config/config.py:259``), with its defaults and checks.

    ``deadline_ms`` / ``ttft_deadline_ms``: default per-request end-to-end /
    first-token deadlines, checked at tick boundaries (None = none; a
    ``submit()`` may override per request).  ``max_retries``: bounded
    retries of a transiently failing dispatch before requests are failed;
    ``retry_backoff_ms`` is the exponential-backoff base.
    ``shed_queue_depth``: waiting-queue depth that flips the scheduler into
    shed mode (typed RETRY_LATER rejections, speculation off until the
    queue drains; None = never shed).  ``watchdog_tick_ms``: this many
    milliseconds per tick, ``watchdog_grace_ticks`` ticks in a row, also
    enters shed mode (None disables the watchdog).

    ``decode_megastep``: fuse up to this many decode-only scheduler ticks
    into ONE device-resident engine burst (``engine._decode_burst``: one
    host sync for the run of ticks; stop tokens and length caps are
    detected on the device, so the fused ticks stay token-identical to
    per-tick decode).  1 = off.  The scheduler collapses to per-tick
    whenever a tick has other work (waiting or prefilling requests, live
    speculation proposals) and clamps the fuse count to the nearest
    request deadline.

    ``adaptation``: the online autotuning controller's block
    (``AdaptationConfig``, a dict is coerced into one); off by default —
    ``enabled=False`` is token-identical to no controller.
    ``autotuning.attach_controller(engine)`` reads it.

    ``quant_comm`` / ``comm_tiles``: the transport of a tensor-parallel
    engine's row-parallel partial sums (``comm/qcomm.py``
    ``q_psum_tiled``); an engine without a model axis reads neither.
    ``fused_serving=False`` is refused as the engine's own argument is
    (item 7)."""

    deadline_ms: Optional[float] = None
    ttft_deadline_ms: Optional[float] = None
    max_retries: int = 3
    retry_backoff_ms: float = 20.0
    shed_queue_depth: Optional[int] = None
    watchdog_tick_ms: Optional[float] = None
    watchdog_grace_ticks: int = 3
    fused_serving: Optional[bool] = None
    quant_comm: str = "none"
    comm_tiles: int = 1
    decode_megastep: int = 1
    adaptation: AdaptationConfig = field(default_factory=AdaptationConfig)

    def __post_init__(self):
        if not isinstance(self.adaptation, AdaptationConfig):
            self.adaptation = _coerce(AdaptationConfig, self.adaptation)
        # JAX's checks, with its texts (config.py:319-349)
        if self.quant_comm not in ("none", "int8", "fp8"):
            raise ConfigError(
                f"serve.quant_comm must be one of 'none'|'int8'|'fp8', "
                f"got {self.quant_comm!r}")
        if self.comm_tiles < 1:
            raise ConfigError(f"serve.comm_tiles must be >= 1, got {self.comm_tiles}")
        if self.decode_megastep < 1:
            raise ConfigError(
                f"serve.decode_megastep must be >= 1, got {self.decode_megastep}")
        for k in ("deadline_ms", "ttft_deadline_ms", "watchdog_tick_ms"):
            v = getattr(self, k)
            if v is not None and v <= 0:
                raise ConfigError(f"serve.{k} must be positive or None, got {v}")
        if self.max_retries < 0:
            raise ConfigError(f"serve.max_retries must be >= 0, got {self.max_retries}")
        if self.retry_backoff_ms < 0:
            raise ConfigError(
                f"serve.retry_backoff_ms must be >= 0, got {self.retry_backoff_ms}")
        if self.shed_queue_depth is not None and self.shed_queue_depth < 1:
            raise ConfigError(
                f"serve.shed_queue_depth must be >= 1 or None, got {self.shed_queue_depth}")
        if self.watchdog_grace_ticks < 1:
            raise ConfigError(
                f"serve.watchdog_grace_ticks must be >= 1, got {self.watchdog_grace_ticks}")
        if self.fused_serving is False:
            raise NotImplementedError(f"serve.fused_serving=False is not ported yet {_ITEM7}")


@dataclass
class ServeEngineConfig:
    """The build-an-``InferenceEngineV2``-from-config seam — JAX's
    ``ServeEngineConfig`` (config.py:353), with its defaults and checks:
    one validated block of the engine's constructor surface, consumed by
    ``inference.engine_v2.build_serve_engine`` (and through it by every
    worker of ``serving.build_router``).

    ``seq_shards`` > 1 makes ``build_serve_engine`` bring up the one-card seq grid
    (``initialize_mesh(devices=[dev] * S, seq=S)``).  ``tp`` > 1 serves
    over the ``model`` axis of a process world (``build_serve_engine`` in
    each rank), with ``quant_comm`` / ``comm_tiles`` its transport.
    ``serve_replicas`` > 1 is not ported yet and raises
    ``NotImplementedError`` naming ROADMAP item 7."""

    max_seqs: int = 8
    num_blocks: int = 96
    block_size: int = 32
    max_seq_len: Optional[int] = None
    prefill_buckets: List[int] = field(default_factory=lambda: [64, 128, 256])
    prefill_budget: Optional[int] = None
    prefill_chunk: Optional[int] = None
    kv_watermark: float = 0.0625
    enable_prefix_caching: bool = False
    enable_speculation: bool = False
    spec_max_draft: int = 4
    quantize_weights: Optional[str] = None
    tp: int = 1
    serve_replicas: int = 1
    seq_shards: int = 1
    quant_comm: str = "none"
    comm_tiles: int = 1
    seed: int = 0

    def __post_init__(self):
        for k in ("max_seqs", "num_blocks", "block_size", "tp",
                  "serve_replicas", "seq_shards", "comm_tiles"):
            if int(getattr(self, k)) < 1:
                raise ConfigError(f"serve_engine.{k} must be >= 1, got "
                                  f"{getattr(self, k)}")
        if not 0.0 <= self.kv_watermark < 1.0:
            raise ConfigError(
                f"serve_engine.kv_watermark must be in [0, 1), got "
                f"{self.kv_watermark}")
        if self.quantize_weights not in (None, "int8", "fp8", "fp6"):
            raise ConfigError(
                f"serve_engine.quantize_weights must be None|int8|fp8|fp6, "
                f"got {self.quantize_weights!r}")
        if self.quant_comm not in ("none", "int8", "fp8"):
            raise ConfigError(
                f"serve_engine.quant_comm must be none|int8|fp8, got "
                f"{self.quant_comm!r}")
        if not self.prefill_buckets:
            raise ConfigError("serve_engine.prefill_buckets cannot be empty")
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ConfigError(
                f"serve_engine.prefill_chunk must be >= 1 or None, got "
                f"{self.prefill_chunk}")
        if self.serve_replicas > 1:
            raise NotImplementedError(
                f"serve_engine.serve_replicas={self.serve_replicas} is not ported yet {_ITEM7}")

    def engine_kwargs(self) -> Dict[str, Any]:
        """The ``InferenceEngineV2`` constructor kwargs this block encodes
        (``build_serve_engine`` makes the seq grid)."""
        return dict(
            max_seqs=self.max_seqs, num_blocks=self.num_blocks,
            block_size=self.block_size, max_seq_len=self.max_seq_len,
            prefill_buckets=tuple(self.prefill_buckets),
            prefill_budget=self.prefill_budget,
            prefill_chunk=self.prefill_chunk,
            kv_watermark=self.kv_watermark,
            enable_prefix_caching=self.enable_prefix_caching,
            enable_speculation=self.enable_speculation,
            spec_max_draft=max(self.spec_max_draft, 1),
            quantize_weights=self.quantize_weights,
            serve_replicas=self.serve_replicas,
            seq_shards=self.seq_shards,
            seed=self.seed,
            quant_comm=self.quant_comm,
            comm_tiles=self.comm_tiles,
        )


@dataclass
class RouterConfig:
    """Serve-front-end knobs (``serving/``: the request router over N
    engine workers) — JAX's ``RouterConfig`` (config.py:432), with its
    defaults and checks.  Consumed by ``serving.Router`` /
    ``serving.build_router``.

    ``n_workers``: engine workers the pool stamps out (each through
    ``build_serve_engine`` from one ``ServeEngineConfig``, in this
    process or, through ``serving.build_remote_router``, one subprocess
    each); ``prefill_workers``: the first K take the PREFILL role — long
    prompts land there and migrate to a decode worker at first token via
    the paged-KV handoff (0 disables disaggregation).
    ``disagg_threshold``: prompt length from which a request counts as long
    (None = the engine's prefill chunk).  ``handoff_fmt``: the handoff's
    wire format — 'none' ships pages in the cache dtype (token-exact),
    'int8' / 'fp8' quantize per ``comm.qcomm``'s per-chunk-scale codec.
    ``affinity``: prefix-affinity routing (``affinity_max_keys`` bounds
    its LRU map).  ``shed_queue_depth``: router backlog depth that sheds
    new submissions with typed RETRY_LATER (None = never).
    ``max_replays``: re-routes after a worker death before a request fails.
    ``retry_backoff_ms``: backoff when a worker rejects RETRY_LATER
    without a hint.  ``decode_megastep``: scheduler ticks each worker runs
    per router tick.  ``metrics_pull_interval_ms`` / ``pull_spans`` /
    ``slo_*``: the fleet collector's pacing and the SLO monitor.

    The transport knobs (``heartbeat_interval_ms``, ``lease_ms``,
    ``rpc_*``, ``connect_timeout_ms``, ``max_frame_bytes``) are read by
    the subprocess pools (``serving.remote``: the heartbeat monitor, each
    worker's RPC client and dials); in-process pools have no socket and
    ignore them."""

    n_workers: int = 2
    prefill_workers: int = 0
    disagg_threshold: Optional[int] = None
    handoff_fmt: str = "none"
    affinity: bool = True
    affinity_max_keys: int = 8192
    shed_queue_depth: Optional[int] = None
    max_replays: int = 3
    retry_backoff_ms: float = 20.0
    heartbeat_interval_ms: float = 50.0
    lease_ms: float = 1000.0
    rpc_deadline_ms: float = 120_000.0
    rpc_max_attempts: int = 5
    rpc_backoff_ms: float = 10.0
    rpc_backoff_max_ms: float = 250.0
    connect_timeout_ms: float = 30_000.0
    max_frame_bytes: int = 64 * 1024 * 1024
    decode_megastep: int = 1
    metrics_pull_interval_ms: Optional[float] = None
    pull_spans: bool = True
    slo_objective: float = 0.999
    slo_fast_window_s: float = 5.0
    slo_slow_window_s: float = 60.0

    def __post_init__(self):
        if self.n_workers < 1:
            raise ConfigError(
                f"router.n_workers must be >= 1, got {self.n_workers}")
        if not 0 <= self.prefill_workers < self.n_workers:
            raise ConfigError(
                f"router.prefill_workers must be in [0, n_workers), got "
                f"{self.prefill_workers} of {self.n_workers} (at least one "
                "decode-capable worker must remain)")
        if self.handoff_fmt not in ("none", "int8", "fp8"):
            raise ConfigError(
                f"router.handoff_fmt must be none|int8|fp8, got "
                f"{self.handoff_fmt!r}")
        if self.disagg_threshold is not None and self.disagg_threshold < 1:
            raise ConfigError(
                f"router.disagg_threshold must be >= 1 or None, got "
                f"{self.disagg_threshold}")
        if self.affinity_max_keys < 1:
            raise ConfigError(
                f"router.affinity_max_keys must be >= 1, got "
                f"{self.affinity_max_keys}")
        if self.shed_queue_depth is not None and self.shed_queue_depth < 1:
            raise ConfigError(
                f"router.shed_queue_depth must be >= 1 or None, got "
                f"{self.shed_queue_depth}")
        if self.max_replays < 0:
            raise ConfigError(
                f"router.max_replays must be >= 0, got {self.max_replays}")
        if self.retry_backoff_ms < 0:
            raise ConfigError(
                f"router.retry_backoff_ms must be >= 0, got "
                f"{self.retry_backoff_ms}")
        if self.heartbeat_interval_ms <= 0:
            raise ConfigError(
                f"router.heartbeat_interval_ms must be > 0, got "
                f"{self.heartbeat_interval_ms}")
        if self.lease_ms <= self.heartbeat_interval_ms:
            raise ConfigError(
                f"router.lease_ms ({self.lease_ms}) must exceed "
                f"heartbeat_interval_ms ({self.heartbeat_interval_ms}) — a "
                "lease shorter than one ping interval expires every healthy "
                "worker")
        if self.rpc_deadline_ms <= 0 or self.connect_timeout_ms <= 0:
            raise ConfigError(
                "router.rpc_deadline_ms and connect_timeout_ms must be > 0")
        if self.rpc_max_attempts < 1:
            raise ConfigError(
                f"router.rpc_max_attempts must be >= 1, got "
                f"{self.rpc_max_attempts}")
        if self.rpc_backoff_ms < 0 or self.rpc_backoff_max_ms < self.rpc_backoff_ms:
            raise ConfigError(
                "router rpc backoff must satisfy 0 <= rpc_backoff_ms <= "
                f"rpc_backoff_max_ms, got {self.rpc_backoff_ms}/"
                f"{self.rpc_backoff_max_ms}")
        if self.max_frame_bytes < 4096:
            raise ConfigError(
                f"router.max_frame_bytes must be >= 4096, got "
                f"{self.max_frame_bytes}")
        if self.decode_megastep < 1:
            raise ConfigError(
                f"router.decode_megastep must be >= 1, got "
                f"{self.decode_megastep}")
        if (self.metrics_pull_interval_ms is not None
                and self.metrics_pull_interval_ms <= 0):
            raise ConfigError(
                f"router.metrics_pull_interval_ms must be > 0 or None, got "
                f"{self.metrics_pull_interval_ms}")
        if not 0.0 < self.slo_objective < 1.0:
            raise ConfigError(
                f"router.slo_objective must be in (0, 1), got "
                f"{self.slo_objective}")
        if self.slo_fast_window_s <= 0 or self.slo_slow_window_s <= 0:
            raise ConfigError(
                "router.slo_fast_window_s and slo_slow_window_s must be > 0")
        if self.slo_slow_window_s < self.slo_fast_window_s:
            raise ConfigError(
                f"router.slo_slow_window_s ({self.slo_slow_window_s}) must "
                f"be >= slo_fast_window_s ({self.slo_fast_window_s})")


def _strip_auto(obj):
    """Drop ``"auto"`` values at every level (integration placeholders)."""
    if isinstance(obj, dict):
        return {k: _strip_auto(v) for k, v in obj.items() if v != AUTO}
    if isinstance(obj, list):
        return [_strip_auto(v) for v in obj if v != AUTO]
    return obj


def _refuse(name: str, item: int) -> None:
    raise NotImplementedError(
        f"config key '{name}' is not ported yet: the port runs it only at JAX's "
        f"default (ROADMAP queue 1 item {item})")


def _refuse_unported(raw: Dict[str, Any]) -> None:
    """Refuse each unported key whose value differs from JAX's default and
    drop the ones at it.  An unknown field of an unported section is a
    ``ConfigError`` naming JAX's dataclass, as JAX raises it."""
    for k in [k for k in raw if k in _UNPORTED_TOP]:
        default, item = _UNPORTED_TOP[k]
        value = raw.pop(k)
        if isinstance(default, tuple):
            cls_name, fields = default
            if not isinstance(value, dict):
                raise ConfigError(f"expected dict for {cls_name}, got {type(value)}")
            for f in value:
                if f not in fields:
                    raise ConfigError(f"unknown config key '{f}' for {cls_name}")
            if any(v != fields[f] for f, v in value.items()):
                _refuse(k, item)
        elif value != default:
            _refuse(k, item)
    mesh = raw.get("mesh")
    if isinstance(mesh, dict) and any(mesh.get(a, 1) not in (0, 1)
                                      for a in _UNPORTED_MESH_AXES):
        for f in mesh:  # an unknown field is JAX's ConfigError first
            if f not in MeshConfig.__dataclass_fields__:
                raise ConfigError(f"unknown config key '{f}' for MeshConfig")
        _refuse("mesh", 7)
    zero = raw.get("zero_optimization")
    if isinstance(zero, dict):
        for k in list(zero):
            if k in _UNPORTED_ZERO:
                default, item = _UNPORTED_ZERO[k]
                if zero.pop(k) != default:
                    _refuse(f"zero_optimization.{k}", item)
            elif k in _PASSTHROUGH_ZERO:
                zero.pop(k)


def parse_config(source: Any, dp_world_size: Optional[int] = None) -> Config:
    """A dict / JSON string / path -> ``Config``.  ``dp_world_size`` None
    leaves the batch triangulation to the engine."""
    if source is None:
        raw: Dict[str, Any] = {}
    elif isinstance(source, Config):
        return source
    elif isinstance(source, dict):
        raw = copy.deepcopy(source)
    elif isinstance(source, str):
        if source.strip().startswith("{"):
            raw = json.loads(source)
        else:
            with open(source) as fh:
                raw = json.load(fh)
    else:
        raise ConfigError(f"cannot parse config from {type(source)}")
    for k in _PASSTHROUGH_TOP & set(raw):
        raw.pop(k)
    # the legacy top-level curriculum (the reference's
    # curriculum_learning_legacy) maps onto data_efficiency, as in JAX's
    # parse_config; the modern section wins when both are present
    if "curriculum_learning" in raw:
        legacy = raw.pop("curriculum_learning")
        if "data_efficiency" not in raw:
            raw["data_efficiency"] = {"enabled": bool(legacy.get("enabled", False)),
                                      "curriculum_learning": legacy}
    raw = _strip_auto(raw)
    _refuse_unported(raw)
    cfg = _coerce(Config, raw)
    if isinstance(raw.get("mesh"), dict):
        for ax in ("model", "expert"):
            if ax in raw["mesh"]:
                setattr(cfg.mesh, ax + "_given", True)
    if cfg.nebula.enabled:
        # nebula is an async checkpoint service: the async engine (JAX)
        cfg.checkpoint.async_save = True
    if dp_world_size is not None:
        cfg.finalize(dp_world_size)
    return cfg
