"""Config: one JSON / dict tree -> validated dataclasses — counterpart of
``deepspeed_tpu/config/config.py`` (``parse_config`` :1134), for the keys
the training path reads:

- ``train_batch_size``, ``train_micro_batch_size_per_gpu``,
  ``gradient_accumulation_steps`` (any two determine the third; all three
  must satisfy ``train = micro * gas * dp``);
- ``optimizer``, ``scheduler``, ``bf16``, ``fp16``, ``gradient_clipping``,
  ``steps_per_print``, ``seed``, ``train_data.prefetch_depth`` /
  ``async_metrics``;
- ``sparse_attention`` (the block-sparse layout ``initialize`` wires into
  the model);
- ``zero_optimization.stage`` 0-3 and ``param_persistence_threshold``.
  The port runs on one GPU, where, as on the JAX package's one-device mesh,
  every ZeRO stage keeps the whole state on the one device: the stage is
  validated and changes no number.

``ServeConfig`` is the serving engine's block (``InferenceEngineV2(serve=
...)``), not a training key: ``decode_megastep`` runs, the rest of JAX's
fields are refused until their items land.

An unknown key raises ``ConfigError`` naming it, as in JAX.  A key the JAX
package knows but the port does not run yet (offload, ZeRO++ quantization,
compression, progressive layer drop, eigenvalue, curriculum, elasticity,
monitors, ...) raises ``NotImplementedError`` naming it.  The reference keys
JAX accepts and ignores are accepted and ignored here too.
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


# top-level keys of the JAX Config the port does not run yet
_UNPORTED_TOP = {
    "prescale_gradients", "wall_clock_breakdown", "memory_breakdown", "dump_state", "mesh",
    "moe", "tensor_parallel", "comms_logger", "flops_profiler", "activation_checkpointing",
    "checkpoint", "compression_training", "data_efficiency", "curriculum_learning",
    "tensorboard", "csv_monitor", "wandb", "comet", "elasticity", "progressive_layer_drop",
    "eigenvalue", "compile", "hybrid_engine", "aio", "nebula",
    "telemetry", "autotune", "serve", "serve_engine", "router", "adaptation",
}
# zero_optimization keys the port does not run yet
_UNPORTED_ZERO = {
    "offload_optimizer", "offload_param", "offload_nvme_path", "offload_pipeline",
    "offload_grad_dtype", "zero_quantized_weights", "zero_quantized_gradients",
    "zeropp_loco_param", "zero_hpz_partition_size", "mics_shard_size",
}
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
    stage: int = 0
    param_persistence_threshold: int = 10_000
    stage3_param_persistence_threshold: Optional[int] = None

    def __post_init__(self):
        if not 0 <= self.stage <= 3:
            raise ConfigError(f"zero_optimization.stage must be 0-3, got {self.stage}")
        if self.stage3_param_persistence_threshold is not None:
            self.param_persistence_threshold = self.stage3_param_persistence_threshold


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


# ServeConfig fields of the JAX package that the port does not run yet, with
# the ROADMAP queue 1 item that brings each
_SERVE_UNPORTED = {
    "deadline_ms": 6, "ttft_deadline_ms": 6, "max_retries": 6, "retry_backoff_ms": 6,
    "shed_queue_depth": 6, "watchdog_tick_ms": 6, "watchdog_grace_ticks": 6,
    "quant_comm": 7, "comm_tiles": 7,
}


@dataclass
class ServeConfig:
    """The serving stack's config block (``InferenceEngineV2(serve=...)``,
    a ``ServeConfig`` or a dict) — counterpart of JAX's ``ServeConfig``
    (``deepspeed_tpu/config/config.py:259``), with its defaults and checks.

    ``decode_megastep``: fuse up to this many decode-only scheduler ticks
    into ONE device-resident engine burst (``engine._decode_burst``: one
    host sync for the run of ticks; stop tokens and length caps are
    detected on the device, so the fused ticks stay token-identical to
    per-tick decode).  1 = off.  The scheduler collapses to per-tick
    whenever a tick has other work (waiting or prefilling requests, live
    speculation proposals).

    The other fields are JAX's and are not ported yet: each raises
    ``NotImplementedError`` naming its ROADMAP item when set away from its
    default (deadlines, retries, shed mode, the watchdog and ``adaptation``:
    item 6; ``quant_comm`` / ``comm_tiles``: item 7).  ``fused_serving=False``
    is refused as the engine's own argument is."""

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
    adaptation: Optional[Dict[str, Any]] = None

    def __post_init__(self):
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
        defaults = ServeConfig.__dataclass_fields__
        for k, item in _SERVE_UNPORTED.items():
            if getattr(self, k) != defaults[k].default:
                raise NotImplementedError(
                    f"serve.{k} is not ported yet (ROADMAP queue 1 item {item})")
        if self.fused_serving is False:
            raise NotImplementedError(
                "serve.fused_serving=False is not ported yet (ROADMAP queue 1 item 7)")
        a = self.adaptation
        if a is not None and (not isinstance(a, dict)
                              or any(k != "enabled" or v for k, v in a.items())):
            raise NotImplementedError(
                "serve.adaptation (the online autotuning controller) is not ported yet "
                "(ROADMAP queue 1 item 6)")


def _strip_auto(obj):
    """Drop ``"auto"`` values at every level (integration placeholders)."""
    if isinstance(obj, dict):
        return {k: _strip_auto(v) for k, v in obj.items() if v != AUTO}
    if isinstance(obj, list):
        return [_strip_auto(v) for v in obj if v != AUTO]
    return obj


def _refuse_unported(raw: Dict[str, Any]) -> None:
    for k in raw:
        if k in _UNPORTED_TOP:
            raise NotImplementedError(
                f"config key '{k}' is not ported yet (ROADMAP queue 1 items 6-9)")
    zero = raw.get("zero_optimization")
    if isinstance(zero, dict):
        for k in list(zero):
            if k in _UNPORTED_ZERO:
                raise NotImplementedError(
                    f"config key 'zero_optimization.{k}' is not ported yet "
                    "(ROADMAP queue 1 items 7, 9)")
            if k in _PASSTHROUGH_ZERO:
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
    _refuse_unported(raw)
    cfg = _coerce(Config, _strip_auto(raw))
    if dp_world_size is not None:
        cfg.finalize(dp_world_size)
    return cfg
