"""Monitors: TensorBoard / CSV / WandB / Comet (JAX ``deepspeed_tpu/monitor``)."""
from .monitor import (  # noqa: F401
    CometMonitor,
    CsvMonitor,
    Monitor,
    MonitorMaster,
    TensorBoardMonitor,
    WandbMonitor,
)
