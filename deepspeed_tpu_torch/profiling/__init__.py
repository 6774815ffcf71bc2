"""Profiling: the flops profiler and the executed step's count (JAX
``deepspeed_tpu/profiling``)."""
from .flops_profiler import (  # noqa: F401
    FlopsProfiler,
    ModuleProfile,
    analyze_train_step,
    duration_to_string,
    executed_analysis,
    flops_to_string,
    get_model_profile,
    macs_to_string,
    model_tree,
    number_to_string,
    params_to_string,
)
