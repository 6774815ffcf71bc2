"""Unified telemetry — the port of ``deepspeed_tpu/telemetry``: metrics
registry, tick spans, per-request traces, the fleet plane.

- ``registry.py`` — thread-safe counters/gauges/histograms (log-spaced
  buckets + exact small-count quantiles), ``snapshot()`` ->
  ``(label, value, step)`` events, JSONL sink, ``StatsView`` compat mapping
  backing the engines' ``stats`` dicts.  A copy of JAX's (pure Python).
- ``tracing.py`` — ``TraceRecorder`` dispatch spans with deferred device
  readings (CUDA events), ``RequestTrace`` serve-request lifecycles (TTFT /
  TBT / queue wait / accept rate), Chrome trace-event export
  (Perfetto-loadable), the ``Telemetry`` facade with its optional profiler
  step annotation.
- ``fleet.py`` — the fleet observability plane: ``FleetRegistry`` merges
  per-worker registry snapshots, ``SloMonitor`` computes availability and
  multi-window burn rates over the router's terminal counters,
  ``FleetCollector`` pulls workers on a paced thread, and
  ``fleet_chrome_trace`` stitches every worker's spans onto one timeline.
  A copy of JAX's (pure Python).
"""
from .registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    RateView,
    StatsView,
    format_percentile_table,
    percentile_summary,
    window_percentile_summary,
)
from .tracing import (  # noqa: F401
    NULL_REQUEST_TRACE,
    NULL_SPAN,
    RequestTrace,
    Span,
    Telemetry,
    TraceRecorder,
    device_ready,
)
from .fleet import (  # noqa: F401
    FleetCollector,
    FleetRegistry,
    SloMonitor,
    attach_fleet_collector,
    fleet_chrome_trace,
)
