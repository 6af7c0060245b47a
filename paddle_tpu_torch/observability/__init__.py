"""paddle_tpu_torch.observability — unified telemetry for training +
serving (the port of ``paddle_tpu/observability``).

One registry, every signal: serving metrics (``serving.metrics``
re-bases its Counter/Histogram onto this package), the trace guard's
fires (``analysis.TraceGuard``) and training-step telemetry
(``StepMeter``, fed by ``jit.CompiledTrainStep``) all publish into one
process-wide :class:`MetricsRegistry`. Readouts:

- :func:`prometheus_text` / ``registry.snapshot()`` — Prometheus text
  exposition + JSON, both derivable at any moment;
- :func:`start_metrics_server` — stdlib-only HTTP ``/metrics`` +
  ``/metrics.json`` + ``/flight`` endpoint on a daemon thread;
- :class:`FlightRecorder` — a bounded ring of the last K step records
  that dumps a JSON diagnostic bundle on an uncaught exception, from
  the NaN hook's slot, or on demand;
- :mod:`tracing` — request spans with W3C ``traceparent`` propagation;
- :mod:`slo` — SLO classes, attainment and burn-rate alerts.

Everything is host-side Python: observing never touches the device, and
lazy gauge values (device-scalar losses) only materialize on scrape.
The multihost merge (``merge_snapshots``, ``merged_report``,
``tagged_snapshot``) waits with the distributed port (``ROADMAP.md``
queue A item 6).
"""
from __future__ import annotations

from .exporter import (
    MetricsServer,
    parse_prometheus_text,
    prometheus_text,
    start_metrics_server,
)
from .flight_recorder import (
    FlightRecorder,
    get_flight_recorder,
    set_flight_recorder,
)
from .registry import (
    COUNT_BUCKETS,
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
)
from .slo import (
    DEFAULT_CLASS,
    BurnRateRule,
    SLOClass,
    SLOMonitor,
    SLORegistry,
    UnknownSLOClassError,
    attainment_report,
    default_burn_rules,
    default_classes,
    get_slo_registry,
    set_slo_registry,
    within_budget,
)
from .step_meter import (
    StepMeter,
    analytic_flops_per_token,
    analytic_param_count,
    batch_geometry,
    configure_training,
    device_memory_stats,
    get_step_meter,
    peak_flops_per_device,
    set_step_meter,
)
from .timeseries import TimeSeriesRing
from .tracing import (
    Span,
    SpanBuffer,
    SpanContext,
    Tracer,
    chrome_trace,
    export_chrome,
    format_traceparent,
    get_tracer,
    parse_traceparent,
    remote_child_span,
    set_process_name,
    set_tracer,
    stitch,
    trace_payload,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "DEFAULT_BUCKETS", "COUNT_BUCKETS",
    "prometheus_text", "parse_prometheus_text", "MetricsServer",
    "start_metrics_server",
    "StepMeter", "get_step_meter", "set_step_meter",
    "configure_training", "analytic_flops_per_token",
    "analytic_param_count", "peak_flops_per_device",
    "device_memory_stats", "batch_geometry",
    "FlightRecorder", "get_flight_recorder", "set_flight_recorder",
    "TimeSeriesRing",
    "SLOClass", "SLORegistry", "SLOMonitor", "BurnRateRule",
    "UnknownSLOClassError", "DEFAULT_CLASS",
    "get_slo_registry", "set_slo_registry", "default_classes",
    "default_burn_rules", "attainment_report", "within_budget",
    "Span", "SpanBuffer", "SpanContext", "Tracer",
    "get_tracer", "set_tracer", "set_process_name",
    "parse_traceparent", "format_traceparent", "remote_child_span",
    "stitch", "chrome_trace", "export_chrome", "trace_payload",
]
