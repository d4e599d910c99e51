"""repro_torch.telemetry: the observability plane over the epoch loop
(counterpart of ``repro.telemetry``).

TurboKV's switches are monitoring stations (paper §5.1).  This package
answers *why was this query in the p999* and *which pipeline stage burns
the time*:

    trace.py       device-built sampled span tables (no PRNG drawn:
                   tracing on or off gives the same metric stream)
    attribution.py exact latency decomposition into
                   {queue, inflation, bounce, retry_backoff, service}
    export.py      Chrome-trace / JSONL span-tree exports
    profiler.py    pipeline stage timers, the H100 peaks, the route
                   kernels' byte counts and roofline rows
    flight.py      ring-buffer flight recorder with postmortem dumps
    recorder.py    the per-run host accumulator the driver feeds
    metrics.py     the fleet metrics plane: a (window, n_series) ring on
                   the device, written by the device step
    slo.py         declarative SLOs + multi-window burn-rate alerts
    incident.py    one-command postmortem artifacts
    dashboard.py   terminal sparkline view over a persisted ring

Enable with ``ClusterConfig(telemetry=TelemetryConfig(...))`` and
``ClusterConfig(metrics=MetricsConfig(...))``; the driver then exposes
``EpochDriver.telemetry`` and ``EpochDriver.metrics``.
"""

from repro_torch.telemetry.attribution import (
    BUCKETS,
    decompose,
    reconstruct,
    tail_attribution,
)
from repro_torch.telemetry.export import (
    chrome_trace,
    link_retries,
    span_tree,
    write_jsonl,
)
from repro_torch.telemetry.flight import FlightRecorder
from repro_torch.telemetry import incident
from repro_torch.telemetry.metrics import (
    MetricsConfig,
    MetricsState,
    build_layout,
    series_view,
    to_openmetrics,
)
from repro_torch.telemetry.slo import SLO, AlertEngine
from repro_torch.telemetry.profiler import (
    StageTimers,
    fmt_roofline_md,
    kernel_roofline_rows,
)
from repro_torch.telemetry.recorder import TelemetryRecorder
from repro_torch.telemetry.trace import (
    SF,
    SI,
    SPAN_F_FIELDS,
    SPAN_I_FIELDS,
    TelemetryConfig,
    collect_spans,
    rate_threshold,
    sample_mask,
)

__all__ = [
    "TelemetryConfig", "TelemetryRecorder",
    "SPAN_I_FIELDS", "SPAN_F_FIELDS", "SI", "SF",
    "collect_spans", "sample_mask", "rate_threshold",
    "BUCKETS", "decompose", "reconstruct", "tail_attribution",
    "chrome_trace", "link_retries", "span_tree", "write_jsonl",
    "StageTimers", "kernel_roofline_rows", "fmt_roofline_md",
    "FlightRecorder",
    "MetricsConfig", "MetricsState", "build_layout", "series_view",
    "to_openmetrics", "SLO", "AlertEngine", "incident",
]
