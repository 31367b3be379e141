"""Unified observability: metrics registry, span tracing, exporters.

Apex's value is *measurable* performance; this package is the layer
that makes it measurable in-process instead of via log grep:

- :mod:`apex_tpu_torch.obs.metrics` — thread-safe process-local registry of
  ``Counter`` / ``Gauge`` / ``Histogram`` (fixed log-spaced latency
  buckets, labeled series) with Prometheus text exposition and atomic
  JSON file export.
- :mod:`apex_tpu_torch.obs.trace` — nestable context-manager spans on the
  monotonic clock (contextvars parent linkage, per-thread safe)
  exported as Chrome/Perfetto trace-event JSON, plus an opt-in
  ``torch.profiler`` start/stop hook for profiling a stall on demand.
- :mod:`apex_tpu_torch.obs.bridge` — the sink
  :func:`apex_tpu_torch._logging.emit_event` fans out to, so every existing
  structured event (checkpoint saved/rejected, retry attempt/exhausted,
  replica desync, serving queued/first-token/finished, batch skipped)
  automatically increments a counter and stamps the active span — zero
  call-site churn.  Installed on import.
- :mod:`apex_tpu_torch.obs.request_trace` — a second event sink that folds
  the serving event stream into **per-request lifecycle records**
  (queued → admitted → prefill chunks → first token → decode →
  finished, with exact phase durations and prefix/speculation
  annotations), exported as one-track-per-request Perfetto traces and
  JSONL.  Default-off: no recorder installed ⇒ nothing runs.  Fleet
  runs add replica hop trails, per-replica timeline lanes, and
  health/rollout bands to the same export.
- :mod:`apex_tpu_torch.obs.alerts` — a deterministic alert engine over
  registry snapshots: threshold / absence / multi-window SLO burn-rate
  rules with for-duration hysteresis, evaluated at the fleet step
  boundary on the serving clock, with a bit-reproducible
  firing→resolved ledger.  Default-off: no engine ⇒ no events.
- :mod:`apex_tpu_torch.obs.slo` — SLO percentile reports over those records:
  nearest-rank p50/p95/p99 TTFT / TPOT / queue-wait from exact
  samples, goodput against per-request deadlines, cross-checked
  against the live histograms' bucket-interpolated
  :meth:`~apex_tpu_torch.obs.metrics.Histogram.quantile` estimates.

This is the port of :mod:`apex_tpu.obs`: the same names, metrics,
events and exports.  The port's serving scheduler, engine, load
generator and fault injectors publish into the default registry; the
JAX package's resilience supervisor, checkpoint manager and pipeline
timers do too, and their port twins will when those slices land (the
bridge already declares every metric they set).  The JAX package's
``docs/api/observability.md`` documents the metric inventory and naming
conventions.  With no exporter attached the per-update overhead is a
lock + dict write (``chip_smoke.py``'s ``phase3-serving-obs-cost`` line
prints it on the card).
"""

from apex_tpu_torch.obs import alerts, bridge, metrics, request_trace, slo, trace
from apex_tpu_torch.obs.alerts import (
    AbsenceRule,
    AlertEngine,
    BurnRateRule,
    Condition,
    Selector,
    ThresholdRule,
)
from apex_tpu_torch.obs.metrics import (
    LATENCY_BUCKETS_S,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    REGISTRY,
    counter,
    declare_scope,
    gauge,
    histogram,
    prometheus_text,
    snapshot,
    write_json,
)
from apex_tpu_torch.obs.request_trace import (
    RequestRecord,
    RequestTraceRecorder,
    recording_requests,
)
from apex_tpu_torch.obs.slo import (
    SLOReport,
    build_report,
    crosscheck_quantiles,
    percentile,
    summarize,
)
from apex_tpu_torch.obs.trace import (
    Span,
    TraceRecorder,
    current_span,
    install_recorder,
    profile_on_stall,
    recording,
    span,
    start_torch_profiler,
    stop_torch_profiler,
    uninstall_recorder,
)

__all__ = [
    "AbsenceRule",
    "AlertEngine",
    "BurnRateRule",
    "Condition",
    "LATENCY_BUCKETS_S",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "RequestRecord",
    "RequestTraceRecorder",
    "SLOReport",
    "Selector",
    "Span",
    "ThresholdRule",
    "TraceRecorder",
    "alerts",
    "bridge",
    "build_report",
    "counter",
    "crosscheck_quantiles",
    "current_span",
    "declare_scope",
    "gauge",
    "histogram",
    "install_recorder",
    "metrics",
    "percentile",
    "profile_on_stall",
    "prometheus_text",
    "recording",
    "recording_requests",
    "request_trace",
    "slo",
    "snapshot",
    "span",
    "start_torch_profiler",
    "stop_torch_profiler",
    "summarize",
    "trace",
    "uninstall_recorder",
    "write_json",
]

# events start feeding the registry the moment any instrumented
# subsystem imports obs; emit_event log output is byte-identical either way
bridge.install()
