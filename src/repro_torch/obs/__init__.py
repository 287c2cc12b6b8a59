"""Serve observability: metrics registry, span tracing, flight
recorder, exporters.

The serving stack always runs its counters/histograms through a
`MetricsRegistry` (the per-component `stats()` dicts are bit-compatible
views over it).  Span tracing and the flight recorder are opt-in —
construct an `Observability` bundle with `Observability.enabled()` and
hand it to `ServeScheduler(obs=...)` / `ServeRouter(obs=...)`; every
tracing seam is gated on `obs.tracer is not None`, so the default
(metrics-only) path stays bit-identical to a build without this
package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.obs.export import (
    TraceSchemaError,
    iter_trace_records,
    prometheus_text,
    validate_trace_jsonl,
    write_prometheus,
    write_trace_jsonl,
)
from repro_torch.obs.metrics import (
    COUNTER,
    GAUGE,
    HISTOGRAM,
    LATENCY_QUANTILES,
    Counter,
    Family,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.trace import Span, SpanTracer, Trace

__all__ = [
    "COUNTER",
    "GAUGE",
    "HISTOGRAM",
    "LATENCY_QUANTILES",
    "Counter",
    "Family",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Observability",
    "Span",
    "SpanTracer",
    "Trace",
    "TraceSchemaError",
    "iter_trace_records",
    "prometheus_text",
    "validate_trace_jsonl",
    "write_prometheus",
    "write_trace_jsonl",
]


@dataclass
class Observability:
    """One bundle the serving components share: a registry (always), a
    tracer and flight recorder (optional).  A router passes the same
    bundle into its worker schedulers so one registry/tracer covers the
    whole pool and cross-worker traces (failover replay) land in one
    tree."""

    registry: MetricsRegistry = field(default_factory=MetricsRegistry)
    tracer: SpanTracer | None = None
    recorder: FlightRecorder | None = None

    @classmethod
    def metrics_only(cls) -> "Observability":
        """Registry only — the default wiring; zero tracing overhead."""
        return cls()

    @classmethod
    def enabled(cls, max_finished: int = None, capacity: int = None,
                sink=None) -> "Observability":
        """Full stack: registry + tracer + flight recorder."""
        tkw = {} if max_finished is None else {"max_finished": max_finished}
        rkw = {"sink": sink}
        if capacity is not None:
            rkw["capacity"] = capacity
        return cls(tracer=SpanTracer(**tkw),
                   recorder=FlightRecorder(**rkw))
