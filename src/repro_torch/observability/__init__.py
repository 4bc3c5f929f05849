"""Tracing + metrics subsystem for the serving planes (DESIGN.md §8).

Two halves, both shared by the real-execution ``BlockEngine`` and the
discrete-event ``Simulation``:

- ``trace``: per-request lifecycle event logs (submit → admit → prefill →
  per-step decode → preempt/spill/readmit → finish) with derived phase
  spans and Chrome ``trace_event`` export for chrome://tracing;
- ``metrics``: a typed registry of counters / gauges / histograms that
  replaces the ad-hoc ``stats`` dicts, so discrete-event and real runs
  emit comparable reports.
"""
from repro_torch.observability.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    merged_snapshot,
    percentiles_of,
)
from repro_torch.observability.trace import (
    RequestTrace,
    Span,
    Tracer,
    chrome_trace,
    write_chrome_trace,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "RequestTrace", "Span", "Tracer", "chrome_trace", "write_chrome_trace",
    "merged_snapshot", "percentiles_of",
]
