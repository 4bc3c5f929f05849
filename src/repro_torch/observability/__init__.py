"""Tracing + metrics subsystem for the serving planes (DESIGN.md §8).

Two halves, both shared by the real-execution ``BlockEngine`` and the
discrete-event ``Simulation``:

- ``trace``: per-request lifecycle event logs (submit → admit → prefill →
  preempt/spill/readmit → finish) with derived phase spans, the engine
  step's span tree on one clock with its Unix-clock anchor, and Chrome
  ``trace_event`` export for chrome://tracing;
- ``metrics``: a typed registry of counters / gauges / histograms that
  replaces the ad-hoc ``stats`` dicts, so discrete-event and real runs
  emit comparable reports.

The port's step spans.  Unlike the reference, the port records no
per-request ``decode_step`` instants (the ``decode`` phase span is
unchanged) and no flat ``engine_step`` track.  Each ``BlockEngine.step``
is a root ``engine.step`` span (step no., active, finished) with the
children ``engine.admit`` (the scheduler's admission; a recompute or
unfused prefill nests inside it), ``executor.prefill`` (one per (chain,
bucket) call or per ``prefill()``: app, B, bucket, rids, tokens,
padded), ``executor.retire`` (groups synced), ``engine.finish`` (n) and
one ``executor.megastep`` per group call (app, B, spec).  An
``executor.wait`` span (what) sits inside whichever of them blocks the
host on the device.  The engine's counters add the spans up:
``dispatch_ns`` (megasteps), ``host_wait_ns`` (waits), ``prefill_ns``,
and ``prefill_tokens`` / ``prefill_padded_tokens`` (real and bucketed
prompt positions).  The waits are nested, so their time is also in the
megastep or prefill span around them.  ``Tracer.anchor`` and the Chrome
export's ``otherData.clock_anchors`` map the spans'
``perf_counter_ns`` onto the Unix clock that ``torch.profiler`` stamps
device events on (``kineto_results.trace_start_ns()`` plus each event's
offset), with no guess at launch latency.
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
