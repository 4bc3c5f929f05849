"""Per-request lifecycle tracing (DESIGN.md §8).

Every served request accumulates timestamped lifecycle *events*
(``submit`` → ``admit`` → ``prefill`` → per-step ``decode_step`` →
``preempt``/``spill``/``readmit`` → ``finish``); contiguous phase *spans*
are derived from the boundary events, so by construction the span chain
covers submit → finish with no gaps:

    queued    submit  -> admit
    prefill   admit   -> prefill        (``run`` when nothing prefills,
                                         e.g. gen_len=0 completions)
    decode    prefill -> preempt | finish
    preempted preempt -> readmit
    decode    readmit -> preempt | finish   (repeats per preemption)

Timestamps come from the ``Tracer``'s clock: wall ``time.perf_counter``
for the real engine, modeled ``Simulation.now`` for the discrete-event
plane — the same span algebra serves both.

``chrome_trace`` renders traces as Chrome ``trace_event`` JSON (one
thread per request, ``X`` complete events per span, instants for
spill/restore/decode steps) loadable in chrome://tracing or Perfetto.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

# events that end one phase span and start the next
BOUNDARY_EVENTS = ("submit", "admit", "prefill", "preempt", "readmit",
                   "finish")


@dataclass
class Span:
    name: str
    t0: float
    t1: float

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


@dataclass
class RequestTrace:
    """Event log for one request.  ``events`` is append-only and time
    ordered (the tracer stamps each append with its clock)."""
    rid: int
    app: str = ""
    events: List[Tuple[str, float, dict]] = field(default_factory=list)

    def event(self, name: str, t: float, **meta) -> None:
        self.events.append((name, t, meta))

    def first_t(self, name: str) -> Optional[float]:
        for n, t, _ in self.events:
            if n == name:
                return t
        return None

    def last_t(self, name: str) -> Optional[float]:
        for n, t, _ in reversed(self.events):
            if n == name:
                return t
        return None

    def count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.events if n == name)

    # -- derived phase spans --------------------------------------------------

    def spans(self) -> List[Span]:
        """Contiguous phase spans from the boundary events (module
        docstring); an unfinished request yields spans up to its latest
        boundary."""
        bounds = [(n, t) for n, t, _ in self.events if n in BOUNDARY_EVENTS]
        out: List[Span] = []
        prefilled = self.first_t("prefill") is not None
        for (name, t0), (nxt, t1) in zip(bounds, bounds[1:]):
            if name == "submit":
                phase = "queued"
            elif name == "admit":
                phase = "prefill" if prefilled else "run"
            elif name in ("prefill", "readmit"):
                phase = "decode"
            elif name == "preempt":
                phase = "preempted"
            else:  # a boundary after finish never happens; be safe
                phase = name
            out.append(Span(phase, t0, t1))
        return out

    def to_dict(self) -> dict:
        """JSON-ready form carried in ``ServeResult.info["trace"]``."""
        return {
            "rid": self.rid,
            "app": self.app,
            "events": [{"name": n, "t": t, **({"meta": m} if m else {})}
                       for n, t, m in self.events],
            "spans": [{"name": s.name, "t0": s.t0, "t1": s.t1}
                      for s in self.spans()],
        }


class Tracer:
    """Collects ``RequestTrace``s plus a global (engine-level) span track.

    ``clock`` supplies timestamps when an event does not bring its own —
    ``time.perf_counter`` for real execution, the simulator's modeled
    ``now`` for discrete-event runs.  ``max_traces`` bounds memory for
    long-lived servers: the oldest finished traces are dropped first.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 max_traces: int = 10_000):
        self.clock = clock
        self.max_traces = max_traces
        self.traces: Dict[int, RequestTrace] = {}
        self.global_spans: List[Tuple[str, float, float, dict]] = []
        self._t0: Optional[float] = None  # epoch of the trace timeline

    def trace(self, rid: int, app: str = "") -> RequestTrace:
        tr = self.traces.get(rid)
        if tr is None:
            tr = self.traces[rid] = RequestTrace(rid=rid, app=app)
            if len(self.traces) > self.max_traces:
                self._evict_finished()
        if app and not tr.app:
            tr.app = app
        return tr

    def event(self, rid: int, name: str, t: Optional[float] = None,
              app: str = "", **meta) -> float:
        if t is None:
            t = self.clock()
        if self._t0 is None:
            self._t0 = t
        self.trace(rid, app).event(name, t, **meta)
        return t

    def global_span(self, name: str, t0: float, t1: float, **meta) -> None:
        if self._t0 is None:
            self._t0 = t0
        self.global_spans.append((name, t0, t1, meta))
        if len(self.global_spans) > self.max_traces:
            del self.global_spans[: len(self.global_spans) // 2]

    def _evict_finished(self) -> None:
        victims = [rid for rid, tr in self.traces.items()
                   if tr.last_t("finish") is not None]
        for rid in victims[: max(1, len(victims) // 2)]:
            del self.traces[rid]

    def clear(self) -> None:
        self.traces.clear()
        self.global_spans.clear()
        self._t0 = None

    # -- export ---------------------------------------------------------------

    def chrome_events(self) -> List[dict]:
        return chrome_trace(self)["traceEvents"]

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(chrome_trace(self), f)


def _us(t: float, t0: float) -> float:
    return (t - t0) * 1e6


def chrome_trace(tracer: Tracer) -> dict:
    """Chrome ``trace_event`` JSON: pid 1, one tid per request (tid 0 is
    the engine's own step track), ``X`` complete events for spans,
    ``i`` instants for non-boundary lifecycle events."""
    t0 = tracer._t0 or 0.0
    ev: List[dict] = [
        {"ph": "M", "pid": 1, "tid": 0, "name": "thread_name",
         "args": {"name": "engine"}},
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "serving"}},
    ]
    for name, s0, s1, meta in tracer.global_spans:
        ev.append({"ph": "X", "pid": 1, "tid": 0, "name": name, "cat": "engine",
                   "ts": _us(s0, t0), "dur": max(_us(s1, t0) - _us(s0, t0), 0.0),
                   "args": meta})
    for rid, tr in sorted(tracer.traces.items()):
        tid = rid + 1  # tid 0 is the engine track
        label = f"rid {rid}" + (f" ({tr.app})" if tr.app else "")
        ev.append({"ph": "M", "pid": 1, "tid": tid, "name": "thread_name",
                   "args": {"name": label}})
        for s in tr.spans():
            ev.append({"ph": "X", "pid": 1, "tid": tid, "name": s.name,
                       "cat": "request", "ts": _us(s.t0, t0),
                       "dur": max(_us(s.t1, t0) - _us(s.t0, t0), 0.0),
                       "args": {"app": tr.app}})
        for name, t, meta in tr.events:
            if name in BOUNDARY_EVENTS:
                continue  # already covered by the span chain
            ev.append({"ph": "i", "pid": 1, "tid": tid, "name": name,
                       "cat": "request", "ts": _us(t, t0), "s": "t",
                       "args": meta})
    return {"traceEvents": ev, "displayTimeUnit": "ms"}


def write_chrome_trace(tracer: Tracer, path: str) -> None:
    tracer.write_chrome_trace(path)
