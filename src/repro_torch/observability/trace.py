"""Per-request lifecycle tracing (DESIGN.md §8).

Every served request accumulates timestamped lifecycle *events*
(``submit`` → ``admit`` → ``prefill`` →
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

Engine-level work is recorded as a tree of *step spans* (``Tracer.span``):
each has an id, its parent's id, a name, start and end on
``time.perf_counter_ns`` and attributes, and lives in a bounded ring.  A
clock anchor (a ``perf_counter_ns``/``time_ns`` pair read together) maps
them onto the Unix clock that ``torch.profiler`` stamps device events on.

``chrome_trace`` renders traces as Chrome ``trace_event`` JSON (one
thread per request, ``X`` complete events per span, instants for
spill/restore and other non-boundary events; the step spans on tid 0 with
their ``id`` and ``parent``) loadable in chrome://tracing or Perfetto.
"""
from __future__ import annotations

import itertools
import json
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, Iterable, List, Optional, Tuple

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


# one step span: (id, parent id or None, name, t0_ns, t1_ns, attributes)
SpanRecord = Tuple[int, Optional[int], str, int, int, dict]

# step spans a Tracer keeps: the newest, in a ring
MAX_SPANS = 65_536


def clock_anchor() -> Tuple[int, int]:
    """A ``(perf_counter_ns, time_ns)`` pair read together: the
    ``perf_counter_ns`` reading is the midpoint of two that bracket the
    ``time_ns`` one.  A reading ``t`` maps onto the Unix clock as
    ``t - perf_counter_ns + time_ns``."""
    p0 = time.perf_counter_ns()
    unix = time.time_ns()
    p1 = time.perf_counter_ns()
    return (p0 + p1) // 2, unix


def self_ns(spans: Iterable[SpanRecord]) -> Dict[int, int]:
    """Each span's self time: its duration less what its children cover
    (children lie inside their parent, so it is never negative)."""
    spans = list(spans)
    out = {sid: t1 - t0 for sid, _, _, t0, t1, _ in spans}
    for _, parent, _, t0, t1, _ in spans:
        if parent in out:
            out[parent] -= t1 - t0
    return out


class _OpenSpan:
    """Context manager of one open step span (``Tracer.span``)."""

    __slots__ = ("tracer", "sid", "parent", "name", "attrs", "add_to", "t0")

    def __init__(self, tracer, sid, parent, name, attrs, add_to):
        self.tracer, self.sid, self.parent = tracer, sid, parent
        self.name, self.attrs, self.add_to = name, attrs, add_to

    def __enter__(self) -> int:
        self.tracer._open.append(self)
        self.t0 = time.perf_counter_ns()
        return self.sid

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        tr = self.tracer
        tr._open.pop()
        tr.spans.append((self.sid, self.parent, self.name, self.t0, t1,
                         self.attrs))
        if self.add_to is not None:
            self.add_to.inc(t1 - self.t0)
        return False


class Tracer:
    """Collects ``RequestTrace``s plus a tree of engine-level step spans.

    ``clock`` supplies timestamps when an event does not bring its own —
    ``time.perf_counter`` for real execution, the simulator's modeled
    ``now`` for discrete-event runs.  ``max_traces`` bounds memory for
    long-lived servers: the oldest finished traces are dropped first.
    Step spans are always on ``time.perf_counter_ns``; the newest
    ``MAX_SPANS`` are kept.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 max_traces: int = 10_000):
        self.clock = clock
        self.max_traces = max_traces
        self.traces: Dict[int, RequestTrace] = {}
        self.spans: Deque[SpanRecord] = deque(maxlen=MAX_SPANS)
        self._open: List[_OpenSpan] = []  # innermost last
        self._span_ids = itertools.count(1)
        self.anchor = clock_anchor()
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

    def span(self, name: str, parent: Optional[int] = None, *,
             add_to=None, **attrs) -> _OpenSpan:
        """``with tracer.span(name, **attrs) as sid:`` records a step span
        around the block.  ``parent`` defaults to the innermost span open
        on this tracer (none: a root).  ``add_to`` (a metrics ``Counter``)
        gains the span's duration in ns when it closes."""
        if parent is None and self._open:
            parent = self._open[-1].sid
        return _OpenSpan(self, next(self._span_ids), parent, name, attrs,
                         add_to)

    def note(self, sid: int, **attrs) -> None:
        """Add attributes to the open span ``sid`` (known only once its
        work has run, such as how many requests a step finished)."""
        for sp in reversed(self._open):
            if sp.sid == sid:
                sp.attrs.update(attrs)
                return
        raise KeyError(f"span {sid} is not open")

    def _evict_finished(self) -> None:
        victims = [rid for rid, tr in self.traces.items()
                   if tr.last_t("finish") is not None]
        for rid in victims[: max(1, len(victims) // 2)]:
            del self.traces[rid]

    def clear(self) -> None:
        self.traces.clear()
        self.spans.clear()
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
    the engine's step-span track, each ``X`` event with its ``id`` and
    ``parent`` in ``args``), ``X`` complete events for spans, ``i``
    instants for non-boundary lifecycle events.  ``otherData`` holds the
    timeline's zero on ``perf_counter_ns`` and two clock anchors (from the
    tracer's construction and from now): Unix ns of a ``ts`` is
    ``ts * 1e3 + ts_zero_perf_counter_ns - perf_counter_ns + time_ns``,
    the clock ``torch.profiler`` stamps device events on."""
    starts = [s[3] * 1e-9 for s in tracer.spans]
    if tracer._t0 is not None:
        starts.append(tracer._t0)
    t0 = min(starts, default=0.0)
    ev: List[dict] = [
        {"ph": "M", "pid": 1, "tid": 0, "name": "thread_name",
         "args": {"name": "engine"}},
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "serving"}},
    ]
    for sid, parent, name, s0, s1, attrs in tracer.spans:
        ev.append({"ph": "X", "pid": 1, "tid": 0, "name": name,
                   "cat": "engine", "ts": _us(s0 * 1e-9, t0),
                   "dur": (s1 - s0) * 1e-3,
                   "args": {"id": sid, "parent": parent, **attrs}})
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
    anchors = [tracer.anchor, clock_anchor()]
    return {"traceEvents": ev, "displayTimeUnit": "ms",
            "otherData": {
                "ts_zero_perf_counter_ns": round(t0 * 1e9),
                "clock_anchors": [{"perf_counter_ns": p, "time_ns": u}
                                  for p, u in anchors]}}


def write_chrome_trace(tracer: Tracer, path: str) -> None:
    tracer.write_chrome_trace(path)
