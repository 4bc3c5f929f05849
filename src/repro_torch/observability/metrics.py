"""Typed metrics registry (DESIGN.md §8).

Replaces the serving layers' ad-hoc ``stats`` dicts with three metric
types sharing one registry:

- ``Counter``: monotonically increasing int (decode tokens, group calls,
  host syncs, spills ...);
- ``Gauge``: last-write-wins level (KV pool used/free pages per
  signature, waiting-queue depth, in-flight requests);
- ``Histogram``: value distribution with exact count/sum and a bounded
  reservoir for percentiles (per-block batch occupancy, queue wait,
  TTFT, step wall time).

Hot-path cost is one dict lookup avoided by holding the typed handle
(``c = registry.counter("x")`` once, ``c.inc()`` per event), so the
instrumented decode loop stays within the benchmark regression gate.

``registry.counters_view()`` is a read-only Mapping over counter values —
the engine exposes it as ``engine.stats`` so every pre-existing consumer
(tests, benchmarks, examples) keeps working unchanged.
"""
from __future__ import annotations

import json
import random
from typing import Dict, Iterator, List, Mapping, Optional


class Counter:
    """Monotonic counter.  ``inc`` is the only mutator."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins level."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Distribution with exact count/sum/min/max and reservoir-sampled
    percentiles (the reservoir keeps count/sum exact while bounding
    memory for long-lived engines)."""

    __slots__ = ("name", "count", "total", "min", "max", "_values",
                 "_reservoir", "_rng")

    def __init__(self, name: str, reservoir: int = 65536, seed: int = 0):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._reservoir = reservoir
        self._values: List[float] = []
        self._rng = random.Random(seed)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if len(self._values) < self._reservoir:
            self._values.append(v)
        else:  # reservoir sampling keeps a uniform subsample
            j = self._rng.randrange(self.count)
            if j < self._reservoir:
                self._values[j] = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """q in [0, 100]; nearest-rank over the reservoir."""
        if not self._values:
            return 0.0
        vals = sorted(self._values)
        idx = min(len(vals) - 1, max(0, round(q / 100.0 * (len(vals) - 1))))
        return vals[idx]

    def summary(self) -> dict:
        if not self.count:
            return {"count": 0, "sum": 0.0, "mean": 0.0, "min": 0.0,
                    "max": 0.0, "p50": 0.0, "p95": 0.0}
        return {"count": self.count, "sum": self.total, "mean": self.mean,
                "min": self.min, "max": self.max,
                "p50": self.percentile(50), "p95": self.percentile(95)}


class _CountersView(Mapping):
    """Read-only live Mapping over counter values (legacy ``stats`` dict
    shape: ``dict(view)``, ``view[k]``, iteration all work)."""

    def __init__(self, counters: Dict[str, Counter]):
        self._counters = counters

    def __getitem__(self, name: str) -> int:
        return self._counters[name].value

    def __iter__(self) -> Iterator[str]:
        return iter(self._counters)

    def __len__(self) -> int:
        return len(self._counters)

    def __repr__(self) -> str:
        return repr(dict(self))


class MetricsRegistry:
    """One namespace of typed metrics; handles are created on first use."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    # -- handle accessors (hold these on hot paths) --------------------------

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name)
        return h

    # -- one-shot conveniences ----------------------------------------------

    def inc(self, name: str, n: int = 1) -> None:
        self.counter(name).inc(n)

    def set_gauge(self, name: str, v: float) -> None:
        self.gauge(name).set(v)

    def observe(self, name: str, v: float) -> None:
        self.histogram(name).observe(v)

    def counters_view(self) -> _CountersView:
        return _CountersView(self._counters)

    # -- reporting ------------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-ready report: counters as ints, gauges as floats,
        histograms as count/sum/mean/min/max/p50/p95 summaries."""
        return {
            "counters": {n: c.value for n, c in sorted(self._counters.items())},
            "gauges": {n: g.value for n, g in sorted(self._gauges.items())},
            "histograms": {n: h.summary()
                           for n, h in sorted(self._histograms.items())},
        }

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)


def percentiles_of(values, qs=(50, 95)) -> Dict[int, float]:
    """Nearest-rank percentiles of a raw value list (shared by report
    builders that aggregate per-request fields outside a Histogram)."""
    out: Dict[int, float] = {}
    vals = sorted(float(v) for v in values)
    for q in qs:
        if not vals:
            out[q] = 0.0
        else:
            idx = min(len(vals) - 1, max(0, round(q / 100.0 * (len(vals) - 1))))
            out[q] = vals[idx]
    return out


def merged_snapshot(*regs: Optional[MetricsRegistry]) -> dict:
    """Union of several registries' snapshots (later ones win on clash)."""
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    for r in regs:
        if r is None:
            continue
        snap = r.snapshot()
        for k in out:
            out[k].update(snap[k])
    return out
