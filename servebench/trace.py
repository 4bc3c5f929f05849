"""The traced run's device timeline: ``torch.profiler`` over a slice of
the window (device activity only), reduced to the operations that ran on
the device, their busy time as a union of intervals, the idle gaps
between them, and what the host was doing in each gap (host spans the
benchmark wraps around the program's layers for the traced run only)."""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

Interval = Tuple[float, float]


def merge(intervals: Sequence[Interval]) -> List[Interval]:
    """Sorted, disjoint union of closed intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def union_length(intervals: Sequence[Interval]) -> float:
    return sum(b - a for a, b in merge(intervals))


def idle_gaps(intervals: Sequence[Interval], lo: float, hi: float
              ) -> List[Interval]:
    """The stretches of [lo, hi] that no interval covers."""
    gaps, t = [], lo
    for a, b in merge(intervals):
        if a > t:
            gaps.append((t, min(a, hi)))
        t = max(t, b)
    if t < hi:
        gaps.append((t, hi))
    return [(a, b) for a, b in gaps if b > a]


def label_at(spans: Sequence[Tuple[str, float, float]], t: float) -> str:
    """The innermost (shortest) host span holding time ``t``."""
    best, best_len = "harness", float("inf")
    for name, a, b in spans:
        if a <= t <= b and b - a < best_len:
            best, best_len = name, b - a
    return best


class DeviceTracer:
    """Starts and stops the profiler at step boundaries; the serving
    path's host spans are wrapped in between."""

    def __init__(self, wraps):
        self.wraps = wraps      # [(object, method name, span name)]
        self.spans: List[Tuple[str, float, float]] = []
        self.events: List[Tuple[str, float, float]] = []
        self._saved = []

    def _wrap(self):
        for obj, attr, name in self.wraps:
            fn = getattr(obj, attr)
            self._saved.append((obj, attr))

            def timed(*a, _fn=fn, _name=name, **k):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    self.spans.append((_name, t0, time.perf_counter()))
            setattr(obj, attr, timed)

    def prime(self):
        """Start and stop the profiler once in set-up: its first start
        loads and initialises the tracing library, which takes seconds
        and must not fall into the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self._wrap()
        torch.cuda.synchronize()
        self.t_start = time.perf_counter()

    def stop(self):
        import torch
        from torch.autograd import DeviceType
        torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        for obj, attr in self._saved:
            delattr(obj, attr)  # the class's method shows through again
        self._saved = []
        self.prof.stop()
        self.events = [(ev.name, ev.time_range.start * 1e-6,
                        ev.time_range.end * 1e-6)
                       for ev in self.prof.events()
                       if ev.device_type == DeviceType.CUDA]
        self.prof = None

    def summary(self, top: int = 10) -> dict:
        """Busy and window seconds, device time by operation name, the
        longest idle gaps by host span, and the kernel events on the host's
        clock (aligned at the first host span's start)."""
        window = self.t_stop - self.t_start
        if not self.events:
            return {"busy_s": 0.0, "window_s": window, "device_ops": [],
                    "idle_gaps": [], "kernels": []}
        first = min(a for _, a, _ in self.events)
        spans = sorted(self.spans, key=lambda s: s[1])
        # host time = device time + offset: the first operation follows the
        # first wrapped call's start by its launch latency, taken as 0
        offset = (spans[0][1] if spans else self.t_start) - first
        kernels = [(n, a + offset, b + offset) for n, a, b in self.events]
        ivs = [(max(a, self.t_start), min(b, self.t_stop))
               for _, a, b in kernels]
        busy = union_length([iv for iv in ivs if iv[1] > iv[0]])
        by_name: Dict[str, float] = defaultdict(float)
        for n, a, b in kernels:
            by_name[n] += b - a
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps_by: Dict[str, float] = defaultdict(float)
        for a, b in idle_gaps(ivs, self.t_start, self.t_stop):
            gaps_by[label_at(spans, (a + b) / 2)] += b - a
        gaps = sorted(gaps_by.items(), key=lambda kv: -kv[1])[:top]
        return {"busy_s": busy, "window_s": window,
                "device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps],
                "kernels": kernels}
