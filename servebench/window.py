"""End-to-end arithmetic over a run's record: every request due in the
window and every token delivered in it, never a median of chunks.

A request's record holds its due time and the delivery time of each of
its tokens (the end of the step that made it, after a device
synchronise).  The window is (w0, w1]: w0 its nominal start, w1 the moment
the serving loop stopped, at or after w0 + --seconds.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def percentile(values: List[float], q: float) -> Optional[float]:
    return float(np.percentile(values, q)) if len(values) else None


def ttft_s(rec: dict) -> List[float]:
    """Due to first token for every request due in [w0, w0 + seconds); one
    still without a token when the window closed counts the time it has
    waited."""
    w0, w_end, w1 = rec["w0"], rec["w_end"], rec["w1"]
    out = []
    for r in rec["requests"]:
        if r["due"] is None or not w0 <= r["due"] < w_end:
            continue
        first = r["times"][0] if r["times"] and r["times"][0] <= w1 else w1
        out.append(first - r["due"])
    return out


def itl_pairs(rec: dict) -> List[Tuple[float, float]]:
    """(a, b) for every pair of consecutive deliveries of a request's
    tokens whose later one, b, lies in the window.  Tokens delivered by one
    step arrive together, so they make one delivery."""
    w0, w1 = rec["w0"], rec["w1"]
    out = []
    for r in rec["requests"]:
        ts = sorted(set(r["times"]))
        out += [(a, b) for a, b in zip(ts, ts[1:]) if w0 < b <= w1]
    return out


def itl_s(rec: dict) -> List[float]:
    """Every gap between consecutive deliveries of a request's tokens that
    ends in the window."""
    return [b - a for a, b in itl_pairs(rec)]


def tokens_delivered(rec: dict) -> int:
    w0, w1 = rec["w0"], rec["w1"]
    return sum(1 for r in rec["requests"] for t in r["times"] if w0 < t <= w1)


def due_in_window(rec: dict) -> int:
    w0, w_end = rec["w0"], rec["w_end"]
    return sum(1 for r in rec["requests"]
               if r["due"] is not None and w0 <= r["due"] < w_end)


def steps_between(rec: dict, lo: float, hi: float) -> List[dict]:
    """The engine steps that ran wholly inside [lo, hi]."""
    return [s for s in rec["steps"] if s["t0"] >= lo and s["t"] <= hi]
