"""Requests and multi-tenant workload traces (paper §7.1) — a copy of
``repro.serving.request`` kept inside the PyTorch port so the port
imports nothing of ``repro``."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from repro_torch.serving.api import ServeRequest


@dataclass
class Request:
    rid: int
    app: str
    arrival: float
    prompt_len: int
    gen_len: int
    priority: int = 0
    # progress
    tokens_done: int = 0  # generated tokens so far
    hop: int = 0  # current position in the chain for this iteration
    t_start: Optional[float] = None
    t_done: Optional[float] = None
    # stats
    transfer_time: float = 0.0
    compute_time: float = 0.0
    queue_time: float = 0.0
    adaptive_hops: int = 0  # served by an equivalent (non-chain) block

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.tokens_done

    def latency(self) -> float:
        return (self.t_done - self.arrival) if self.t_done else float("inf")


def generate_trace(apps: List[str], *, total_requests: int = 400,
                   duration_s: float = 1200.0, seed: int = 0,
                   prompt_len=(32, 256), gen_len=(16, 128)) -> List[Request]:
    """Paper §7.1: uniform per-app mean rates (some apps more popular),
    Poisson arrivals within each app, fixed total request count."""
    rng = np.random.RandomState(seed)
    weights = rng.uniform(0.2, 1.0, size=len(apps))
    weights = weights / weights.sum()
    counts = rng.multinomial(total_requests, weights)
    reqs: List[Request] = []
    rid = 0
    for app, n in zip(apps, counts):
        if n == 0:
            continue
        rate = n / duration_s
        gaps = rng.exponential(1.0 / rate, size=n)
        t = np.cumsum(gaps)
        t = t * (duration_s / max(t[-1], 1e-9))  # fit within the window
        for ti in t:
            reqs.append(Request(
                rid=rid, app=app, arrival=float(ti),
                prompt_len=int(rng.randint(*prompt_len)),
                gen_len=int(rng.randint(*gen_len))))
            rid += 1
    reqs.sort(key=lambda r: r.arrival)
    return reqs


def as_serve_requests(trace: List[Request], *, vocab_size: int = 0,
                      seed: int = 0) -> List["ServeRequest"]:
    """Lift trace Requests into the unified Server API.  When ``vocab_size``
    is given, synthesize concrete prompt tokens (real-execution engines need
    them); the simulator only reads the lengths."""
    from repro_torch.serving.api import ServeRequest

    rng = np.random.RandomState(seed)
    out = []
    for r in trace:
        tokens = (rng.randint(0, vocab_size, size=r.prompt_len)
                  .astype(np.int32) if vocab_size else None)
        out.append(ServeRequest(app=r.app, gen_len=r.gen_len,
                                prompt_tokens=tokens,
                                prompt_len=r.prompt_len,
                                arrival=r.arrival, priority=r.priority,
                                rid=r.rid))
    return out
