"""Unified serving API (DESIGN.md §2) — a copy of ``repro.serving.api``
kept inside the PyTorch port so the port imports nothing of ``repro``.

Both serving backends — the discrete-event ``Simulation`` (cluster-scale
control plane, modeled time) and the real-execution ``BlockEngine``
(continuous batching with actual tensor numerics) — implement the same three
verbs, so launchers, examples and tests never reach into engine internals:

    server.submit(ServeRequest(...)) -> rid
    server.step() -> [ServeResult, ...]   # results completed this step
    server.drain() -> [ServeResult, ...]  # run to completion

``step()`` advances the backend by one scheduling quantum: one decode
iteration for the continuous-batching engine, one event for the simulator.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class ServeRequest:
    """One tenant request.  Real-execution backends consume
    ``prompt_tokens``; the simulator only needs ``prompt_len``."""
    app: str
    gen_len: int = 16
    prompt_tokens: Optional[np.ndarray] = None  # (S,) int32
    prompt_len: int = 0
    arrival: float = 0.0
    priority: int = 0  # higher preferred under the "priority" policy
    block_override: Optional[Dict[str, str]] = None  # adaptive serving
    rid: Optional[int] = None  # assigned by submit() when None

    def __post_init__(self):
        if self.prompt_tokens is not None:
            self.prompt_tokens = np.asarray(self.prompt_tokens)
            if self.prompt_tokens.ndim != 1:
                raise ValueError("prompt_tokens must be rank-1 (S,)")
            self.prompt_len = int(self.prompt_tokens.shape[0])


@dataclass
class ServeResult:
    """Completion record.  ``tokens`` is None for modeled-time backends."""
    rid: int
    app: str
    tokens: Optional[np.ndarray] = None  # (gen_len,) int32
    probs_last: Optional[np.ndarray] = None  # (V,) final-step probabilities
    latency: float = 0.0
    info: dict = field(default_factory=dict)


class Server(abc.ABC):
    """Common interface over the simulator and the real engine."""

    @abc.abstractmethod
    def submit(self, req: ServeRequest) -> int:
        """Admit a request; returns its rid."""

    @abc.abstractmethod
    def step(self) -> Optional[List[ServeResult]]:
        """Advance one scheduling quantum; returns newly completed results
        (possibly []), or None when there is no work left to advance."""

    @abc.abstractmethod
    def drain(self) -> List[ServeResult]:
        """Run until every submitted request completes; returns all results
        completed during the drain (in completion order)."""


def drain_by_stepping(server: Server, max_steps: int = 10_000_000
                      ) -> List[ServeResult]:
    """Default drain loop shared by backends: step until quiescent."""
    out: List[ServeResult] = []
    for _ in range(max_steps):
        res = server.step()
        if res is None:  # backend signals quiescence
            break
        out.extend(res)
    return out
