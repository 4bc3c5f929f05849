"""Shared request-lifecycle scheduler (DESIGN.md §2) — a copy of
``repro.serving.scheduler`` kept inside the PyTorch port so the port
imports nothing of ``repro``.

One ``Scheduler`` class is the control-plane core of the serving planes:
the discrete-event ``Simulation`` (modeled 12-device cluster) and the
real-execution ``BlockEngine`` (continuous batching with actual tensor
numerics) construct it and route every queueing decision through it.  It
owns three concerns, each parameterized by the admission policy:

- a **waiting queue** ordered by policy (``fcfs`` | ``priority``) with
  head-of-line admission against a backend-supplied ``fits`` predicate
  (KV-pool capacity for the engine, cluster admission for the simulator);
- **per-block run queues** — keyed by block instance (simulator) or
  ``(block, adapters)`` group (engine) — with ready-time gating, batch
  caps (paper §5.2 per-block batch configuration) and best-effort
  prioritization of returning KV owners (§5.1);
- **preemption decisions**: which running request to evict when a
  waiting request that the policy ranks higher cannot be admitted.

The scheduler never touches numerics or memory itself; backends execute
its decisions (prefill/evict/restore) and report back via callbacks.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from typing import (
    Any,
    Callable,
    Dict,
    FrozenSet,
    Iterable,
    List,
    Optional,
    Tuple,
)

POLICIES = ("fcfs", "priority")


@dataclass
class SchedEntry:
    """Lifecycle record for one request inside the scheduler.

    ``payload`` is the backend's attachment (the engine keeps its request
    state there; the simulator its trace ``Request``) — the scheduler only
    reads the ordering fields.
    """
    rid: int
    app: str
    arrival: float = 0.0
    priority: int = 0
    prompt_len: int = 0
    gen_len: int = 0
    preempted: bool = False  # resuming after a preemption
    payload: Any = None
    seq: int = -1  # submission tiebreaker, assigned once by the scheduler


class Scheduler:
    """Policy-parameterized request scheduler shared by both planes.

    ``tracer``/``metrics`` (both optional) are the observability hooks
    (DESIGN.md §8): the scheduler is the single source of the ``submit``
    and ``admit`` lifecycle events and of the queue-side metrics
    (``queue_wait_s`` histogram, ``waiting_depth`` gauge, per-policy
    ``admitted`` counter), for both the real engine and the simulator.
    """

    def __init__(self, policy: str = "fcfs", *, tracer=None, metrics=None):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown scheduling policy {policy!r}; one of {POLICIES}")
        self.policy = policy
        self.tracer = tracer
        self.metrics = metrics
        self._seq = itertools.count()
        self._waiting: List[Tuple[tuple, SchedEntry]] = []  # heap
        self._queues: Dict[Any, List[Tuple[float, int, Any]]] = {}
        self._enqueued_at: Dict[int, float] = {}  # rid -> tracer-clock submit t

    # -- policy ordering ----------------------------------------------------

    def order_key(self, e: SchedEntry) -> tuple:
        """Total admission order.  ``fcfs``: arrival then submission order;
        ``priority``: higher priority first, FCFS within a priority level.
        A preempted request keeps its original ``seq``, so it resumes ahead
        of later arrivals at the same rank instead of re-joining the tail."""
        if self.policy == "priority":
            return (-e.priority, e.arrival, e.seq)
        return (e.arrival, e.seq)

    # -- waiting queue / admission -------------------------------------------

    def submit(self, entry: SchedEntry) -> SchedEntry:
        if entry.seq < 0:
            entry.seq = next(self._seq)
        heapq.heappush(self._waiting, (self.order_key(entry), entry))
        if self.tracer is not None:
            # a preempted entry re-entering the queue is not a new arrival;
            # the backend already logged its "preempt" event
            t = (self.tracer.event(entry.rid, "submit", app=entry.app,
                                   prompt_len=entry.prompt_len,
                                   gen_len=entry.gen_len,
                                   priority=entry.priority)
                 if not entry.preempted else self.tracer.clock())
            self._enqueued_at[entry.rid] = t
        if self.metrics is not None:
            self.metrics.set_gauge(f"waiting_depth[{self.policy}]",
                                   len(self._waiting))
        return entry

    @property
    def waiting(self) -> int:
        return len(self._waiting)

    def peek(self) -> Optional[SchedEntry]:
        return self._waiting[0][1] if self._waiting else None

    def admit(self, *, fits: Callable[[SchedEntry], bool],
              max_new: Optional[int] = None,
              running: Any = (),
              preempt: Optional[Callable[[SchedEntry], bool]] = None,
              on_admit: Optional[Callable[[SchedEntry], None]] = None,
              ) -> List[SchedEntry]:
        """Pop waiting entries in policy order while ``fits`` accepts them.

        ``on_admit`` is invoked on each entry as it is popped, *before* the
        next head is evaluated — backends that consume resources at
        admission (the engine's prefill allocates KV slots) place each
        request so the following ``fits`` sees the updated occupancy.

        Head-of-line blocking is intentional: admitting around a blocked
        head would starve it.  When the head does not fit and ``preempt``
        is given, the scheduler proposes running victims the policy ranks
        strictly below the head (so FCFS never preempts) until the head
        fits or no eligible victim remains.  ``running`` may be a sequence
        or a zero-arg callable returning one (re-read after preemptions).
        """
        admitted: List[SchedEntry] = []
        while self._waiting and (max_new is None or len(admitted) < max_new):
            head = self._waiting[0][1]
            if fits(head):
                heapq.heappop(self._waiting)
                admitted.append(head)
                self._record_admit(head)
                if on_admit is not None:
                    on_admit(head)
                continue
            if preempt is not None:
                live = running() if callable(running) else running
                victim = self.pick_victim(live, head)
                if victim is not None and preempt(victim):
                    continue  # resources freed; retry the same head
            break
        return admitted

    def _record_admit(self, entry: SchedEntry) -> None:
        """Observability at the admission boundary: the ``admit`` event
        (fresh entries only — a preempted entry's boundary is the
        backend's ``readmit``) and the policy-tagged queue-wait sample."""
        t_sub = self._enqueued_at.pop(entry.rid, None)
        t = None
        if self.tracer is not None:
            t = (self.tracer.event(entry.rid, "admit", app=entry.app)
                 if not entry.preempted else self.tracer.clock())
        if self.metrics is not None:
            if t is not None and t_sub is not None:
                self.metrics.observe("queue_wait_s", t - t_sub)
            self.metrics.inc("admitted")
            self.metrics.set_gauge(f"waiting_depth[{self.policy}]",
                                   len(self._waiting))

    def pick_victim(self, running: Iterable[SchedEntry],
                    incoming: SchedEntry) -> Optional[SchedEntry]:
        """The running entry the policy ranks last — eligible only if it
        ranks strictly after ``incoming`` (no livelock: a request never
        preempts work the policy considers at least as important)."""
        inc = self.order_key(incoming)
        cands = [e for e in running if self.order_key(e) > inc]
        return max(cands, key=self.order_key) if cands else None

    # -- per-block run queues -------------------------------------------------

    def enqueue(self, key: Any, ready: float, item: Any) -> None:
        """Queue ``item`` (anything with a ``.rid``) on block queue ``key``,
        becoming eligible for batching at time ``ready``."""
        self._queues.setdefault(key, []).append((ready, next(self._seq), item))

    def queue_len(self, key: Any) -> int:
        return len(self._queues.get(key, ()))

    def total_queued(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def form_batch(self, key: Any, now: float, max_batch: int,
                   prioritize: FrozenSet[int] = frozenset()) -> List[Any]:
        """Pop up to ``max_batch`` ready items from block queue ``key``:
        prioritized rids first (returning KV owners, §5.1 best-effort
        coordination), then FIFO by ready time."""
        q = self._queues.get(key)
        if not q:
            return []
        ready = [(i, e) for i, e in enumerate(q) if e[0] <= now]
        if not ready:
            return []
        ready.sort(key=lambda ie: (0 if ie[1][2].rid in prioritize else 1,
                                   ie[1][0], ie[1][1]))
        take = ready[:max_batch]
        for i in sorted((i for i, _ in take), reverse=True):
            del q[i]
        return [e[2] for _, e in take]

    def drop_queue(self, key: Any) -> None:
        """Discard a block queue (the simulator evicted its instance)."""
        self._queues.pop(key, None)

    # -- full-chain signature groups (fused megastep, DESIGN.md §2) ----------

    def form_chain_groups(self, items: Iterable[Any],
                          key_fn: Callable[[Any], Any],
                          max_batch: int,
                          subkey_fn: Optional[Callable[[Any], Any]] = None
                          ) -> List[List[Any]]:
        """Partition ``items`` into fused-execution groups: one group per
        full-chain signature (``key_fn``), split into chunks of at most
        ``max_batch`` (the §5.2 per-block batch cap applied chain-wide).

        ``subkey_fn`` refines the partition without changing the primary
        key — the engine uses it to separate speculation-eligible members
        from ineligible ones (a fused group must step uniformly: every
        lane in a speculative megastep drafts the same lookahead).

        Order is deterministic — groups appear in first-seen signature
        order and members keep their relative order — so a stable running
        set re-forms identical groups step after step, letting the
        executor keep their decode state device-resident."""
        by_key: Dict[Any, List[Any]] = {}
        for item in items:
            key = key_fn(item)
            if subkey_fn is not None:
                key = (key, subkey_fn(item))
            by_key.setdefault(key, []).append(item)
        groups: List[List[Any]] = []
        for members in by_key.values():
            for i in range(0, len(members), max_batch):
                groups.append(members[i:i + max_batch])
        return groups
