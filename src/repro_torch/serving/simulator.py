"""BlockLLM online serving system (paper §5) + PM/PS baselines (§7.1) — the
port of ``repro.serving.simulator`` (numpy only).

The control plane is the shared three-layer core (DESIGN.md §2): request
admission and every per-instance run queue live in the same
``repro_torch.serving.scheduler.Scheduler`` class the real-execution
``BlockEngine`` drives; this module adds the cluster model — placement,
KV-ownership registry, speculation — and advances time through the
§5.1/§5.3 cost model (discrete-event) at the NVIDIA H100 constants of
``repro_torch.serving.cluster``: its times are modeled, not measured.

Modes: "blockllm" | "pm" (per-model provisioning) | "ps" (parameter sharing,
S-LoRA-like merged engine with branching overhead).
Ablations (paper §7.3) via SchedulerConfig flags.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.observability import MetricsRegistry, Tracer
from repro_torch.serving.api import ServeRequest, ServeResult, Server
from repro_torch.serving.cluster import (
    INTER_SERVER_BW,
    PEAK_FLOPS,
    Cluster,
    paper_cluster,
)
from repro_torch.serving.cost_model import (
    BlockCost,
    best_kv_strategy,
    estimate_latency,
    t_revisit_owner,
)
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import SchedEntry, Scheduler

TOKEN_BYTES = 8192  # bytes shipped per generated token (hidden-state row)


# ---------------------------------------------------------------------------
# serving configuration: apps, chains, logical blocks
# ---------------------------------------------------------------------------


@dataclass
class LogicalBlock:
    block_id: str
    cost: BlockCost
    equivalents: List[str] = field(default_factory=list)  # adaptive candidates


@dataclass
class AppChain:
    app: str
    blocks: List[str]  # logical block ids, in order
    branching: int = 1  # PS mode: number of merged variants


@dataclass
class ServingConfig:
    blocks: Dict[str, LogicalBlock]
    chains: Dict[str, AppChain]
    max_batch: int = 32


def build_serving_config(n_foundations: int = 3, n_apps: int = 20,
                         segments: int = 4, params_per_model: float = 7e9,
                         mode: str = "blockllm", seed: int = 0,
                         vocab_kv_bytes: int = 64 * 1024) -> ServingConfig:
    """Synthesize a multi-tenant zoo: ``n_apps`` fine-tuned variants over
    ``n_foundations`` foundations, each partitioned into ``segments`` blocks.

    - PEFT variants (2/3 of apps) share every foundation segment;
    - FPFT variants own ONE divergent segment with an equivalence edge back
      to the foundation segment (adaptive-serving candidate, §4.1);
    - pm mode: every app gets private copies of every segment.
    """
    rng = np.random.RandomState(seed)
    blocks: Dict[str, LogicalBlock] = {}
    chains: Dict[str, AppChain] = {}
    seg_params = params_per_model / segments
    seg_bytes = int(seg_params * 2)  # bf16

    def mk_block(bid: str) -> LogicalBlock:
        cost = BlockCost(block_id=bid, param_bytes=seg_bytes,
                         flops_per_token=2.0 * seg_params,
                         kv_bytes_per_token=vocab_kv_bytes // segments)
        blk = LogicalBlock(bid, cost)
        blocks[bid] = blk
        return blk

    foundations = [f"fnd{i}" for i in range(n_foundations)]
    for f in foundations:
        for s in range(segments):
            mk_block(f"{f}/seg{s}")

    for a in range(n_apps):
        f = foundations[a % n_foundations]
        kind = "peft" if a % 3 != 0 else "fpft"
        app = f"app{a}"
        if mode == "pm":
            chain = []
            for s in range(segments):
                bid = f"{app}/seg{s}"
                mk_block(bid)
                chain.append(bid)
            chains[app] = AppChain(app, chain)
            continue
        if kind == "peft" or mode == "ps":
            chains[app] = AppChain(
                app, [f"{f}/seg{s}" for s in range(segments)],
                branching=1)
        else:  # fpft: one divergent segment with an equivalence edge
            div = int(rng.randint(0, segments))
            chain = []
            for s in range(segments):
                if s == div:
                    bid = f"{app}/seg{s}"
                    mk_block(bid)
                    blocks[bid].equivalents.append(f"{f}/seg{s}")
                    blocks[f"{f}/seg{s}"].equivalents.append(bid)
                    chain.append(bid)
                else:
                    chain.append(f"{f}/seg{s}")
            chains[app] = AppChain(app, chain)
    if mode == "ps":
        # merged engine: every chain over a foundation shares instances but
        # pays a branching overhead proportional to merged variants
        per_f = defaultdict(int)
        for app, c in chains.items():
            per_f[c.blocks[0].split("/")[0]] += 1
        for app, c in chains.items():
            c.branching = per_f[c.blocks[0].split("/")[0]]
    return ServingConfig(blocks, chains)


# ---------------------------------------------------------------------------
# scheduler / agents / instances
# ---------------------------------------------------------------------------


@dataclass
class SchedulerConfig:
    mode: str = "blockllm"
    policy: str = "fcfs"                  # admission order: fcfs | priority
    adaptive: bool = True                 # O1 (§5.3)
    kv_policy: str = "owner"              # owner | recalc | least-busy (§5.1/Fig 21)
    speculation: bool = True              # §5.2
    spec_top_frac: float = 0.10           # top 10% bottleneck instances (§7.1)
    spec_speedup: float = 20.0            # surrogate speedup (Table 4)
    spec_accuracy: float = 0.83           # 192/231 accurate (paper §7.3)
    # engine-side speculation knobs (real BlockEngine; the discrete-event
    # model keeps using spec_speedup/spec_accuracy above) — living here so
    # the auto-CLI plumbing exposes one flag namespace for both backends
    spec_lookahead: int = 4               # tokens per speculative megastep
    spec_prune_ratio: float = 0.25        # surrogate FFN prune ratio
    spec_min_accept: float = 0.1          # disable gate on accept-rate EMA
    placement: str = "locality"           # locality | fragmentation (§5.3/Fig 23)
    scale_queue_threshold: int = 8        # queue length per block -> scale out
    rescale_period: float = 2.0
    max_batch: int = 32
    branching_overhead: float = 0.06      # PS: per-merged-variant compute tax
    seed: int = 0

    # single source of truth for CLI plumbing: every field becomes a flag
    _ARG_CHOICES = {"mode": ("blockllm", "pm", "ps"),
                    "policy": ("fcfs", "priority"),
                    "kv_policy": ("owner", "recalc", "least-busy"),
                    "placement": ("locality", "fragmentation")}

    @classmethod
    def add_args(cls, parser):
        """Mirror every config field as an argparse flag: booleans that
        default True become ``--no-<name>``, the rest ``--<name>``."""
        for f in dataclasses.fields(cls):
            flag = f.name.replace("_", "-")
            if isinstance(f.default, bool):
                if f.default:
                    parser.add_argument(f"--no-{flag}", dest=f.name,
                                        action="store_false", default=True)
                else:
                    parser.add_argument(f"--{flag}", dest=f.name,
                                        action="store_true", default=False)
            else:
                parser.add_argument(
                    f"--{flag}", dest=f.name, type=type(f.default),
                    default=f.default,
                    choices=cls._ARG_CHOICES.get(f.name))
        return parser

    @classmethod
    def from_args(cls, args) -> "SchedulerConfig":
        return cls(**{f.name: getattr(args, f.name)
                      for f in dataclasses.fields(cls)})


@dataclass
class Instance:
    """One placed block copy.  Its run queue lives in the shared
    ``Scheduler`` keyed by ``iid`` — the instance only tracks service
    state."""
    iid: int
    block_id: str
    device: int
    busy: bool = False
    speculated: bool = False
    countdowns: Dict[int, float] = field(default_factory=dict)  # rid -> eta
    last_used: float = 0.0
    loading_until: float = 0.0  # block swap-in completes at this time


class Simulation(Server):
    """Discrete-event backend of the unified ``Server`` API: ``submit``
    pushes an arrival event, ``step`` processes one event, ``drain`` runs
    the event loop dry.  ``run(trace)`` remains as the batch convenience."""

    def __init__(self, cfg: ServingConfig, sched: SchedulerConfig,
                 cluster: Optional[Cluster] = None):
        self.cfg = cfg
        self.sched = sched
        self.cluster = cluster or paper_cluster()
        self.rng = np.random.RandomState(sched.seed)
        # observability plane shared with the real engine (DESIGN.md §8):
        # same registry/tracer types, timestamps in MODELED seconds — so
        # discrete-event and real runs emit structurally comparable reports
        self.metrics_registry = MetricsRegistry()
        self.tracer = Tracer(clock=lambda: self.now)
        # the same Scheduler class the real-execution BlockEngine drives:
        # waiting-queue admission + per-instance run queues (keyed by iid)
        self.scheduler = Scheduler(policy=sched.policy,
                                   tracer=self.tracer, metrics=self.metrics_registry)
        self.instances: Dict[int, Instance] = {}
        self.by_block: Dict[str, List[int]] = defaultdict(list)
        # chain adjacency prior for locality placement (§5.3)
        self.adjacency = set()
        for c in cfg.chains.values():
            for a, b in zip(c.blocks, c.blocks[1:]):
                self.adjacency.add((a, b))
                self.adjacency.add((b, a))
        self._iid = itertools.count()
        self._seq = itertools.count()
        self.events: list = []
        self.now = 0.0
        # KV registry: (rid, block_id) -> (owner device, bytes)
        self.kv_owner: Dict[Tuple[int, str], Tuple[int, int]] = {}
        self.traffic: Dict[Tuple[str, str], float] = defaultdict(float)
        self.done: List[Request] = []
        self.stats = defaultdict(float)
        self.spec_attempts = 0
        self.spec_hits = 0
        # same stat keys as the real engine's registry (DESIGN.md §8), so
        # merged/compared snapshots line up name-for-name
        self.metrics_registry.counter("spec_attempts")
        self.metrics_registry.counter("spec_hits")
        self.metrics_registry.set_gauge("spec_accept_rate", 0.0)
        # Server-API state
        self._rid = itertools.count()
        self._placed = False
        self._next_rescale = 1.0
        self._until = 1e9

    # -- placement ---------------------------------------------------------

    def _placement_score(self, block_id: str, dev: int) -> float:
        d = self.cluster.devices[dev]
        if self.sched.placement == "fragmentation":
            # pack: prefer the most-used device with room
            return -d.free()
        # locality: prefer servers hosting neighbours with high traffic,
        # balanced against device load (O3: use idle silicon)
        score = 0.0
        total_t = 0.0
        for other in self.instances.values():
            key = (block_id, other.block_id)
            t = self.traffic.get(key, 0.0) + self.traffic.get(key[::-1], 0.0)
            if t <= 0 and key in self.adjacency:
                t = 1.0  # static chain adjacency as prior
            total_t += t
            if t > 0 and d.server_id == \
                    self.cluster.devices[other.device].server_id:
                score += t
        score = score / max(total_t, 1e-9)  # normalized locality in [0,1]
        load = max(0.0, d.busy_until - self.now)  # pending compute seconds
        return 2.0 * score + d.free() / d.memory - min(load, 5.0)

    def _evict_one(self, protect_block: str) -> bool:
        """Evict the least-recently-used idle instance (model switching —
        the Fig. 5 overhead per-model provisioning pays constantly)."""
        victims = [i for i in self.instances.values()
                   if not i.busy and not self.scheduler.queue_len(i.iid)
                   and i.block_id != protect_block]
        if not victims:
            return False
        v = min(victims, key=lambda i: i.last_used)
        dev = self.cluster.devices[v.device]
        size = dev.resident_blocks.pop(f"{v.block_id}#{v.iid}", 0)
        self.by_block[v.block_id].remove(v.iid)
        self.scheduler.drop_queue(v.iid)
        del self.instances[v.iid]
        self.stats["evictions"] += 1
        self.stats["switch_bytes"] += size
        return True

    def place_instance(self, block_id: str, *, evict: bool = True
                       ) -> Optional[Instance]:
        cost = self.cfg.blocks[block_id].cost
        need = cost.param_bytes * 1.3
        cands = [d for d in self.cluster.devices if d.free() >= need]
        tries = 0
        while not cands and evict and tries < 64:
            if not self._evict_one(block_id):
                break
            tries += 1
            cands = [d for d in self.cluster.devices if d.free() >= need]
        if not cands:
            return None
        best = max(cands, key=lambda d: self._placement_score(block_id,
                                                              d.device_id))
        inst = Instance(next(self._iid), block_id, best.device_id)
        best.resident_blocks[f"{block_id}#{inst.iid}"] = cost.param_bytes
        # swap-in cost (paper §5.3 T_load / Fig 5 switching overhead)
        load_t = cost.load_time()
        inst.loading_until = self.now + load_t
        inst.last_used = self.now
        self.stats["switch_time"] += load_t
        self.stats["switch_bytes"] += cost.param_bytes
        self.instances[inst.iid] = inst
        self.by_block[block_id].append(inst.iid)
        return inst

    def initial_placement(self):
        for bid in self.cfg.blocks:
            if not self.by_block[bid]:
                self.place_instance(bid)

    # -- dispatch (§5.3) ----------------------------------------------------

    def _queue_time(self, inst: Instance) -> float:
        cost = self.cfg.blocks[inst.block_id].cost
        pend = self.scheduler.queue_len(inst.iid) + (1 if inst.busy else 0)
        return pend * cost.compute_time(1, 1) * 4  # rough per-batch estimate

    def candidates(self, req: Request, block_id: str) -> List[int]:
        ids = list(self.by_block[block_id])
        if self.sched.adaptive and self.sched.mode == "blockllm":
            for eq in self.cfg.blocks[block_id].equivalents:
                ids.extend(self.by_block[eq])
        return ids

    def dispatch(self, req: Request, block_id: str, from_dev: Optional[int]):
        """Pick the target instance per §5.1/§5.3, account transfer time,
        enqueue.  Returns the chosen instance."""
        cands = self.candidates(req, block_id)
        if not cands:
            inst = self.place_instance(block_id)
            if inst is None:  # no memory anywhere: queue on a busy peer
                cands = [min(self.instances,
                             key=lambda i: self.scheduler.queue_len(i))]
            else:
                cands = [inst.iid]
        kv_key = (req.rid, block_id)
        owner = self.kv_owner.get(kv_key)
        decode = req.tokens_done > 0
        cost = self.cfg.blocks[block_id].cost
        kv_bytes = cost.kv_bytes_per_token * req.total_len
        kv_flops = cost.flops_per_token * req.total_len
        new_tok = TOKEN_BYTES
        full_req = TOKEN_BYTES * req.total_len

        best_iid, best_t, best_strategy = None, float("inf"), "fresh"
        # best-effort: prioritize the KV owner when statuses are comparable
        for iid in cands:
            inst = self.instances[iid]
            dev = inst.device
            if from_dev is None:
                t_transfer = new_tok / INTER_SERVER_BW  # scheduler dispatch (§5.3)
            elif decode and owner is not None:
                if dev == owner[0]:
                    t_transfer = t_revisit_owner(
                        self.cluster, from_dev, dev, new_tok, kv_bytes)
                    if self.sched.kv_policy == "owner":
                        t_transfer *= 0.25  # owner-priority boost (best-effort)
                else:
                    if self.sched.kv_policy == "recalc":
                        t_transfer = full_req / self.cluster.bw(from_dev, dev) \
                            + kv_flops / PEAK_FLOPS
                    else:
                        t_transfer, _ = best_kv_strategy(
                            self.cluster, from_dev, owner[0], dev, new_tok,
                            full_req, kv_bytes, kv_flops)
            else:
                t_transfer = new_tok / self.cluster.bw(from_dev, dev) \
                    if from_dev != dev else 0.0
            t = estimate_latency(
                self.cluster, queue_compute_time=self._queue_time(inst),
                compute_time=cost.compute_time(1, 1), transfer_time=t_transfer,
                device_idle=not inst.busy, evict_bytes=0, load_bytes=0)
            if self.sched.kv_policy == "least-busy":
                t = self._queue_time(inst)  # ignore KV locality (Fig 21 ablation)
            if t < best_t:
                best_iid, best_t, best_strategy = iid, t, None
        inst = self.instances[best_iid]
        if inst.block_id != block_id:
            req.adaptive_hops += 1
        # transfer accounting
        if from_dev is not None:
            dev = inst.device
            if decode and owner is not None and dev != owner[0] and \
                    self.sched.kv_policy != "least-busy":
                t_tr, strat = best_kv_strategy(
                    self.cluster, from_dev, owner[0], dev, new_tok, full_req,
                    kv_bytes, kv_flops)
                if self.sched.kv_policy == "recalc":
                    t_tr = full_req / self.cluster.bw(from_dev, dev) \
                        + kv_flops / PEAK_FLOPS
                self.kv_owner[kv_key] = (dev, kv_bytes)
            elif decode and owner is not None and dev == owner[0]:
                t_tr = t_revisit_owner(self.cluster, from_dev, dev, new_tok,
                                       kv_bytes / 8)  # hot cache
            else:
                t_tr = new_tok / self.cluster.bw(from_dev, dev) \
                    if from_dev != dev else 0.0
                self.kv_owner[kv_key] = (dev, kv_bytes)
            req.transfer_time += t_tr
            self.stats["transfer_time"] += t_tr
            if from_dev != dev:
                self.stats["hops"] += 1
                if not self.cluster.same_server(from_dev, dev):
                    self.stats["inter_server_hops"] += 1
            ready = self.now + t_tr
            # locality traffic counter (§5.3)
            prev_inst = next((i for i in self.instances.values()
                              if i.device == from_dev), None)
            if prev_inst is not None:
                self.traffic[(prev_inst.block_id, inst.block_id)] += \
                    new_tok + (kv_bytes if dev != from_dev else 0)
        else:
            ready = self.now + new_tok / INTER_SERVER_BW
        self.kv_owner.setdefault(kv_key, (inst.device, kv_bytes))
        ready = max(ready, inst.loading_until)
        inst.last_used = self.now
        self.scheduler.enqueue(inst.iid, ready, req)
        heapq.heappush(self.events,
                       (ready, next(self._seq), "enqueue", (inst.iid, req)))
        return inst

    # -- instance service loop ----------------------------------------------

    def _service(self, inst: Instance):
        if inst.busy:
            return
        # FIFO + priority for returning KV owners (countdown, §6) — the
        # batch-forming policy is the scheduler's, shared with the engine
        batch: List[Request] = self.scheduler.form_batch(
            inst.iid, self.now, self.sched.max_batch,
            prioritize=frozenset(inst.countdowns))
        if not batch:
            return
        inst.busy = True
        inst.last_used = self.now
        # same metric names as the real executor: one batched service at
        # one block instance == one group call at its batch occupancy
        self.metrics_registry.inc("group_calls")
        self.metrics_registry.observe("group_batch", len(batch))
        cost = self.cfg.blocks[inst.block_id].cost
        tokens = sum(r.prompt_len if r.tokens_done == 0 else 1 for r in batch)
        ctx = max(r.total_len for r in batch)
        t_c = cost.compute_time(len(batch), max(1, tokens // len(batch)), ctx)
        chain = self.cfg.chains[batch[0].app]
        if self.sched.mode == "ps" and chain.branching > 1:
            t_c *= 1.0 + self.sched.branching_overhead * (chain.branching - 1)
        dev = self.cluster.devices[inst.device]
        # device-level serialization: one compute stream per chip
        t_start = max(self.now, dev.busy_until)
        t_end = t_start + t_c
        dev.busy_until = t_end
        dev.busy_time += t_c
        dev.useful_flop_time += cost.useful_time(len(batch),
                                                 max(1, tokens // len(batch)))
        for r in batch:
            r.compute_time += t_c
            r.queue_time += t_start - self.now
            if r.t_start is None:
                r.t_start = self.now
        # speculation (§5.2): downstream handoff can begin at t_surrogate
        handoff = t_end
        if inst.speculated and self.sched.speculation:
            self.spec_attempts += len(batch)
            self.metrics_registry.inc("spec_attempts", len(batch))
            t_sur = t_c / self.sched.spec_speedup
            ok = self.rng.random() < self.sched.spec_accuracy
            if ok:
                self.spec_hits += len(batch)
                self.metrics_registry.inc("spec_hits", len(batch))
                handoff = t_start + t_sur + 0.1 * (t_c - t_sur)
            self.metrics_registry.set_gauge(
                "spec_accept_rate", self.spec_hits / self.spec_attempts)
            dev.busy_time += t_sur  # surrogate occupies a parallel stream
        heapq.heappush(self.events, (t_end, next(self._seq),
                                     "service_done", (inst.iid, batch, handoff)))

    def _advance(self, req: Request, inst: Instance, handoff_time: float):
        chain = self.cfg.chains[req.app]
        req.hop += 1
        if req.hop >= len(chain.blocks):
            req.hop = 0
            if req.tokens_done == 0:
                req.tokens_done = 1  # prefill produced the first token
            else:
                req.tokens_done += 1
            if req.tokens_done >= req.gen_len:
                req.t_done = handoff_time
                self.done.append(req)
                self.tracer.event(req.rid, "finish", t=handoff_time,
                                  tokens=req.tokens_done)
                self.metrics_registry.inc("completed")
                self.metrics_registry.inc("tokens_emitted", req.gen_len)
                self.metrics_registry.observe("latency_s", req.latency())
                self.metrics_registry.observe("instance_queue_wait_s", req.queue_time)
                self.metrics_registry.observe("transfer_s", req.transfer_time)
                for key in list(self.kv_owner):
                    if key[0] == req.rid:
                        del self.kv_owner[key]
                return
            inst.countdowns[req.rid] = handoff_time + 0.05
        nxt = chain.blocks[req.hop]
        self.now_save = self.now
        self.now = handoff_time
        self.dispatch(req, nxt, inst.device)
        self.now = self.now_save

    # -- scaling + speculation refresh (§5.3) --------------------------------

    def _rescale(self):
        # scale out hot blocks
        for bid, iids in list(self.by_block.items()):
            qlen = sum(self.scheduler.queue_len(i) for i in iids)
            if qlen > self.sched.scale_queue_threshold:
                self.place_instance(bid)
        # refresh speculation set: top-k by queue completion time, skipping
        # chain-final blocks and consecutive positions (§5.2)
        if not self.sched.speculation or self.sched.mode != "blockllm":
            return
        final_blocks = {c.blocks[-1] for c in self.cfg.chains.values()}
        load = sorted(self.instances.values(),
                      key=lambda i: -self.scheduler.queue_len(i.iid))
        k = max(1, int(len(self.instances) * self.sched.spec_top_frac))
        chosen = set()
        chain_pos = {}
        for c in self.cfg.chains.values():
            for pos, b in enumerate(c.blocks):
                chain_pos.setdefault(b, pos)
        for inst in load:
            if len(chosen) >= k:
                break
            if inst.block_id in final_blocks:
                continue
            pos = chain_pos.get(inst.block_id, 0)
            if any(chain_pos.get(self.instances[c].block_id, -9) in
                   (pos - 1, pos + 1) for c in chosen):
                continue  # no consecutive speculation
            chosen.add(inst.iid)
        for inst in self.instances.values():
            inst.speculated = inst.iid in chosen

    # -- main loop (unified Server API) --------------------------------------

    def submit(self, req) -> int:
        """Accept a ServeRequest (or a raw trace Request) as an arrival."""
        if isinstance(req, ServeRequest):
            rid = req.rid if req.rid is not None else next(self._rid)
            req = Request(rid=rid, app=req.app, arrival=req.arrival,
                          prompt_len=req.prompt_len or 1,
                          gen_len=req.gen_len, priority=req.priority)
        heapq.heappush(self.events, (req.arrival, next(self._seq),
                                     "arrival", req))
        return req.rid

    def _cluster_fits(self, entry: SchedEntry) -> bool:
        """Cluster-level admission hook.  The modeled cluster admits every
        arrival — memory pressure is absorbed by placement/eviction
        (place_instance) rather than by holding requests back."""
        return True

    def step(self) -> Optional[List[ServeResult]]:
        """Process one discrete event; returns requests completed by it."""
        if not self._placed:
            self.initial_placement()
            self._placed = True
        if not self.events:
            return None
        done_before = len(self.done)
        t, _, kind, payload = heapq.heappop(self.events)
        self.now = max(self.now, t)
        if self.now > self._until:
            return None
        while self.now >= self._next_rescale:
            self._rescale()
            self._next_rescale += self.sched.rescale_period
        if kind == "arrival":
            req: Request = payload
            self.scheduler.submit(SchedEntry(
                rid=req.rid, app=req.app, arrival=req.arrival,
                priority=req.priority, prompt_len=req.prompt_len,
                gen_len=req.gen_len, payload=req))
            for entry in self.scheduler.admit(fits=self._cluster_fits):
                r = entry.payload
                self.dispatch(r, self.cfg.chains[r.app].blocks[0], None)
        elif kind == "enqueue":
            iid, req = payload
            self._service(self.instances[iid])
        elif kind == "service_done":
            iid, batch, handoff = payload
            inst = self.instances[iid]
            inst.busy = False
            for r in batch:
                inst.countdowns.pop(r.rid, None)
                self._advance(r, inst, handoff)
            self._service(inst)
        return [ServeResult(rid=r.rid, app=r.app, latency=r.latency(),
                            info={"queue_time": r.queue_time,
                                  "transfer_time": r.transfer_time,
                                  "adaptive_hops": r.adaptive_hops,
                                  "trace": self.tracer.trace(r.rid).to_dict()})
                for r in self.done[done_before:]]

    def drain(self) -> List[ServeResult]:
        out: List[ServeResult] = []
        while True:
            res = self.step()
            if res is None:
                return out
            out.extend(res)

    def run(self, requests: List[Request], until: float = 1e9) -> dict:
        for r in requests:
            self.submit(r)
        self._until = until
        self.drain()
        return self.metrics()

    # -- metrics (§7.1) -------------------------------------------------------

    def metrics(self) -> dict:
        lats = sorted(r.latency() for r in self.done)
        if not lats:
            return {"completed": 0}
        span = max(r.t_done for r in self.done) - min(r.arrival for r in self.done)
        tokens = sum(r.gen_len for r in self.done)
        busy = sum(d.busy_time for d in self.cluster.devices)
        useful = sum(d.useful_flop_time for d in self.cluster.devices)
        wall = span * len(self.cluster.devices)
        comm = self.stats["transfer_time"]
        return {
            "completed": len(self.done),
            "median_latency": lats[len(lats) // 2],
            "p95_latency": lats[int(len(lats) * 0.95)],
            "mean_latency": float(np.mean(lats)),
            "throughput_tokens_s": tokens / max(span, 1e-9),
            "gpu_utilization": busy / max(wall, 1e-9),
            "sm_efficiency": useful / max(busy, 1e-9),
            "communication_s": comm,
            "inter_server_frac": self.stats["inter_server_hops"]
            / max(self.stats["hops"], 1),
            "adaptive_served": sum(1 for r in self.done if r.adaptive_hops),
            "spec_attempts": self.spec_attempts,
            "spec_hits": self.spec_hits,
            "spec_accept_rate": (self.spec_hits / self.spec_attempts
                                 if self.spec_attempts else 0.0),
            "queue_wait_p95_s": self.metrics_registry.histogram(
                "instance_queue_wait_s").percentile(95),
            "group_batch_mean": self.metrics_registry.histogram(
                "group_batch").summary()["mean"],
        }
