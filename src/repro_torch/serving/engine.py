"""Real-execution serving engine: glue over the three-layer serving core
(DESIGN.md §2) — the port of ``repro.serving.engine``.

``BlockEngine`` implements the unified ``Server`` API (submit / step /
drain) by wiring together:

- the **scheduler** (``repro_torch.serving.scheduler.Scheduler``), which
  owns the waiting queue, priority/FCFS admission order, per-(block,
  adapters) run queues and preemption decisions;
- the **executor** (``repro_torch.serving.executor.BlockExecutor``), which
  owns the fused chain megastep, cross-app group batching on shared blocks
  (paper §5.2) and sampling;
- the **KV manager** (``repro_torch.serving.kv_pool.KVManager``), which owns
  the shared paged pools, admission planning, and slot preemption with the
  §5.1 transfer-vs-recalc cost model deciding spill-to-host versus
  recompute-on-readmit.

The engine itself only resolves chains, runs the admission/decode loop,
and translates between ``ServeRequest``/``ServeResult`` and the layers.

Device and precision are the caller's: ``EngineConfig.device`` (``cuda``
unless the caller asks for ``cpu``) and ``EngineConfig.compute_dtype``.
Constructing an engine turns TF32 off for cuBLAS and cuDNN, so fp32 runs
compute in full fp32 as the reference does.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.blocks import Block, BlockChain, chain_signature
from repro_torch.core.zoo import BlockZoo
from repro_torch.kernels.paged_attention.ops import IMPLS as ATTN_IMPLS
from repro_torch.models.layers import resolve_dtype
from repro_torch.observability import MetricsRegistry, Tracer
from repro_torch.serving.api import ServeRequest, ServeResult, Server
from repro_torch.serving.cost_model import preempt_readmit_strategy
from repro_torch.serving.executor import BlockExecutor
from repro_torch.serving.kv_pool import KVManager
from repro_torch.serving.scheduler import SchedEntry, Scheduler


@dataclass
class GenerationResult:
    tokens: np.ndarray  # (B, gen_len)
    probs_last: Optional[np.ndarray]  # (B, V) final-step probs; None if gen_len=0
    adaptive_blocks_used: int = 0


@dataclass
class EngineConfig:
    max_active: int = 32        # continuous-batch width (in-flight requests)
    max_block_batch: int = 16   # per-block batch cap (paper §5.2)
    page_size: int = 16         # KV pool page, in tokens
    num_pages: int = 0          # 0 -> sized from max_active * max_len
    attn_impl: str = "auto"     # auto (by device) | ref | cuda
    policy: str = "fcfs"        # admission order: fcfs | priority
    preemption: bool = True     # pressure-driven slot eviction (priority)
    preempt_strategy: str = "auto"  # auto | spill | recalc (§5.1)
    fused: bool = True          # fused chain-step megastep + batched prefill
    #   (False = per-hop dispatch path, kept as the parity oracle)
    speculation: bool = False   # draft-verify decoding: not ported yet
    device: str = "cuda"        # where the pools live and compute runs
    compute_dtype: str = "bfloat16"  # activations and KV pools


@dataclass
class _ReqState:
    rid: int
    app: str
    steps: List[Tuple[Block, Tuple[Block, ...]]]  # resolved (block, adapters)
    gen_len: int
    prompt_len: int
    slot_tokens: int = 0        # KV slot capacity
    prompt_tokens: Optional[np.ndarray] = None  # kept for recompute-on-readmit
    adaptive_blocks_used: int = 0
    kv_len: int = 0             # tokens currently cached (prompt + decoded)
    tokens: List[int] = field(default_factory=list)
    next_token: Optional[int] = None
    probs_last: Optional[np.ndarray] = None
    t_submit: float = 0.0       # wall-clock submission time
    t_first_token: Optional[float] = None  # prefill completion (TTFT anchor)
    preemptions: int = 0


class BlockEngine(Server):
    """Continuous-batching chain executor over shared paged KV pools."""

    def __init__(self, zoo: BlockZoo, max_len: int = 256,
                 config: Optional[EngineConfig] = None):
        self.config = c = config or EngineConfig()
        if c.speculation:
            raise NotImplementedError(
                "speculative decoding is not ported yet: see the speculation "
                "slice in ROADMAP.md")
        if c.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {c.attn_impl!r}; one of {ATTN_IMPLS}")
        self.device = torch.device(c.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("EngineConfig.device='cuda' but no CUDA device "
                               "is available; pass device='cpu' to run on "
                               "the CPU")
        # full fp32 in fp32 runs: no TF32 in cuBLAS or cuDNN
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.compute_dtype = resolve_dtype(c.compute_dtype)
        self.zoo = zoo
        self.max_len = max_len
        self._rid = itertools.count()
        # observability plane (DESIGN.md §8): one tracer + one metrics
        # registry threaded through scheduler, executor and KV manager
        self.tracer = Tracer(clock=time.perf_counter)
        self.metrics = MetricsRegistry()
        for name in ("steps", "prefills", "decode_tokens", "group_calls",
                     "host_syncs", "attn_calls", "preemptions", "spills",
                     "recalc_readmits", "completed", "tokens_emitted"):
            self.metrics.counter(name)  # pre-register: snapshots start at 0
        self.metrics.set_gauge("max_block_batch", c.max_block_batch)
        # legacy dict-shaped view: engine.stats[k] reads the counter values
        self.stats = self.metrics.counters_view()
        self._c_steps = self.metrics.counter("steps")
        self._h_step_wall = self.metrics.histogram("step_wall_s")
        self.scheduler = Scheduler(policy=c.policy, tracer=self.tracer,
                                   metrics=self.metrics)
        self.executor = BlockExecutor(attn_impl=c.attn_impl,
                                      metrics=self.metrics,
                                      compute_dtype=self.compute_dtype,
                                      device=self.device)
        pages_per_seq = -(-max_len // c.page_size)
        num_pages = c.num_pages or (
            1 + c.max_active * pages_per_seq * self._max_attn_steps())
        self.kv = KVManager(c.page_size, num_pages, dtype=self.compute_dtype,
                            device=self.device, metrics=self.metrics,
                            tracer=self.tracer)
        self.active: List[_ReqState] = []
        self._entries: Dict[int, SchedEntry] = {}  # rid -> running lifecycle
        self._early: List[ServeResult] = []        # gen_len=0 completions
        self._pending_prefill: List[_ReqState] = []  # admitted, not prefilled

    @property
    def pools(self):
        """Signature -> KVPool view (owned by the KV manager)."""
        return self.kv.pools

    # -- chain resolution ---------------------------------------------------

    def _steps(self, chain: BlockChain, override: Optional[Dict[str, str]]):
        out = []
        used_adaptive = 0
        for step in chain.steps:
            bid = step.block_id
            if override and bid in override:
                bid = override[bid]
                used_adaptive += 1
            block = self.zoo.blocks[bid]
            adapters = tuple(self.zoo.blocks[a] for a in step.adapter_ids)
            out.append((block, adapters))
        return out, used_adaptive

    def _max_attn_steps(self) -> int:
        """Upper bound on attention-bearing steps of any registered chain."""
        n = 1
        for chain in self.zoo.chains.values():
            c = sum(1 for s in chain.steps
                    if self.zoo.blocks[s.block_id].has_kv)
            n = max(n, c)
        return n

    # -- Server API ---------------------------------------------------------

    def submit(self, req: ServeRequest) -> int:
        if req.prompt_tokens is None:
            raise ValueError("BlockEngine requires prompt_tokens")
        if req.app not in self.zoo.chains:
            raise KeyError(f"unknown app {req.app!r}")
        return self._submit_chain(req, self.zoo.chains[req.app])

    def _submit_chain(self, req: ServeRequest, chain: BlockChain) -> int:
        if req.rid is None:
            req.rid = next(self._rid)
        if req.prompt_len + req.gen_len > self.max_len:
            raise ValueError(
                f"request length {req.prompt_len}+{req.gen_len} exceeds "
                f"engine max_len={self.max_len}")
        steps, used_adaptive = self._steps(chain, req.block_override)
        entry = self.scheduler.submit(SchedEntry(
            rid=req.rid, app=req.app, arrival=req.arrival,
            priority=req.priority, prompt_len=req.prompt_len,
            gen_len=req.gen_len))
        # the scheduler stamped the "submit" trace event; reuse its clock
        # reading so info timestamps and the trace timeline agree exactly
        t_submit = self.tracer.trace(req.rid).last_t("submit")
        entry.payload = (req, steps, used_adaptive, t_submit)
        return req.rid

    def step(self) -> Optional[List[ServeResult]]:
        t0 = time.perf_counter()
        self._admit()
        early, self._early = self._early, []
        if not self.active:
            if early:
                return early
            return None if not self.scheduler.waiting else []
        self._c_steps.inc()
        out = early + self._decode_step()
        self.metrics.set_gauge("active", len(self.active))
        t1 = time.perf_counter()
        self._h_step_wall.observe(t1 - t0)
        self.tracer.global_span("engine_step", t0, t1,
                                active=len(self.active),
                                finished=len(out))
        return out

    def drain(self) -> List[ServeResult]:
        out: List[ServeResult] = []
        while True:
            res = self.step()
            if res is None:
                return out
            out.extend(res)

    # -- observability exports (DESIGN.md §8) --------------------------------

    def write_trace(self, path: str) -> None:
        """Chrome ``trace_event`` JSON of every traced request + the
        engine step track; loads in chrome://tracing / Perfetto."""
        self.tracer.write_chrome_trace(path)

    def write_metrics(self, path: str) -> None:
        self.metrics.write(path)

    # -- admission: scheduler decides, executor prefills ---------------------

    def _slot_tokens(self, prompt_len: int, gen_len: int) -> int:
        """Whole-lifetime KV slot capacity for a request: prompt + output."""
        return prompt_len + gen_len

    def _fits(self, entry: SchedEntry) -> bool:
        if len(self.active) >= self.config.max_active:
            return False
        if entry.preempted:
            state, _ = entry.payload
            return self.kv.can_admit(state.steps, state.slot_tokens)
        _, steps, _, _ = entry.payload
        if entry.gen_len == 0:
            return True  # completes at admission, touches no KV
        return self.kv.can_admit(
            steps, self._slot_tokens(entry.prompt_len, entry.gen_len))

    def _admit(self):
        admitted = self.scheduler.admit(
            fits=self._fits,
            running=lambda: [self._entries[s.rid] for s in self.active],
            preempt=(self._preempt_entry if self.config.preemption else None),
            on_admit=self._place)
        if self._pending_prefill:
            # batched multi-request prefill: slots were allocated per entry
            # during admission (so fits saw true occupancy); the compute
            # runs as one padded call per (chain, length bucket)
            self.executor.prefill_batched(self._pending_prefill, self.kv)
            t = time.perf_counter()
            for s in self._pending_prefill:
                self._mark_prefilled(s, t)
            self._pending_prefill = []
        if self.scheduler.waiting and not self.active and not admitted:
            head = self.scheduler.peek()
            raise MemoryError(
                f"request rid={head.rid} can never fit in the KV pool")

    def _mark_prefilled(self, s: _ReqState, t: float) -> None:
        """Prefill completed: the first token exists now.  Records the
        ``prefill`` span boundary and the TTFT sample."""
        s.t_first_token = t
        self.tracer.event(s.rid, "prefill", t=t, prompt_len=s.prompt_len)
        self.metrics.observe("ttft_s", t - s.t_submit)

    def _place(self, entry: SchedEntry):
        if entry.preempted:
            self._resume(entry)
        elif entry.gen_len == 0:
            self._complete_empty(entry)
        else:
            self._start(entry)

    def _start(self, entry: SchedEntry):
        req, steps, used_adaptive, t_submit = entry.payload
        state = _ReqState(rid=entry.rid, app=entry.app, steps=steps,
                          gen_len=entry.gen_len, prompt_len=entry.prompt_len,
                          slot_tokens=self._slot_tokens(entry.prompt_len,
                                                        entry.gen_len),
                          prompt_tokens=np.asarray(req.prompt_tokens),
                          adaptive_blocks_used=used_adaptive,
                          t_submit=t_submit)
        if self.config.fused:
            # reserve whole-lifetime slots now — the admission loop's next
            # fits() must see them — and defer the compute so co-admitted
            # requests prefill as one batched call per (chain, bucket)
            for i, (block, _) in enumerate(steps):
                if block.has_kv:
                    _, pool = self.kv.pool_for(block)
                    pool.alloc(state.rid, i, state.slot_tokens)
            self._pending_prefill.append(state)
        else:
            self.executor.prefill(state, req.prompt_tokens, self.kv)
            self._mark_prefilled(state, time.perf_counter())
        entry.payload = state
        self._entries[entry.rid] = entry
        self.active.append(state)

    def _complete_empty(self, entry: SchedEntry):
        """gen_len=0: nothing to decode — finish at admission with empty
        output instead of entering the batch and emitting a spurious token."""
        _, _, used_adaptive, t_submit = entry.payload
        t_finish = self.tracer.event(entry.rid, "finish")
        tr = self.tracer.trace(entry.rid)
        t_admit = tr.last_t("admit")
        self.metrics.inc("completed")
        self.metrics.observe("latency_s", t_finish - t_submit)
        self._early.append(ServeResult(
            rid=entry.rid, app=entry.app,
            tokens=np.zeros(0, np.int32), probs_last=None,
            latency=t_finish - t_submit,
            info={"adaptive_blocks_used": used_adaptive,
                  "prompt_len": entry.prompt_len,
                  "t_submit": t_submit, "t_finish": t_finish,
                  "t_admit": t_admit,
                  "queue_wait_s": (t_admit - t_submit
                                   if t_admit is not None else 0.0),
                  "latency_s": t_finish - t_submit, "preemptions": 0,
                  "trace": tr.to_dict()}))

    # -- preemption: pause a resident request under memory pressure ----------

    def _preempt_entry(self, entry: SchedEntry) -> bool:
        return self.preempt(entry.rid)

    def preempt(self, rid: int, strategy: Optional[str] = None) -> bool:
        """Evict a running request's KV slots and return it to the waiting
        queue; it resumes (in policy order) once resources free up and
        continues token-exact.  ``strategy``: ``spill`` copies the pages to
        host memory, ``recalc`` drops them and replays the prefix at
        readmission, ``None`` defers to EngineConfig (``auto`` = §5.1 cost
        model).  Returns False if ``rid`` is not currently resident."""
        state = next((s for s in self.active if s.rid == rid), None)
        if state is None:
            return False
        # materialize the victim's group before touching its host state
        # (tokens/kv_len may be device-resident in a fused DecodeState)
        self.executor.sync_rid(rid)
        strategy = strategy or self.config.preempt_strategy
        if strategy == "auto":
            prefix_flops = sum(b.flops_per_token()
                               for b, _ in state.steps) * max(state.kv_len, 1)
            strategy, _ = preempt_readmit_strategy(self.kv.kv_bytes(rid),
                                                   prefix_flops)
        self.tracer.event(rid, "preempt", strategy=strategy,
                          kv_len=state.kv_len,
                          tokens_done=len(state.tokens))
        if strategy == "spill":
            snap = self.kv.spill(rid)  # KV manager logs the "spill" event
            self.metrics.inc("spills")
        else:
            self.kv.free_request(rid)
            snap = None
        self.active.remove(state)
        self.executor.invalidate_tables()
        state.preemptions += 1
        entry = self._entries.pop(rid)
        entry.preempted = True
        entry.payload = (state, snap)
        self.scheduler.submit(entry)  # keeps its seq: resumes in order
        self.metrics.inc("preemptions")
        return True

    def _resume(self, entry: SchedEntry):
        state, snap = entry.payload
        self.tracer.event(state.rid, "readmit",
                          mode="spill" if snap is not None else "recalc")
        if snap is not None:
            self.kv.restore(state.rid, snap, state.slot_tokens)
        else:
            # recompute-on-readmit: replay prompt + emitted tokens to rebuild
            # KV; the pending sampled token survives on the state untouched
            prefix = np.concatenate(
                [np.asarray(state.prompt_tokens, np.int32),
                 np.asarray(state.tokens, np.int32)])
            self.executor.prefill(state, prefix, self.kv, sample=False)
            self.tracer.event(state.rid, "recalc", tokens=len(prefix))
            self.metrics.inc("recalc_readmits")
        entry.preempted = False
        entry.payload = state
        self._entries[state.rid] = entry
        self.active.append(state)
        self.executor.invalidate_tables()  # same rid, new pages

    # -- one decode iteration over all in-flight requests -------------------

    def _decode_step(self) -> List[ServeResult]:
        ex = self.executor
        cfg = self.config
        # split finished from still-running; a device-resident request has
        # ex.buffered(rid) committed tokens not yet reflected in s.tokens
        continuing: List[_ReqState] = []
        finishing: List[_ReqState] = []
        for s in self.active:
            done = len(s.tokens) + ex.buffered(s.rid)
            (finishing if done + 1 >= s.gen_len else continuing).append(s)
        # partition the survivors into fused groups by full-chain signature
        # (§5.2 batch cap applied chain-wide); chains the fused megastep
        # cannot run fall back to the per-hop dispatch path
        fused_groups: List[List[_ReqState]] = []
        hop_states: List[_ReqState] = []
        if cfg.fused:
            for g in self.scheduler.form_chain_groups(
                    continuing, key_fn=lambda s: chain_signature(s.steps),
                    max_batch=cfg.max_block_batch):
                try:
                    ex.fused_fn(g[0].steps, chain_signature(g[0].steps))
                    fused_groups.append(g)
                except NotImplementedError:
                    hop_states.extend(g)
        else:
            hop_states = continuing
        # groups that changed membership (finish/admission) sync to host
        # here; identical groups keep their device-resident DecodeState
        ex.retire_states(keep=frozenset(
            tuple(s.rid for s in g) for g in fused_groups))
        # emit the token chosen at the previous step (prefill or decode)
        results = []
        for s in finishing:
            s.tokens.append(s.next_token)
            results.append(self._finish(s))
        if finishing:
            ex.invalidate_tables()
        self.active = continuing
        if not continuing:
            return results
        # one fused call per group runs the whole chain for one token,
        # sampling on the device
        for g in fused_groups:
            ex.fused_step(g, self.kv)
        if hop_states:
            # per-hop states emit host-side: the pending token lands in
            # s.tokens now and also seeds this step's chain walk
            for s in hop_states:
                s.tokens.append(s.next_token)
            self._run_hops(hop_states)
        # one decode_step instant per in-flight request: the host-side
        # dispatch timestamp is the per-step trace marker
        t = time.perf_counter()
        for s in continuing:
            self.tracer.event(s.rid, "decode_step", t=t)
        return results

    def _run_hops(self, states: List[_ReqState]) -> None:
        """Per-hop fallback (parity oracle): walk the chains hop-by-hop in
        lockstep; at each hop the scheduler's per-(block, adapters) run
        queues merge requests sitting on the same block into batched calls,
        capped at max_block_batch (paper §5.2), then sample on host."""
        cap = self.config.max_block_batch
        xs = self.executor.seed_tokens(states)
        cursors = {s.rid: 0 for s in states}
        by_rid = {s.rid: s for s in states}
        hop = 0
        while True:
            keys: List[Tuple] = []
            for s in states:
                if hop >= len(s.steps):
                    continue
                block, adapters = s.steps[hop]
                key = (block.id, tuple(a.id for a in adapters))
                self.scheduler.enqueue(key, 0.0, s)
                keys.append(key)
            if not keys:
                break
            for key in dict.fromkeys(keys):
                while True:
                    batch = self.scheduler.form_batch(key, 0.0, cap)
                    if not batch:
                        break
                    self.executor.run_group([b.rid for b in batch], by_rid,
                                            cursors, xs, self.kv)
            hop += 1
            for rid in cursors:
                cursors[rid] = hop
        # chain finished: lm_head output -> next token
        self.executor.sample_step(states, xs)

    def _finish(self, s: _ReqState) -> ServeResult:
        self.kv.free_request(s.rid)
        self._entries.pop(s.rid, None)
        t_finish = self.tracer.event(s.rid, "finish",
                                     tokens=len(s.tokens),
                                     preemptions=s.preemptions)
        tr = self.tracer.trace(s.rid)
        t_admit = tr.first_t("admit")
        ttft = (s.t_first_token - s.t_submit
                if s.t_first_token is not None else None)
        self.metrics.inc("completed")
        self.metrics.inc("tokens_emitted", len(s.tokens))
        self.metrics.observe("latency_s", t_finish - s.t_submit)
        return ServeResult(
            rid=s.rid, app=s.app,
            tokens=np.asarray(s.tokens, np.int32),
            probs_last=s.probs_last,
            latency=t_finish - s.t_submit,
            info={"adaptive_blocks_used": s.adaptive_blocks_used,
                  "prompt_len": s.prompt_len,
                  "t_submit": s.t_submit, "t_finish": t_finish,
                  "t_admit": t_admit,
                  "t_first_token": s.t_first_token,
                  "ttft_s": ttft,
                  "queue_wait_s": (t_admit - s.t_submit
                                   if t_admit is not None else 0.0),
                  "latency_s": t_finish - s.t_submit,
                  "preemptions": s.preemptions,
                  "trace": tr.to_dict()})

    # -- legacy batch API (sequential semantics preserved) -------------------

    def generate(self, chain: BlockChain, prompt_tokens, gen_len: int,
                 *, block_override: Optional[Dict[str, str]] = None
                 ) -> GenerationResult:
        """prompt_tokens: (B, S) int32.  Runs the rows through the
        continuous-batching core as one submitted batch; greedy decode."""
        prompt_tokens = np.asarray(prompt_tokens)
        B = prompt_tokens.shape[0]
        rids = []
        for b in range(B):
            req = ServeRequest(app=chain.model, gen_len=gen_len,
                               prompt_tokens=prompt_tokens[b],
                               block_override=block_override)
            rids.append(self._submit_chain(req, chain))
        results = {r.rid: r for r in self.drain() if r.rid in set(rids)}
        tokens = np.stack([results[r].tokens for r in rids], axis=0)
        # gen_len=0 completes at admission with no sampled distribution;
        # tokens is a clean (B, 0) and probs_last stays None
        probs_list = [results[r].probs_last for r in rids]
        probs = (np.stack(probs_list, axis=0)
                 if all(p is not None for p in probs_list) else None)
        used = results[rids[0]].info["adaptive_blocks_used"]
        return GenerationResult(tokens=tokens, probs_last=probs,
                                adaptive_blocks_used=used)
