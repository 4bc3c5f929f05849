"""Real-execution serving engine: glue over the three-layer serving core
(DESIGN.md §2) — the port of ``repro.serving.engine``.

``BlockEngine`` implements the unified ``Server`` API (submit / step /
drain) by wiring together:

- the **scheduler** (``repro_torch.serving.scheduler.Scheduler``), which
  owns the waiting queue, priority/FCFS admission order, per-(block,
  adapters) run queues and preemption decisions;
- the **executor** (``repro_torch.serving.executor.BlockExecutor``), which
  owns the fused chain megastep, its merged walk over the lanes of every
  app whose chain shares blocks (cross-app per-block batching, paper
  §5.2), the per-hop fallback and sampling;
- the **KV manager** (``repro_torch.serving.kv_pool.KVManager``), which owns
  the shared paged pools, admission planning, and slot preemption with the
  §5.1 transfer-vs-recalc cost model deciding spill-to-host versus
  recompute-on-readmit.

The engine itself only resolves chains, runs the admission/decode loop,
and translates between ``ServeRequest``/``ServeResult`` and the layers.

Speculative decoding (``EngineConfig.speculation``, paper §5.2): fused
groups whose chain signature passes the surrogate gates run the
draft-verify megastep (``BlockExecutor.spec_step``), committing up to
``spec_lookahead`` tokens per call, bitwise the plain greedy stream.

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

from repro_torch.core import prng
from repro_torch.core.blocks import (
    ATTENTION_KINDS,
    Block,
    BlockChain,
    chain_signature,
)
from repro_torch.core.equivalence import vocab_probability_similarity
from repro_torch.core.surrogates import surrogate_fidelity
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
    attn_impl: str = "auto"     # every kernel of the port (paged decode
    #   attention, flash prefill attention, batched LoRA): auto = the CUDA
    #   kernels on the card and the JAX package's plain code on the CPU;
    #   ref = the kernels' plain PyTorch versions; cuda = the kernels
    policy: str = "fcfs"        # admission order: fcfs | priority
    preemption: bool = True     # pressure-driven slot eviction (priority)
    preempt_strategy: str = "auto"  # auto | spill | recalc (§5.1)
    fused: bool = True          # fused chain-step megastep + batched prefill
    #   (False = per-hop dispatch path, kept as the parity oracle)
    # -- speculative execution (paper §5.2, draft-verify, verify-exact) ------
    speculation: bool = False   # draft with FFN-only surrogates, verify exact
    spec_lookahead: int = 4     # tokens per speculative megastep (1 + drafts)
    spec_min_accept: float = 0.1    # disable a signature below this EMA
    spec_prune_ratio: float = 0.25  # surrogate FFN prune ratio
    spec_min_fidelity: float = 0.9  # probe fidelity gate at surrogate build
    spec_churn_steps: int = 4   # spec pause (engine steps) after a preemption
    spec_retry_steps: int = 32  # cooldown before retrying a disabled sig
    spec_ema_alpha: float = 0.2  # accept-rate EMA smoothing
    device: str = "cuda"        # where the pools live and compute runs
    compute_dtype: str = "bfloat16"  # activations and KV pools


@dataclass
class _SpecSig:
    """Per-chain-signature speculation state: the surrogate draft chain and
    the live gating variables (DESIGN.md §2, paper §5.2)."""
    sur_steps: List[Tuple[Block, Tuple[Block, ...]]]
    fidelity: float             # min probe fidelity over pruned hops
    enabled: bool
    ema: float = 1.0            # accept-rate EMA (starts optimistic)
    cooldown: int = 0           # engine steps until a disabled sig retries




@dataclass
class _ReqState:
    rid: int
    app: str
    steps: List[Tuple[Block, Tuple[Block, ...]]]  # resolved (block, adapters)
    gen_len: int
    prompt_len: int
    slot_tokens: int = 0        # KV slot capacity (adds spec lookahead room)
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
        if c.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {c.attn_impl!r} selects the kernels; "
                             f"one of {ATTN_IMPLS}")
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
                     "host_syncs", "attn_calls", "prefill_attn_calls",
                     "lora_calls", "preemptions", "spills",
                     "recalc_readmits", "completed", "tokens_emitted",
                     "spec_attempts", "spec_hits", "probe_attn_calls",
                     # step-span counters (ns, and prompt positions)
                     "dispatch_ns", "host_wait_ns", "prefill_ns",
                     "prefill_tokens", "prefill_padded_tokens",
                     # megastep graphs (BlockExecutor.fused_step)
                     "graph_replays", "graph_captures", "graph_lanes",
                     "graph_real_lanes",
                     # plain fused lanes, and those of merged walks
                     "fused_lanes", "merged_lanes"):
            self.metrics.counter(name)  # pre-register: snapshots start at 0
        self.metrics.set_gauge("max_block_batch", c.max_block_batch)
        self.metrics.set_gauge("spec_accept_rate", 0.0)
        # legacy dict-shaped view: engine.stats[k] reads the counter values
        self.stats = self.metrics.counters_view()
        self._c_steps = self.metrics.counter("steps")
        # host time inside the megastep calls (executor.megastep spans)
        self._c_dispatch_ns = self.metrics.counter("dispatch_ns")
        self._h_step_wall = self.metrics.histogram("step_wall_s")
        self.scheduler = Scheduler(policy=c.policy, tracer=self.tracer,
                                   metrics=self.metrics)
        # spec steps write drafts up to lookahead-1 positions past the
        # committed length, so slots need that much headroom: a write past
        # a slot's last page would land on the trash page (or, in a table
        # the group pads wider, on no page of the row at all)
        self._spec_headroom = c.spec_lookahead if c.speculation else 0
        pages_per_seq = -(-(max_len + self._spec_headroom) // c.page_size)
        # the megastep graphs' tables hold a slot, their lanes a group
        self.executor = BlockExecutor(attn_impl=c.attn_impl,
                                      metrics=self.metrics,
                                      tracer=self.tracer,
                                      compute_dtype=self.compute_dtype,
                                      device=self.device,
                                      table_width=pages_per_seq,
                                      max_lanes=c.max_block_batch)
        num_pages = c.num_pages or (
            1 + c.max_active * pages_per_seq * self._max_attn_steps())
        self.kv = KVManager(c.page_size, num_pages, dtype=self.compute_dtype,
                            device=self.device, metrics=self.metrics,
                            tracer=self.tracer)
        self.active: List[_ReqState] = []
        self._entries: Dict[int, SchedEntry] = {}  # rid -> running lifecycle
        self._early: List[ServeResult] = []        # gen_len=0 completions
        self._pending_prefill: List[_ReqState] = []  # admitted, not prefilled
        # per-chain-signature speculation state + global churn gate
        self._spec: Dict[Tuple, _SpecSig] = {}
        self._probes: Dict[int, torch.Tensor] = {}  # d_in -> fidelity probe
        self._spec_churn = 0   # engine steps speculation stays off after
        #   a preemption (device-resident groups just re-formed; drafting
        #   into freshly moved KV slots amplifies thrash)
        self._c_spec_attempts = self.metrics.counter("spec_attempts")
        self._c_spec_hits = self.metrics.counter("spec_hits")
        # attention calls of the fidelity probe: block and surrogate, each
        # a prefill attention (the flash kernel on the card)
        self._c_probe_attn_calls = self.metrics.counter("probe_attn_calls")

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
        """One engine step, recorded as the root ``engine.step`` span with
        children ``engine.admit``, ``executor.prefill``,
        ``executor.retire``, ``engine.finish`` and one
        ``executor.megastep`` per group call (``executor.wait`` spans
        inside whichever of them blocks on the device)."""
        t0 = time.perf_counter()
        with self.tracer.span("engine.step") as sid:
            self._admit()
            early, self._early = self._early, []
            if not self.active:
                if early:
                    return early
                return None if not self.scheduler.waiting else []
            self._c_steps.inc()
            out = early + self._decode_step()
            self.tracer.note(sid, step=self._c_steps.value,
                             active=len(self.active), finished=len(out))
        self.metrics.set_gauge("active", len(self.active))
        self._h_step_wall.observe(time.perf_counter() - t0)
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
        """Whole-lifetime KV slot capacity for a request: prompt + output
        plus speculative-write headroom when speculation is on."""
        return prompt_len + gen_len + self._spec_headroom

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
        with self.tracer.span("engine.admit") as sid:
            admitted = self.scheduler.admit(
                fits=self._fits,
                running=lambda: [self._entries[s.rid] for s in self.active],
                preempt=(self._preempt_entry if self.config.preemption
                         else None),
                on_admit=self._place)
            self.tracer.note(sid, admitted=len(admitted))
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
        # preemption churn pauses speculation: groups are about to re-form
        # and drafting into freshly migrated KV amplifies thrash (§5.2)
        self._spec_churn = self.config.spec_churn_steps
        return True

    def _resume(self, entry: SchedEntry):
        state, snap = entry.payload
        self.tracer.event(state.rid, "readmit",
                          mode="spill" if snap is not None else "recalc")
        if snap is not None:
            self.kv.restore(state.rid, snap, state.slot_tokens)
        else:
            # recompute-on-readmit: prefill the prompt, then rebuild each
            # emitted position through the decode megastep that first wrote
            # it (the reference replays both through prefill), so the KV is
            # bitwise what it was wherever a GEMM row does not depend on the
            # call's row count; the pending sampled token stays on the state
            emitted = np.asarray(state.tokens, np.int32)
            self.executor.prefill(state, state.prompt_tokens, self.kv,
                                  sample=False)
            self.executor.replay(state, emitted, self.kv)
            self.tracer.event(state.rid, "recalc", tokens=state.kv_len,
                              prefilled=state.prompt_len,
                              replayed=len(emitted))
            self.metrics.inc("recalc_readmits")
        entry.preempted = False
        entry.payload = state
        self._entries[state.rid] = entry
        self.active.append(state)
        self.executor.invalidate_tables()  # same rid, new pages

    # -- speculative execution: surrogate draft chains (paper §5.2) ----------

    def _spec_state(self, sig: Tuple, steps) -> _SpecSig:
        """Lazily build the surrogate draft chain for a chain signature:
        FFN-only surrogates (KV layout preserved, so drafts share the full
        chain's pools) from the zoo's bounded cache, fidelity-probed per
        pruned hop; a signature starts enabled only when the worst hop
        clears ``spec_min_fidelity``."""
        ss = self._spec.get(sig)
        if ss is not None:
            return ss
        c = self.config
        sur_steps: List[Tuple[Block, Tuple[Block, ...]]] = []
        fidelity = 1.0
        pruned = 0
        for block, adapters in steps:
            if "w_gate" in block.params:
                sid = self.zoo.surrogate_for(block.id, c.spec_prune_ratio,
                                             prune_kv=False)
                sur = self.zoo.blocks[sid]
                fidelity = min(fidelity, surrogate_fidelity(
                    block, sur, self._probe(block.d_in)))
                self._c_probe_attn_calls.inc(
                    2 * (block.kind in ATTENTION_KINDS))
                sur_steps.append((sur, adapters))
                pruned += 1
            else:
                sur_steps.append((block, adapters))
        enabled = pruned > 0 and fidelity >= c.spec_min_fidelity
        ss = _SpecSig(sur_steps=sur_steps, fidelity=fidelity,
                      enabled=enabled)
        self._spec[sig] = ss
        return ss

    def _probe(self, d_in: int) -> torch.Tensor:
        """The fidelity probe the reference draws: 0.1 * N(0, 1) hidden
        states of shape (1, 8, d_in) from ``PRNGKey(0)``, drawn on the host
        once per width and moved to the device once."""
        probe = self._probes.get(d_in)
        if probe is None:
            x = np.float32(0.1) * prng.normal(prng.PRNGKey(0), (1, 8, d_in))
            probe = self._probes[d_in] = torch.from_numpy(x).to(
                device=self.device, dtype=self.compute_dtype)
        return probe

    def _tick_spec_gates(self) -> None:
        """Advance the per-step speculation gates: churn pause countdown and
        disabled-signature retry cooldowns (retry resets the EMA so one bad
        streak does not permanently forfeit the speedup)."""
        if self._spec_churn > 0:
            self._spec_churn -= 1
        c = self.config
        for ss in self._spec.values():
            if not ss.enabled and ss.cooldown > 0:
                ss.cooldown -= 1
                if ss.cooldown == 0 and ss.fidelity >= c.spec_min_fidelity:
                    ss.enabled = True
                    ss.ema = 1.0

    # -- one decode iteration over all in-flight requests -------------------

    def _decode_step(self) -> List[ServeResult]:
        ex = self.executor
        cfg = self.config
        self._tick_spec_gates()
        # split finished from still-running; a device-resident request has
        # ex.buffered(rid) committed tokens not yet reflected in s.tokens
        continuing: List[_ReqState] = []
        finishing: List[_ReqState] = []
        rem: Dict[int, int] = {}  # tokens still to commit (incl. pending)
        for s in self.active:
            done = len(s.tokens) + ex.buffered(s.rid)
            rem[s.rid] = s.gen_len - done
            (finishing if done + 1 >= s.gen_len else continuing).append(s)
        # a lane can speculate when its signature is enabled and it has
        # budget for at least one draft attempt (rem >= 3: the pending
        # token, one draft, and the final token that must stay pending)
        spec_on = (cfg.speculation and cfg.fused and self._spec_churn == 0)

        def _eligible(s: _ReqState) -> bool:
            return (rem[s.rid] >= 3
                    and self._spec_state(chain_signature(s.steps),
                                         s.steps).enabled)

        # partition the survivors into fused groups by full-chain signature
        # (§5.2 batch cap applied chain-wide), refined by speculation
        # eligibility so each group steps uniformly; chains the fused
        # megastep cannot run fall back to the per-hop dispatch path.  The
        # plain groups of chains that align and share weights then merge
        # into one group per set of such chains: one walk of their lanes
        # reads each shared block once a step (per-block batching across
        # apps, §5.2); speculative groups stay per chain
        fused_groups: List[Tuple[List[_ReqState], bool]] = []
        hop_states: List[_ReqState] = []
        if cfg.fused:
            plain: List[List[_ReqState]] = []
            for g in self.scheduler.form_chain_groups(
                    continuing, key_fn=lambda s: chain_signature(s.steps),
                    max_batch=cfg.max_block_batch,
                    subkey_fn=_eligible if spec_on else None):
                try:
                    ex.fused_fn(g[0].steps, chain_signature(g[0].steps))
                except NotImplementedError:
                    hop_states.extend(g)
                    continue
                if spec_on and _eligible(g[0]):
                    fused_groups.append((g, True))
                else:
                    plain.append(g)
            fused_groups += [(g, False) for g in self._merge_plain(plain)]
        else:
            hop_states = continuing
        # groups that changed membership (finish/admission) sync to host
        # here; identical groups keep their device-resident DecodeState
        keep = frozenset(tuple(s.rid for s in g) for g, _ in fused_groups)
        with self.tracer.span("executor.retire",
                              groups=len(ex.decode_states.keys() - keep)):
            ex.retire_states(keep=keep)
        # emit the token chosen at the previous step (prefill or decode)
        results = []
        with self.tracer.span("engine.finish", n=len(finishing)):
            for s in finishing:
                s.tokens.append(s.next_token)
                results.append(self._finish(s))
            if finishing:
                ex.invalidate_tables()
        self.active = continuing
        if not continuing:
            return results
        # one fused call per group runs the whole chain for one token (or,
        # speculating, up to spec_lookahead tokens drafted by the surrogate
        # chain and verified exactly), sampling on the device
        for g, spec in fused_groups:
            apps = ",".join(dict.fromkeys(s.app for s in g))
            with self.tracer.span("executor.megastep",
                                  add_to=self._c_dispatch_ns, app=apps,
                                  B=len(g), spec=spec):
                if spec:
                    self._spec_group_step(g, rem)
                else:
                    ex.fused_step(g, self.kv)
        if hop_states:
            # per-hop states emit host-side: the pending token lands in
            # s.tokens now and also seeds this step's chain walk
            for s in hop_states:
                s.tokens.append(s.next_token)
            self._run_hops(hop_states)
        return results

    def _merge_plain(self, groups: List[List[_ReqState]]
                     ) -> List[List[_ReqState]]:
        """The plain fused groups, with those of each set of chains that
        ``BlockExecutor.merge_sets`` walks together made one: their lanes
        in group order, so each chain's lanes stay together and in order,
        cut at ``max_block_batch``.  The other groups stay as they were."""
        if len(groups) < 2:
            return groups
        sigs = [chain_signature(g[0].steps) for g in groups]
        chains = dict(zip(sigs, (g[0].steps for g in groups)))
        sets = self.executor.merge_sets(list(chains.items()))
        if not sets:
            return groups
        where = {sig: k for k, members in enumerate(sets) for sig in members}
        lanes: List[List[_ReqState]] = [[] for _ in sets]
        out = []
        for sig, g in zip(sigs, groups):
            if sig in where:
                lanes[where[sig]].extend(g)
            else:
                out.append(g)
        cap = self.config.max_block_batch
        for members in lanes:
            out += [members[i:i + cap] for i in range(0, len(members), cap)]
        return out

    def _spec_group_step(self, g: List[_ReqState], rem: Dict[int, int]
                         ) -> None:
        """Run one speculative megastep for a fused group and feed the
        outcome back into the per-signature gate: per-lane budgets keep the
        pending-token finish protocol intact, the accept-rate EMA updates
        from the realized hit rate, and a signature whose EMA falls below
        ``spec_min_accept`` is disabled with a retry cooldown."""
        cfg = self.config
        sig = chain_signature(g[0].steps)
        ss = self._spec[sig]
        budgets = [rem[s.rid] - 1 for s in g]
        att, acc, cnt = self.executor.spec_step(
            g, self.kv, ss.sur_steps, cfg.spec_lookahead, budgets)
        for i, s in enumerate(g):
            self.tracer.event(s.rid, "spec", attempts=int(att[i]),
                              accepted=int(acc[i]), committed=int(cnt[i]))
        total_att = int(att.sum())
        if total_att:
            rate = float(acc.sum()) / total_att
            a = cfg.spec_ema_alpha
            ss.ema = (1.0 - a) * ss.ema + a * rate
            if ss.ema < cfg.spec_min_accept:
                ss.enabled = False
                ss.cooldown = cfg.spec_retry_steps
        if self._c_spec_attempts.value:
            self.metrics.set_gauge(
                "spec_accept_rate",
                self._c_spec_hits.value / self._c_spec_attempts.value)

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


def adaptive_serving_similarity(zoo: BlockZoo, engine: BlockEngine,
                                app: str, prompt_tokens, gen_len: int = 8
                                ) -> Tuple[float, int]:
    """Paper Fig. 20: serve a request on its own chain vs an adaptively
    adjusted chain (each block with an equivalence edge swapped for its
    most equivalent block); cosine similarity of the output vocabulary
    probabilities.  Returns (similarity, blocks swapped)."""
    chain = zoo.chains[app]
    override = {}
    for step in chain.steps:
        eqs = zoo.equivalent_blocks(step.block_id)
        if eqs:
            override[step.block_id] = max(eqs, key=lambda e: e[1])[0]
    base = engine.generate(chain, prompt_tokens, gen_len)
    if not override:
        return 1.0, 0
    alt = engine.generate(chain, prompt_tokens, gen_len,
                          block_override=override)
    sim = vocab_probability_similarity(base.probs_last[:, None],
                                       alt.probs_last[:, None])
    return sim, len(override)
