"""Numerics layer of the serving stack (DESIGN.md §2) — the port of
``repro.serving.executor``.

``BlockExecutor`` owns everything that touches device compute for the
real-execution plane: the fused per-chain-signature megastep (one call per
group per token: embedding -> every attention/MLP/adapter hop with paged-KV
decode and an in-place K/V scatter -> lm_head -> greedy argmax/softmax on
the device), device-resident ``DecodeState`` kept across steps, batched
multi-request prefill, and — as the parity oracle and heterogeneous-tail
fallback — per-(block, adapters) calls with per-hop group batching
(cross-app batching on shared foundation blocks, paper §5.2).  It holds no
request lifecycle: the ``Scheduler`` decides *what* runs and the
``KVManager`` decides *where* KV lives; the executor decides *how* it runs.

PyTorch runs eagerly, so the reference's jitted-function caches become
plain closures; the pool slabs are written in place where the reference
donates them.  Host syncs are counted where the reference counts them:
once per ``device_get``-equivalent batch of copies to the host.

Each prefill call is an ``executor.prefill`` span, and each copy that
blocks the host on the device an ``executor.wait`` span: every copy to
the host, and the host-to-device staging of a prefill's prompts and of a
new group's decode state (a copy from pageable host memory waits for the
stream to drain).  Their durations add to ``prefill_ns`` and
``host_wait_ns``; ``prefill_tokens`` counts prompt positions and
``prefill_padded_tokens`` the positions the calls ran, buckets included.

Merged megastep (per-block batching across apps, paper §5.2).  The
engine hands ``fused_step`` one group over the plain lanes of every chain
that ``merge_sets`` finds aligned with the others and sharing a weight
with them: a ``MergedChains`` walk (``core/blocks.py``) serves them all in
one call, each weight set read once, each lane tagged with its chain
(``lane_chain``) and keeping its own chain's outputs where the chains'
weights differ.  A group of one chain runs its own chain's megastep, as
do speculative groups.  Counters: ``fused_lanes`` (real lanes of every
plain fused group call) and ``merged_lanes`` (those of calls that walked
more than one chain).

Megastep graphs.  A fused group runs its megastep over the static buffers
of a ``MegastepGraph``, one per (key, lane bucket), the key being the
group's chain signature or, for a merged group, ``("merged", its sorted
chain signatures)``: the group's lanes padded to a power of two of at
least 8, or to ``max_lanes`` where that is fewer, its page tables to
``table_width`` pages, and a merged group's lanes tagged with their
chains in one more int32 row.  So a merged group's lanes may be in any
mix of its chains without another capture.  Pad lanes hold token 0, kv
length 0 and tables of ``TRASH_PAGE``, and their kv length stays 0, so
they write only the trash page.  The step writes its next tokens and
``kv_len + 1`` back into the buffers, so a stable group's state stays
there; a group that re-forms is staged into them again.  On a card, the
first call of a bucket runs the megastep eagerly on a side stream (which
also fills every host-side cache) and then captures it as a CUDA graph in
the executor's memory pool; later calls replay the graph: the same
kernels, the same work, no host issue.  On the CPU a replay calls the
megastep on the buffers.  A key's buckets share one probabilities
buffer, so a key binds one live group at a time: a second live group of
the key, speculative steps, and groups with a row wider than
``table_width`` run the eager megastep.  A replay adds the launches its
graph recorded to the kernel modules' ``launches`` counters, and a
capture takes back the ones it recorded without running them.
Counters: ``graph_replays`` (group calls served by a replay),
``graph_captures`` (a bucket's first call), ``graph_lanes`` (lanes the
replays ran, pads included) and ``graph_real_lanes``.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.blocks import (
    Block,
    ChainLayout,
    MergedChains,
    apply_block,
    block_decode_paged,
    block_prefill_raw,
    chain_decode_fused,
    chain_decode_spec_fused,
    chain_layout,
    chain_prefill_fused,
    chain_signature,
)
from repro_torch.kernels.batched_lora import kernel as lora_kernel
from repro_torch.kernels.paged_attention import kernel as pa_kernel
from repro_torch.models import layers as L
from repro_torch.observability.metrics import MetricsRegistry
from repro_torch.observability.trace import Tracer
from repro_torch.serving.kv_pool import TRASH_PAGE, KVManager

# the hand-written kernels a megastep launches: a graph's replay adds the
# launches it holds to their modules' counters
_GRAPH_KERNELS = (pa_kernel, lora_kernel)


def _bucket(n: int, lo: int = 8) -> int:
    """Pad-to-bucket prompt length: next power of two, floor ``lo`` — bounds
    the number of distinct prefill shapes per chain."""
    b = lo
    while b < n:
        b *= 2
    return b


def _lora_projections(steps) -> int:
    """q and v LoRA projections one call of ``steps`` issues."""
    return 2 * sum(1 for b, adapters in steps if b.has_kv
                   for a in adapters if a.kind == "lora")


@dataclass
class DecodeState:
    """Device-resident decode state for one fused group (DESIGN.md §2).

    While a group's membership is stable, its pending next-token ids, kv
    lengths and emitted-token backlog live on the device; nothing syncs to
    the host until a member finishes, is preempted, or the group re-forms.
    ``states`` are the engine's per-request records (duck-typed: ``rid``,
    ``tokens``, ``next_token``, ``probs_last``, ``kv_len``).

    ``emitted`` entries are ``(tokens, counts)`` draft/commit buffers: a
    device ``(B, c)`` token block plus the host ``(B,)`` per-lane count of
    how many of its columns committed.  A plain fused step appends a
    one-column block with count 1 everywhere; a speculative step appends
    its ``(B, lookahead)`` commit candidates with the per-lane accepted
    counts.  ``buffered_counts`` mirrors the running per-lane totals on
    the host so the engine's finish logic sees exact progress without
    materializing the token backlog.
    """
    rids: Tuple[int, ...]
    sig: Tuple
    states: List              # engine request states, group order
    next_token: torch.Tensor  # (B,) pending sampled token, not yet emitted
    kv_len: torch.Tensor      # (B,) tokens cached, tracked on the device
    tables: Tuple[torch.Tensor, ...]  # staged (B, n) page table per attn hop
    kv_len0: List[int]        # host kv_len at creation (host mirror base)
    emitted: List[Tuple[torch.Tensor, np.ndarray]] = field(
        default_factory=list)
    buffered_counts: List[int] = field(default_factory=list)  # per lane
    probs: Optional[torch.Tensor] = None  # (B, V) probs of latest next_token
    graph: Optional["MegastepGraph"] = None  # the bucket it is bound to
    walk: Tuple = ()          # (fn, pool_keys, attn calls, LoRA calls) a call
    lane_chain: Optional[torch.Tensor] = None  # (B,) of a merged group


@dataclass
class MegastepGraph:
    """Static decode state of one (key, lane bucket) and, on a card, the
    CUDA graph of the megastep over it.  ``ints`` is one int32
    buffer, so a forming group is staged in one copy; the other int32
    tensors are views into it."""
    lanes: int                        # the bucket: lanes the step runs
    ints: torch.Tensor                # tables, tokens, kv_len, live, and
    #   for a merged group lane_chain
    tables: Tuple[torch.Tensor, ...]  # (lanes, W) page table per attn hop
    tokens: torch.Tensor              # (lanes,) pending tokens, then next
    kv_len: torch.Tensor              # (lanes,) cached, then kv_len + 1
    live: torch.Tensor                # (lanes,) 1 on a real lane, 0 on a pad
    probs: torch.Tensor               # (lanes, V) fp32: rows of the key's
    #   buffer, which every bucket of the key shares
    lane_chain: Optional[torch.Tensor] = None  # (lanes,) a merged group's
    #   lanes' chains (pads: 0)
    graph: Optional[object] = None    # torch.cuda.CUDAGraph, once captured
    keep: Tuple = ()                  # other buffers the graph points into
    launches: Tuple[int, ...] = ()    # per _GRAPH_KERNELS, what it holds
    ready: bool = False               # its first call has run
    views: Tuple[torch.Tensor, ...] = ()  # the bound group's rows: tokens,
    #   kv_len, probs


class BlockExecutor:
    """Fused chain execution, per-hop fallback, batching and sampling."""

    def __init__(self, attn_impl: str = "auto",
                 metrics: Optional[MetricsRegistry] = None,
                 compute_dtype: torch.dtype = L.COMPUTE_DTYPE,
                 device="cuda", tracer: Optional[Tracer] = None, *,
                 table_width: int, max_lanes: int):
        """``table_width``: pages per row of a megastep graph's page
        tables, the most a slot can hold; ``max_lanes``: the most lanes a
        fused group has, the largest bucket.  The executor serves one
        ``KVManager``: a graph keeps the pool slabs it was captured on."""
        self.attn_impl = attn_impl
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer()
        # typed handles held once — the decode hot loop pays one attribute
        # add per event, not a registry lookup (DESIGN.md §8)
        self._c_prefills = self.metrics.counter("prefills")
        self._c_decode_tokens = self.metrics.counter("decode_tokens")
        self._c_group_calls = self.metrics.counter("group_calls")
        self._c_host_syncs = self.metrics.counter("host_syncs")
        self._c_spec_attempts = self.metrics.counter("spec_attempts")
        self._c_spec_hits = self.metrics.counter("spec_hits")
        # paged-attention calls issued (one per attention hop per call): the
        # number of kernel launches the decode path should account for
        self._c_attn_calls = self.metrics.counter("attn_calls")
        # prefill attention calls (one per attention hop per prefill call)
        # and LoRA projections (q and v: two per LoRA hop per call, prefill
        # and decode): the flash and batched-LoRA kernels' launches
        self._c_prefill_attn_calls = self.metrics.counter("prefill_attn_calls")
        self._c_lora_calls = self.metrics.counter("lora_calls")
        # step-span counters: host ns in prefill calls and blocked on the
        # device, and a prefill's real and padded prompt positions
        self._c_prefill_ns = self.metrics.counter("prefill_ns")
        self._c_host_wait_ns = self.metrics.counter("host_wait_ns")
        self._c_prefill_tokens = self.metrics.counter("prefill_tokens")
        self._c_prefill_padded = self.metrics.counter("prefill_padded_tokens")
        # megastep graphs: group calls a replay served, buckets' first
        # calls, and the lanes the replays ran, pads included, and real
        self._c_graph_replays = self.metrics.counter("graph_replays")
        self._c_graph_captures = self.metrics.counter("graph_captures")
        self._c_graph_lanes = self.metrics.counter("graph_lanes")
        self._c_graph_real = self.metrics.counter("graph_real_lanes")
        # real lanes of the plain fused group calls, and of those that
        # walked the lanes of more than one chain
        self._c_fused_lanes = self.metrics.counter("fused_lanes")
        self._c_merged_lanes = self.metrics.counter("merged_lanes")
        # per-block batch occupancy: every batched device call observes its
        # batch width (compare p50/mean against EngineConfig.max_block_batch)
        self._h_group_batch = self.metrics.histogram("group_batch")
        self._block_fns: Dict[Tuple, object] = {}
        # fused megastep per chain signature: (fn, pool_keys, n_attn_hops)
        self._fused_fns: Dict[Tuple, Tuple[object, Tuple, int]] = {}
        # speculative megastep per (chain sig, surrogate sig, lookahead)
        self._spec_fns: Dict[Tuple, Tuple[object, Tuple, int]] = {}
        # merged megastep per ("merged", sorted chain sigs): (fn, pool_keys,
        # plan); each chain's layout; the merge sets per tuple of chains
        self._merged_fns: Dict[Tuple, Tuple[object, Tuple, MergedChains]] = {}
        self._layouts: Dict[Tuple, Optional[ChainLayout]] = {}
        self._merge_sets: Dict[Tuple, List[Tuple]] = {}
        # device-resident decode state per fused group, keyed by rid tuple
        self.decode_states: Dict[Tuple[int, ...], DecodeState] = {}
        self._rid_group: Dict[int, Tuple[int, ...]] = {}
        # per-hop path: a group's block table is constant between membership
        # changes: LRU cache per (rids, hop); the engine invalidates on
        # finish/preempt/restore and the cap bounds membership churn
        self.table_cache_max = 128
        self._table_cache: OrderedDict[Tuple, torch.Tensor] = OrderedDict()
        self.table_width = table_width
        self.max_lanes = max_lanes
        # megastep graphs per (key, lane bucket); each key's (max_lanes, V)
        # fp32 probabilities buffer, shared by its buckets; the keys a live
        # group is bound to; on a card, the graphs' memory pool and capture
        # stream
        self.graphs: Dict[Tuple, MegastepGraph] = {}
        self._graph_probs: Dict[Tuple, torch.Tensor] = {}
        self._bound: set = set()
        self._graph_pool = None
        self._capture_stream = None

    def _count_prefill(self, steps) -> None:
        """Count one prefill call's attention hops and LoRA projections."""
        self._c_prefill_attn_calls.inc(sum(b.has_kv for b, _ in steps))
        self._c_lora_calls.inc(_lora_projections(steps))

    def _wait(self, what: str):
        """Span (``executor.wait``) around a copy that blocks the host."""
        return self.tracer.span("executor.wait", add_to=self._c_host_wait_ns,
                                what=what)

    def _prefill_span(self, app: str, rids, bucket: int, tokens: int):
        """Span (``executor.prefill``) around one prefill call of
        ``len(rids)`` prompts of ``tokens`` positions in all, each run at
        ``bucket`` positions."""
        padded = len(rids) * bucket
        self._c_prefill_tokens.inc(tokens)
        self._c_prefill_padded.inc(padded)
        return self.tracer.span("executor.prefill", add_to=self._c_prefill_ns,
                                app=app, B=len(rids), bucket=bucket,
                                rids=list(rids), tokens=tokens, padded=padded)

    def invalidate_tables(self) -> None:
        self._table_cache.clear()

    def _tensor(self, data, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(data), dtype=dtype,
                               device=self.device)

    # -- per-block executors (per-hop fallback / parity oracle) --------------

    def block_fn(self, block: Block, adapters: Tuple[Block, ...]):
        key = (block.id, tuple(a.id for a in adapters))
        fn = self._block_fns.get(key)
        if fn is not None:
            return fn
        impl, dtype = self.attn_impl, self.compute_dtype
        if block.has_kv:
            if block.cfg.sliding_window:
                raise NotImplementedError(
                    "paged decode does not support sliding-window blocks")

            def fn(x, k_pages, v_pages, tables, kv_len):
                # the slabs are written in place (the reference donates them)
                return block_decode_paged(block, x, k_pages, v_pages, tables,
                                          kv_len, adapters=adapters,
                                          attn_impl=impl, compute_dtype=dtype)
        else:

            def fn(x):
                return apply_block(block, x, adapters=adapters,
                                   compute_dtype=dtype)

        self._block_fns[key] = fn
        return fn

    # -- prefill -------------------------------------------------------------

    def prefill(self, state, tokens: np.ndarray, kv: KVManager, *,
                sample: bool = True) -> None:
        """Run ``tokens`` through the chain, allocating whole-lifetime slots
        and scattering raw K/V into the pools.  With ``sample=False`` the
        lm_head output is discarded — the recompute-on-readmit path rebuilds
        KV for an already-sampled prefix and must keep the pending token."""
        S = len(tokens)
        with self._prefill_span(state.app, [state.rid], S, S):
            with self._wait("stage"):
                x = self._tensor(tokens)[None]  # (1, S), unpadded
            self._count_prefill(state.steps)
            for i, (block, adapters) in enumerate(state.steps):
                x, k_r, v = block_prefill_raw(
                    block, x, adapters=adapters, attn_impl=self.attn_impl,
                    compute_dtype=self.compute_dtype)
                if k_r is not None:
                    _, pool = kv.pool_for(block)
                    if (state.rid, i) not in pool.slots:
                        pool.alloc(state.rid, i, state.slot_tokens)
                    pool.write_prefill(state.rid, i, k_r, v)
            state.kv_len = S
            if sample:
                logits = x[0, -1]
                with self._wait("prefill"):
                    state.next_token = int(torch.argmax(logits))
                    state.probs_last = torch.softmax(
                        logits.float(), -1).cpu().numpy()
                self._c_host_syncs.inc()
            self._c_prefills.inc()

    def replay(self, state, tokens: np.ndarray, kv: KVManager) -> None:
        """Rebuild the KV of ``tokens`` (already emitted, so already
        sampled) after the cached ``state.kv_len`` positions, teacher-forced
        through the plain decode megastep: token j is written at position
        kv_len + j by the same call that first wrote it, at a batch of one.
        Writes KV only: what the walks sample is discarded, and the pending
        token stays on the state."""
        fn, pool_keys, n_attn = self.fused_fn(state.steps,
                                              chain_signature(state.steps))
        pools = [kv.pools[k] for k in pool_keys]
        pk = tuple(p.k_pages for p in pools)
        pv = tuple(p.v_pages for p in pools)
        tables = self._tables([state], kv)
        tok = self._tensor(tokens)
        kv_len = self._tensor([state.kv_len])
        for j in range(len(tokens)):
            *_, kv_len = fn(tok[j:j + 1], pk, pv, tables, kv_len)
        self._c_attn_calls.inc(n_attn * len(tokens))
        self._c_lora_calls.inc(_lora_projections(state.steps) * len(tokens))
        state.kv_len += len(tokens)

    def prefill_batched(self, states: List, kv: KVManager) -> None:
        """Batched multi-request prefill: pad each request's prompt to a
        power-of-two bucket and run one chain call per (chain signature,
        bucket) instead of one per-block call per request.  KV slots must
        already be allocated (admission does that so the scheduler's
        ``fits`` sees true occupancy)."""
        groups: Dict[Tuple, List] = {}
        for s in states:
            key = (chain_signature(s.steps), _bucket(s.prompt_len))
            groups.setdefault(key, []).append(s)
        for (sig, bucket), members in groups.items():
            self._prefill_group(sig, bucket, members, kv)

    def _prefill_group(self, sig, bucket: int, states: List,
                       kv: KVManager) -> None:
        B = len(states)
        tok = np.zeros((B, bucket), np.int32)
        for i, s in enumerate(states):
            tok[i, :s.prompt_len] = s.prompt_tokens
        lens = [s.prompt_len for s in states]
        with self._prefill_span(states[0].app, [s.rid for s in states],
                                bucket, sum(lens)):
            with self._wait("stage"):
                tok_d, lens_d = self._tensor(tok), self._tensor(lens)
            self._count_prefill(states[0].steps)
            nxt, probs, kvs = chain_prefill_fused(
                states[0].steps, tok_d, lens_d,
                attn_impl=self.attn_impl, compute_dtype=self.compute_dtype)
            hop = 0
            for i, (block, _) in enumerate(states[0].steps):
                if not block.has_kv:
                    continue
                _, pool = kv.pool_for(block)
                k_r, v = kvs[hop]
                for bi, s in enumerate(states):
                    pool.write_prefill(s.rid, i,
                                       k_r[bi:bi + 1, :s.prompt_len],
                                       v[bi:bi + 1, :s.prompt_len])
                hop += 1
            with self._wait("prefill"):
                nxt_h, probs_h = nxt.cpu().numpy(), probs.cpu().numpy()
        self._c_host_syncs.inc()
        for i, s in enumerate(states):
            s.kv_len = s.prompt_len
            s.next_token = int(nxt_h[i])
            s.probs_last = probs_h[i]
            self._c_prefills.inc()

    # -- fused chain-step decode (device-resident megastep) ------------------

    @staticmethod
    def _pool_layout(steps) -> Tuple[List[Tuple], List[int]]:
        """KV-pool layout of a chain: the ordered list of distinct pool
        signatures it touches and, per attention hop, the index into it."""
        pool_keys: List[Tuple] = []
        pool_index: List[int] = []
        for block, _ in steps:
            if block.has_kv:
                if block.cfg.sliding_window:
                    raise NotImplementedError(
                        "paged decode does not support sliding-window blocks")
                key = block.kv_signature
                if key not in pool_keys:
                    pool_keys.append(key)
                pool_index.append(pool_keys.index(key))
        return pool_keys, pool_index

    def fused_fn(self, steps, sig):
        """One megastep callable per chain signature; returns
        (fn, pool_keys, n_attn_hops) where ``pool_keys`` orders the KV-pool
        signatures the chain needs."""
        cached = self._fused_fns.get(sig)
        if cached is not None:
            return cached
        impl, dtype = self.attn_impl, self.compute_dtype
        pool_keys, pool_index = self._pool_layout(steps)

        def fn(tok, pools_k, pools_v, tables, kv_len, lane_chain=None):
            # the slabs are written in place (the reference donates them)
            return chain_decode_fused(steps, pool_index, tok, pools_k,
                                      pools_v, tables, kv_len,
                                      attn_impl=impl, compute_dtype=dtype)

        out = (fn, tuple(pool_keys), len(pool_index))
        self._fused_fns[sig] = out
        return out

    def _layout(self, sig, steps) -> Optional[ChainLayout]:
        if sig not in self._layouts:
            self._layouts[sig] = chain_layout(steps)
        return self._layouts[sig]

    def merge_sets(self, chains) -> List[Tuple]:
        """The sets of chains that one merged megastep walks together.
        ``chains``: (signature, steps) of each chain whose plain fused
        groups run this step, in order.  Chains whose sublayer layouts align
        (``ChainLayout.shape``) and that share a weight, directly or through
        another chain of the set, form a set; a chain that shares nothing,
        or that the merged walk cannot run, keeps its own megastep.
        Returns the sets of two chains or more, each its signatures in
        ``chains``' order."""
        sigs = tuple(sig for sig, _ in chains)
        cached = self._merge_sets.get(sigs)
        if cached is not None:
            return cached
        lays = [self._layout(sig, steps) for sig, steps in chains]
        root = list(range(len(lays)))

        def find(i):
            while root[i] != i:
                i = root[i]
            return i

        for i, a in enumerate(lays):
            for j in range(i):
                b = lays[j]
                if a is not None and b is not None and a.shape == b.shape \
                        and a.weights & b.weights:
                    root[find(i)] = find(j)
        sets: Dict[int, List] = {}
        for i, sig in enumerate(sigs):
            sets.setdefault(find(i), []).append(sig)
        out = [tuple(m) for m in sets.values() if len(m) > 1]
        self._merge_sets[sigs] = out
        return out

    def merged_fn(self, key, chains):
        """One merged megastep callable per set of chains (``key``:
        ``("merged", sorted signatures)``; ``chains``: their steps, in that
        order); returns (fn, pool_keys, plan), ``plan`` the
        ``MergedChains`` walk, whose ``lane_chain`` indexes ``chains``."""
        cached = self._merged_fns.get(key)
        if cached is not None:
            return cached
        impl, dtype = self.attn_impl, self.compute_dtype
        plan = MergedChains([self._layout(sig, steps)
                             for sig, steps in zip(key[1], chains)])
        pool_keys, pool_index = self._pool_layout(chains[0])

        def fn(tok, pools_k, pools_v, tables, kv_len, lane_chain):
            # the slabs are written in place (the reference donates them)
            return chain_decode_fused(plan, pool_index, tok, pools_k,
                                      pools_v, tables, kv_len,
                                      attn_impl=impl, compute_dtype=dtype,
                                      lane_chain=lane_chain)

        out = (fn, tuple(pool_keys), plan)
        self._merged_fns[key] = out
        return out

    def _group_walk(self, states):
        """The megastep of a fused group: (key, (fn, pool_keys, paged calls,
        LoRA projections) a call, each lane's chain index in the key or
        None, each lane's attention-hop step indices).  A group of one
        chain: its signature and its chain's megastep; of several: the
        merged walk of ``("merged", sorted signatures)``."""
        sigs = [chain_signature(s.steps) for s in states]
        chains = dict(zip(sigs, (s.steps for s in states)))
        hops = {sig: [i for i, (b, _) in enumerate(steps) if b.has_kv]
                for sig, steps in chains.items()}
        lane_steps = [hops[sig] for sig in sigs]
        if len(chains) == 1:
            steps = states[0].steps
            fn, pool_keys, n_attn = self.fused_fn(steps, sigs[0])
            return (sigs[0], (fn, pool_keys, n_attn,
                              _lora_projections(steps)), None, lane_steps)
        order = tuple(sorted(chains))
        key = ("merged", order)
        fn, pool_keys, plan = self.merged_fn(key, [chains[s] for s in order])
        index = {sig: c for c, sig in enumerate(order)}
        return (key, (fn, pool_keys, plan.n_attn, plan.lora_projections),
                [index[sig] for sig in sigs], lane_steps)

    def spec_fn(self, steps, sur_steps, sig, lookahead: int):
        """Draft-verify megastep (paper §5.2) per (chain signature,
        surrogate signature, lookahead); returns (fn, pool_keys,
        n_attn_hops).  The surrogate chain must share the full chain's
        KV-pool layout (FFN-only surrogates guarantee this); verification
        reuses the plain fused step's calls, so committed tokens are
        bit-identical to the plain fused path."""
        key = (sig, chain_signature(sur_steps), lookahead)
        cached = self._spec_fns.get(key)
        if cached is not None:
            return cached
        impl, dtype = self.attn_impl, self.compute_dtype
        pool_keys, pool_index = self._pool_layout(steps)
        sur_keys, sur_index = self._pool_layout(sur_steps)
        if sur_keys != pool_keys or sur_index != pool_index:
            raise ValueError(
                "surrogate chain must share the full chain's KV-pool layout")

        def fn(tok, pools_k, pools_v, tables, kv_len, budget):
            # the slabs are written in place (the reference donates them)
            return chain_decode_spec_fused(
                steps, sur_steps, pool_index, tok, pools_k, pools_v, tables,
                kv_len, budget, lookahead=lookahead, attn_impl=impl,
                compute_dtype=dtype)

        out = (fn, tuple(pool_keys), len(pool_index))
        self._spec_fns[key] = out
        return out

    def buffered(self, rid: int) -> int:
        """Tokens a request has committed since its host state was last
        synced (0 when it is not device-resident)."""
        key = self._rid_group.get(rid)
        if key is None:
            return 0
        ds = self.decode_states[key]
        if not ds.buffered_counts:
            return 0
        return ds.buffered_counts[ds.rids.index(rid)]

    def retire_states(self, keep: frozenset = frozenset()) -> None:
        """Sync-and-drop every DecodeState whose rid tuple is not in
        ``keep`` — called when group membership changes (finish, preempt,
        admission) so host state is fresh before the engine touches it.
        A dropped state frees the megastep graph it was bound to."""
        for rids in [k for k in self.decode_states if k not in keep]:
            ds = self.decode_states.pop(rids)
            self._sync_state(ds)
            if ds.graph is not None:
                ds.graph.views = ()
                self._bound.discard(ds.sig)
            for r in rids:
                self._rid_group.pop(r, None)

    def sync_rid(self, rid: int) -> None:
        """Materialize the group containing ``rid`` (no-op when absent)."""
        key = self._rid_group.get(rid)
        if key is not None:
            self.retire_states(keep=frozenset(
                k for k in self.decode_states if k != key))

    def _sync_state(self, ds: DecodeState) -> None:
        if not ds.emitted:
            return  # never stepped: host state is still authoritative
        # one host sync: the backlog, pending tokens and probs come together
        with self._wait("retire"):
            backlog = torch.cat([t for t, _ in ds.emitted],
                                dim=1).cpu().numpy()
            nxt = ds.next_token.cpu().numpy()
            # a copy on the CPU too: a graph's step rewrites its buffer
            probs = ds.probs.to("cpu", copy=True).numpy()
        self._c_host_syncs.inc()
        for i, s in enumerate(ds.states):
            col = 0
            for t, cnt in ds.emitted:
                s.tokens.extend(int(tok) for tok in backlog[i, col:col + cnt[i]])
                col += t.shape[1]
            s.next_token = int(nxt[i])
            s.probs_last = probs[i]
            s.kv_len = ds.kv_len0[i] + ds.buffered_counts[i]

    @staticmethod
    def _host_tables(states: List, kv: KVManager,
                     lane_steps: Optional[List[List[int]]] = None
                     ) -> List[np.ndarray]:
        """One (B, n) page table per attention hop of the group's chain,
        on the host.  ``lane_steps[i]``: the step index of each attention
        hop in lane i's chain, where the lanes' chains differ: the i-th
        table then holds each lane's pages at its own chain's i-th hop."""
        hops = [i for i, (b, _) in enumerate(states[0].steps) if b.has_kv]
        if lane_steps is None:
            lane_steps = [hops] * len(states)
        return [kv.pool_for(states[0].steps[i][0])[1].block_table(
            [(s.rid, h[p]) for s, h in zip(states, lane_steps)])
            for p, i in enumerate(hops)]

    def _tables(self, states: List, kv: KVManager) -> Tuple[torch.Tensor, ...]:
        """One (B, n) page table per attention hop of the group's chain."""
        tables = self._host_tables(states, kv)
        with self._wait("stage"):
            return tuple(self._tensor(t) for t in tables)

    def _make_state(self, states: List, kv: KVManager,
                    bind: bool = False) -> DecodeState:
        """The group's DecodeState.  With ``bind`` (a plain fused step) it
        is bound to its megastep graph where its key is free, and staged
        into that graph's buffers."""
        sig, walk, chain, lane_steps = self._group_walk(states)
        rids = tuple(s.rid for s in states)
        B = len(states)
        host = self._host_tables(states, kv, lane_steps)
        g = (self._free_graph(sig, states[0].steps, B, host,
                              chain is not None) if bind else None)
        lane_chain = None
        if g is not None:
            with self._wait("stage"):
                self._stage(g, states, host, chain)
            self._bound.add(sig)
            g.views = (g.tokens[:B], g.kv_len[:B], g.probs[:B])
            next_token, kv_len = g.views[:2]
            tables = tuple(t[:B] for t in g.tables)
            if chain is not None:
                lane_chain = g.lane_chain[:B]
        else:
            with self._wait("stage"):
                tables = tuple(self._tensor(t) for t in host)
                next_token = self._tensor([s.next_token for s in states])
                kv_len = self._tensor([s.kv_len for s in states])
                if chain is not None:
                    lane_chain = self._tensor(chain)
        ds = DecodeState(
            rids=rids, sig=sig, states=list(states),
            next_token=next_token, kv_len=kv_len, tables=tables,
            kv_len0=[s.kv_len for s in states],
            buffered_counts=[0] * B, graph=g, walk=walk,
            lane_chain=lane_chain)
        self.decode_states[rids] = ds
        for r in rids:
            self._rid_group[r] = rids
        return ds

    # -- megastep graphs ---------------------------------------------------

    def _free_graph(self, sig, steps, B: int, host: List[np.ndarray],
                    merged: bool = False) -> Optional[MegastepGraph]:
        """The megastep graph of (``sig``, the bucket of ``B``), made on
        first use; None where the group runs eagerly: another live group
        of the key is bound, or a row is wider than the tables.  A
        ``merged`` group's graph also holds its lanes' chains."""
        if sig in self._bound \
                or any(t.shape[1] > self.table_width for t in host):
            return None
        key = (sig, min(_bucket(B), self.max_lanes))
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._new_graph(
                sig, key[1], len(host),
                steps[-1][0].params["lm_head"].shape[-1], merged)
        return g

    def _new_graph(self, sig, lanes: int, hops: int, vocab: int,
                   merged: bool = False) -> MegastepGraph:
        W = self.table_width
        rows = 4 if merged else 3
        ints = torch.zeros(hops * lanes * W + rows * lanes,
                           dtype=torch.int32, device=self.device)
        tabs = ints[:hops * lanes * W].view(hops, lanes, W)
        rest = ints[hops * lanes * W:].view(rows, lanes)
        probs = self._graph_probs.get(sig)
        if probs is None:
            probs = self._graph_probs[sig] = torch.zeros(
                (self.max_lanes, vocab), dtype=torch.float32,
                device=self.device)
        return MegastepGraph(
            lanes=lanes, ints=ints, tables=tuple(tabs.unbind(0)),
            tokens=rest[0], kv_len=rest[1], live=rest[2],
            probs=probs[:lanes], lane_chain=rest[3] if merged else None)

    def _stage(self, g: MegastepGraph, states: List,
               host: List[np.ndarray],
               chain: Optional[List[int]] = None) -> None:
        """Copy a forming group into rows [:B] of the graph's buffers and
        reset the pad lanes (token 0, kv_len 0, tables of the trash page,
        not live, chain 0), in one copy: from pinned memory on a card, so
        the host does not wait for the stream.  ``chain``: a merged
        group's lanes' chains."""
        B, lanes, W = len(states), g.lanes, self.table_width
        buf = np.zeros(g.ints.numel(), np.int32)
        tabs = buf[:len(host) * lanes * W].reshape(len(host), lanes, W)
        tabs[:] = TRASH_PAGE
        for hop, t in enumerate(host):
            tabs[hop, :B, :t.shape[1]] = t
        rest = buf[len(host) * lanes * W:].reshape(-1, lanes)
        rest[0, :B] = [s.next_token for s in states]
        rest[1, :B] = [s.kv_len for s in states]
        rest[2, :B] = 1
        if chain is not None:
            rest[3, :B] = chain
        src = torch.from_numpy(buf)
        if g.ints.is_cuda:
            # the pinned block is not reused before the copy has run
            g.ints.copy_(src.pin_memory(), non_blocking=True)
        else:
            g.ints.copy_(src)

    @staticmethod
    def _run_static(g: MegastepGraph, fn, pk, pv) -> None:
        """The megastep over the graph's buffers: the eager megastep, then
        its outputs written back, so a stable group's next step finds its
        state in place; pad lanes' kv_len stays 0."""
        nxt, probs, _, _, kv_len = fn(g.tokens, pk, pv, g.tables, g.kv_len,
                                      g.lane_chain)
        g.probs.copy_(probs)
        g.tokens.copy_(nxt)
        torch.mul(kv_len, g.live, out=g.kv_len)

    def _capture(self, g: MegastepGraph, fn, pk, pv) -> None:
        """A bucket's first call: the megastep over its buffers, eagerly;
        on a card on the capture stream, where it also fills every
        host-side cache (weight casts, tile ids, the LoRA scaling, the
        kernels' counters and libraries) and cuBLAS's workspace for that
        stream, and then captured as a CUDA graph in the executor's pool.
        The graph keeps the paged kernel's counter buffer, which the
        kernel module replaces when a larger call needs more, and the
        launches the capture recorded, which ran nothing."""
        if not g.ints.is_cuda:
            self._run_static(g, fn, pk, pv)
            g.ready = True
            return
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(self.device)
        cur = torch.cuda.current_stream(self.device)
        side = self._capture_stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._run_static(g, fn, pk, pv)
            graph = torch.cuda.CUDAGraph()
            before = [m.launches for m in _GRAPH_KERNELS]
            graph.capture_begin(pool=self._graph_pool)
            try:
                self._run_static(g, fn, pk, pv)
            finally:
                graph.capture_end()
        cur.wait_stream(side)
        g.launches = tuple(m.launches - n
                           for m, n in zip(_GRAPH_KERNELS, before))
        for m, n in zip(_GRAPH_KERNELS, g.launches):
            m.launches -= n
        g.graph = graph
        g.keep = (pa_kernel._counters.get(g.ints.device),)
        g.ready = True

    def _graph_step(self, ds: DecodeState, fn, pk, pv) -> torch.Tensor:
        """One megastep of a group bound to a graph: its bucket's first
        call, or a replay.  Returns the tokens it emits, (B, 1), copied
        out of the buffer the step overwrites."""
        g = ds.graph
        tok, kv_len, probs = g.views
        if ds.next_token is not tok:  # a speculative step moved the state
            tok.copy_(ds.next_token)
            kv_len.copy_(ds.kv_len)
        emitted = tok[:, None].clone()
        if not g.ready:
            self._capture(g, fn, pk, pv)
            self._c_graph_captures.inc()
        else:
            if g.graph is not None:
                g.graph.replay()
                for m, n in zip(_GRAPH_KERNELS, g.launches):
                    m.launches += n
            else:
                self._run_static(g, fn, pk, pv)
            self._c_graph_replays.inc()
            self._c_graph_lanes.inc(g.lanes)
            self._c_graph_real.inc(tok.shape[0])
        ds.next_token, ds.kv_len, ds.probs = tok, kv_len, probs
        return emitted

    def fused_step(self, states: List, kv: KVManager) -> None:
        """One token for one fused group: a single chain call with sampling
        on the device, replayed from its megastep graph where the group is
        bound to one.  A group over the lanes of several chains (the
        engine forms it from ``merge_sets``) runs their merged walk.  The
        pending token and kv lengths stay device-resident between calls."""
        rids = tuple(s.rid for s in states)
        ds = self.decode_states.get(rids)
        if ds is None:
            ds = self._make_state(states, kv, bind=True)
        fn, pool_keys, n_attn, n_lora = ds.walk
        pools = [kv.pools[k] for k in pool_keys]
        pk = tuple(p.k_pages for p in pools)
        pv = tuple(p.v_pages for p in pools)
        B = len(states)
        self._c_group_calls.inc()
        self._c_attn_calls.inc(n_attn)
        self._c_lora_calls.inc(n_lora)
        self._h_group_batch.observe(B)
        self._c_fused_lanes.inc(B)
        if ds.lane_chain is not None:
            self._c_merged_lanes.inc(B)
        if ds.graph is not None:
            emitted = self._graph_step(ds, fn, pk, pv)
        else:
            nxt, probs, _, _, kv_len = fn(ds.next_token, pk, pv, ds.tables,
                                          ds.kv_len, ds.lane_chain)
            emitted = ds.next_token[:, None]
            ds.next_token, ds.probs, ds.kv_len = nxt, probs, kv_len
        ds.emitted.append((emitted, np.ones(B, np.int64)))
        for i in range(B):
            ds.buffered_counts[i] += 1
        self._c_decode_tokens.inc(B)

    def spec_step(self, states: List, kv: KVManager, sur_steps,
                  lookahead: int, budgets: List[int]
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One draft-verify megastep for one fused group (paper §5.2): the
        surrogate chain drafts ``lookahead - 1`` tokens, the full chain
        verifies all positions in the same call, and per-lane
        accept/rollback happens on the device.  Commits 1..lookahead tokens
        per lane; returns host ``(attempts, hits, committed)`` arrays (one
        small count sync per call — the engine needs exact per-lane
        progress for finish decisions).  ``budgets[i]`` is how many tokens
        lane i may still commit; the device clamps drafts so the
        pending-token protocol never overshoots it.

        Each call walks the chain 2k - 1 times (k - 1 drafts, k verifies),
        so it issues n_attn * (2k - 1) paged-attention calls and, the
        surrogate chain keeping each hop's adapters, the LoRA projections
        of 2k - 1 walks."""
        rids = tuple(s.rid for s in states)
        ds = self.decode_states.get(rids)
        if ds is None:
            ds = self._make_state(states, kv)
        steps = states[0].steps
        fn, pool_keys, n_attn = self.spec_fn(steps, sur_steps, ds.sig,
                                             lookahead)
        pools = [kv.pools[k] for k in pool_keys]
        pk = tuple(p.k_pages for p in pools)
        pv = tuple(p.v_pages for p in pools)
        walks = 2 * lookahead - 1
        self._c_group_calls.inc()
        self._c_attn_calls.inc(n_attn * walks)
        self._c_lora_calls.inc(_lora_projections(steps) * lookahead
                               + _lora_projections(sur_steps)
                               * (lookahead - 1))
        self._h_group_batch.observe(len(states))
        with self._wait("stage"):
            budget = self._tensor(budgets)
        (commit_tok, commit_cnt, accepted, attempts, nxt, probs,
         _, _, kv_len) = fn(ds.next_token, pk, pv, ds.tables, ds.kv_len,
                            budget)
        # one host sync: the three count vectors come together
        with self._wait("spec"):
            cnt_h, acc_h, att_h = torch.stack(
                [commit_cnt, accepted, attempts]).cpu().numpy().astype(
                    np.int64)
        self._c_host_syncs.inc()
        ds.emitted.append((commit_tok, cnt_h))
        for i in range(len(states)):
            ds.buffered_counts[i] += int(cnt_h[i])
        ds.next_token = nxt
        ds.probs = probs
        ds.kv_len = kv_len
        self._c_decode_tokens.inc(int(cnt_h.sum()))
        self._c_spec_attempts.inc(int(att_h.sum()))
        self._c_spec_hits.inc(int(acc_h.sum()))
        return att_h, acc_h, cnt_h

    # -- decode: per-hop batched group execution (fallback path) -------------

    def seed_tokens(self, states) -> Dict[int, torch.Tensor]:
        """Per-request (1, 1) input carrying the pending sampled token."""
        return {s.rid: self._tensor([[s.next_token]]) for s in states}

    def _tables_for(self, rids: List[int], cursor: int, pool,
                    cursors) -> torch.Tensor:
        key = (tuple(rids), cursor)
        tables = self._table_cache.get(key)
        if tables is not None:
            self._table_cache.move_to_end(key)
            return tables
        tables = self._tensor(pool.block_table(
            [(r, cursors[r]) for r in rids]))
        self._table_cache[key] = tables
        while len(self._table_cache) > self.table_cache_max:
            self._table_cache.popitem(last=False)
        return tables

    def run_group(self, rids: List[int], by_rid, cursors, xs,
                  kv: KVManager) -> None:
        """Batched execution of one (block, adapters) group at one hop."""
        s0 = by_rid[rids[0]]
        cursor = cursors[s0.rid]
        block, adapters = s0.steps[cursor]
        fn = self.block_fn(block, adapters)
        x = torch.cat([xs[r] for r in rids], dim=0)
        self._c_group_calls.inc()
        self._c_lora_calls.inc(_lora_projections([(block, adapters)]))
        self._h_group_batch.observe(len(rids))
        if block.has_kv:
            _, pool = kv.pool_for(block)
            tables = self._tables_for(rids, cursor, pool, cursors)
            kv_len = self._tensor([by_rid[r].kv_len for r in rids])
            self._c_attn_calls.inc()
            out, _, _ = fn(x, pool.k_pages, pool.v_pages, tables, kv_len)
        else:
            out = fn(x)
        for i, r in enumerate(rids):
            xs[r] = out[i:i + 1]

    # -- sampling (fallback path; the fused megastep samples on device) ------

    def sample_step(self, states, xs) -> None:
        """Greedy next-token selection over the lm_head outputs — one
        batched argmax/softmax per step.  Final-step probabilities are kept
        for requests emitting their last token next step (adaptive-serving
        quality, Fig. 20)."""
        by_vocab: Dict[int, list] = {}
        for s in states:
            by_vocab.setdefault(xs[s.rid].shape[-1], []).append(s)
        for group in by_vocab.values():
            logits = torch.cat([xs[s.rid] for s in group], dim=0)[:, 0]
            with self._wait("sample"):
                nxt = torch.argmax(logits, dim=-1).cpu().numpy()
            self._c_host_syncs.inc()
            last = [i for i, s in enumerate(group)
                    if len(s.tokens) + 1 >= s.gen_len]
            if last:
                rows = torch.as_tensor(last, device=logits.device)
                probs = torch.softmax(logits[rows].float(), dim=-1)
                with self._wait("sample"):
                    probs = probs.cpu().numpy()
                self._c_host_syncs.inc()
                for j, i in enumerate(last):
                    group[i].probs_last = probs[j]
            for i, s in enumerate(group):
                s.next_token = int(nxt[i])
                s.kv_len += 1
                self._c_decode_tokens.inc()
