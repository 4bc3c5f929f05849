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
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.blocks import (
    Block,
    apply_block,
    block_decode_paged,
    block_prefill_raw,
    chain_decode_fused,
    chain_prefill_fused,
    chain_signature,
)
from repro_torch.models import layers as L
from repro_torch.observability.metrics import MetricsRegistry
from repro_torch.serving.kv_pool import KVManager


def _bucket(n: int, lo: int = 8) -> int:
    """Pad-to-bucket prompt length: next power of two, floor ``lo`` — bounds
    the number of distinct prefill shapes per chain."""
    b = lo
    while b < n:
        b *= 2
    return b


@dataclass
class DecodeState:
    """Device-resident decode state for one fused group (DESIGN.md §2).

    While a group's membership is stable, its pending next-token ids, kv
    lengths and emitted-token backlog live on the device; nothing syncs to
    the host until a member finishes, is preempted, or the group re-forms.
    ``states`` are the engine's per-request records (duck-typed: ``rid``,
    ``tokens``, ``next_token``, ``probs_last``, ``kv_len``).

    ``emitted`` holds one device ``(B,)`` token vector per fused step (the
    reference's ``(tokens, counts)`` commit buffers carry speculative
    multi-token commits, which wait for the speculation slice);
    ``buffered_counts`` mirrors the per-lane totals on the host so the
    engine's finish logic sees exact progress without a sync.
    """
    rids: Tuple[int, ...]
    sig: Tuple
    states: List              # engine request states, group order
    next_token: torch.Tensor  # (B,) pending sampled token, not yet emitted
    kv_len: torch.Tensor      # (B,) tokens cached, tracked on the device
    tables: Tuple[torch.Tensor, ...]  # staged (B, n) page table per attn hop
    kv_len0: List[int]        # host kv_len at creation (host mirror base)
    emitted: List[torch.Tensor] = field(default_factory=list)
    buffered_counts: List[int] = field(default_factory=list)  # per lane
    probs: Optional[torch.Tensor] = None  # (B, V) probs of latest next_token


class BlockExecutor:
    """Fused chain execution, per-hop fallback, batching and sampling."""

    def __init__(self, attn_impl: str = "auto",
                 metrics: Optional[MetricsRegistry] = None,
                 compute_dtype: torch.dtype = L.COMPUTE_DTYPE,
                 device="cuda"):
        self.attn_impl = attn_impl
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        # typed handles held once — the decode hot loop pays one attribute
        # add per event, not a registry lookup (DESIGN.md §8)
        self._c_prefills = self.metrics.counter("prefills")
        self._c_decode_tokens = self.metrics.counter("decode_tokens")
        self._c_group_calls = self.metrics.counter("group_calls")
        self._c_host_syncs = self.metrics.counter("host_syncs")
        # paged-attention calls issued (one per attention hop per call): the
        # number of kernel launches the decode path should account for
        self._c_attn_calls = self.metrics.counter("attn_calls")
        # per-block batch occupancy: every batched device call observes its
        # batch width (compare p50/mean against EngineConfig.max_block_batch)
        self._h_group_batch = self.metrics.histogram("group_batch")
        self._block_fns: Dict[Tuple, object] = {}
        # fused megastep per chain signature: (fn, pool_keys, n_attn_hops)
        self._fused_fns: Dict[Tuple, Tuple[object, Tuple, int]] = {}
        # device-resident decode state per fused group, keyed by rid tuple
        self.decode_states: Dict[Tuple[int, ...], DecodeState] = {}
        self._rid_group: Dict[int, Tuple[int, ...]] = {}
        # per-hop path: a group's block table is constant between membership
        # changes: LRU cache per (rids, hop); the engine invalidates on
        # finish/preempt/restore and the cap bounds membership churn
        self.table_cache_max = 128
        self._table_cache: OrderedDict[Tuple, torch.Tensor] = OrderedDict()

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
        x = self._tensor(tokens)[None]  # (1, S)
        for i, (block, adapters) in enumerate(state.steps):
            x, k_r, v = block_prefill_raw(block, x, adapters=adapters,
                                          compute_dtype=self.compute_dtype)
            if k_r is not None:
                _, pool = kv.pool_for(block)
                if (state.rid, i) not in pool.slots:
                    pool.alloc(state.rid, i, state.slot_tokens)
                pool.write_prefill(state.rid, i, k_r, v)
        state.kv_len = len(tokens)
        if sample:
            logits = x[0, -1]
            state.next_token = int(torch.argmax(logits))
            state.probs_last = torch.softmax(logits.float(), -1).cpu().numpy()
            self._c_host_syncs.inc()
        self._c_prefills.inc()

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
        lens = self._tensor([s.prompt_len for s in states])
        nxt, probs, kvs = chain_prefill_fused(
            states[0].steps, self._tensor(tok), lens,
            compute_dtype=self.compute_dtype)
        hop = 0
        for i, (block, _) in enumerate(states[0].steps):
            if not block.has_kv:
                continue
            _, pool = kv.pool_for(block)
            k_r, v = kvs[hop]
            for bi, s in enumerate(states):
                pool.write_prefill(s.rid, i, k_r[bi:bi + 1, :s.prompt_len],
                                   v[bi:bi + 1, :s.prompt_len])
            hop += 1
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

        def fn(tok, pools_k, pools_v, tables, kv_len):
            # the slabs are written in place (the reference donates them)
            return chain_decode_fused(steps, pool_index, tok, pools_k,
                                      pools_v, tables, kv_len,
                                      attn_impl=impl, compute_dtype=dtype)

        out = (fn, tuple(pool_keys), len(pool_index))
        self._fused_fns[sig] = out
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
        admission) so host state is fresh before the engine touches it."""
        for rids in [k for k in self.decode_states if k not in keep]:
            self._sync_state(self.decode_states.pop(rids))
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
        backlog = torch.stack(ds.emitted, dim=1).cpu().numpy()  # (B, steps)
        nxt = ds.next_token.cpu().numpy()
        probs = ds.probs.cpu().numpy()
        self._c_host_syncs.inc()
        for i, s in enumerate(ds.states):
            s.tokens.extend(int(tok) for tok in backlog[i])
            s.next_token = int(nxt[i])
            s.probs_last = probs[i]
            s.kv_len = ds.kv_len0[i] + ds.buffered_counts[i]

    def _make_state(self, states: List, kv: KVManager) -> DecodeState:
        steps = states[0].steps
        sig = chain_signature(steps)
        rids = tuple(s.rid for s in states)
        tables = []
        for i, (block, _) in enumerate(steps):
            if block.has_kv:
                _, pool = kv.pool_for(block)
                tables.append(self._tensor(
                    pool.block_table([(s.rid, i) for s in states])))
        ds = DecodeState(
            rids=rids, sig=sig, states=list(states),
            next_token=self._tensor([s.next_token for s in states]),
            kv_len=self._tensor([s.kv_len for s in states]),
            tables=tuple(tables),
            kv_len0=[s.kv_len for s in states],
            buffered_counts=[0] * len(states))
        self.decode_states[rids] = ds
        for r in rids:
            self._rid_group[r] = rids
        return ds

    def fused_step(self, states: List, kv: KVManager) -> None:
        """One token for one fused group: a single chain call with sampling
        on the device.  The pending token and kv lengths stay
        device-resident between calls."""
        rids = tuple(s.rid for s in states)
        ds = self.decode_states.get(rids)
        if ds is None:
            ds = self._make_state(states, kv)
        fn, pool_keys, n_attn = self.fused_fn(states[0].steps, ds.sig)
        pools = [kv.pools[k] for k in pool_keys]
        pk = tuple(p.k_pages for p in pools)
        pv = tuple(p.v_pages for p in pools)
        self._c_group_calls.inc()
        self._c_attn_calls.inc(n_attn)
        self._h_group_batch.observe(len(states))
        nxt, probs, _, _, kv_len = fn(ds.next_token, pk, pv, ds.tables,
                                      ds.kv_len)
        ds.emitted.append(ds.next_token)
        for i in range(len(states)):
            ds.buffered_counts[i] += 1
        ds.next_token = nxt
        ds.probs = probs
        ds.kv_len = kv_len
        self._c_decode_tokens.inc(len(states))

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
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
            self._c_host_syncs.inc()
            last = [i for i, s in enumerate(group)
                    if len(s.tokens) + 1 >= s.gen_len]
            if last:
                rows = torch.as_tensor(last, device=logits.device)
                probs = torch.softmax(logits[rows].float(), dim=-1)
                probs = probs.cpu().numpy()
                self._c_host_syncs.inc()
                for j, i in enumerate(last):
                    group[i].probs_last = probs[j]
            for i, s in enumerate(group):
                s.next_token = int(nxt[i])
                s.kv_len += 1
                self._c_decode_tokens.inc()
