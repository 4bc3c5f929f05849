"""Block zoo (paper §4) in PyTorch — the port of ``repro.core.zoo``:
repository of blocks with dedup, equivalence edges, lazy partitioning and
storage accounting.

Lazy partitioning (Fig. 11):
- foundation model -> [embed, layer_0..L-1, lm_head] blocks (layer
  granularity: avoid over-partitioning).
- FPFT model -> per-layer parametric equivalence vs the foundation;
  >= dedup threshold -> the chain references the foundation block (shared);
  otherwise its own block is stored and, if >= equivalence threshold, an
  adaptive-serving edge is recorded.
- PEFT model -> foundation blocks shared + tiny adapter blocks; if an
  adapter touches only the attention sublayer, affected layer blocks are
  split into attention+ffn so the FFN remains shared (Fig. 11 step 3).
- Surrogates for speculative serving (paper §5.2): FFN-pruned copies of
  blocks, built on first use and kept in a bounded LRU cache.
- Stitching blocks between models of different widths (paper §4.3), and a
  per-block profiler feeding the cost model (paper §6).
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.blocks import (
    Block,
    BlockChain,
    ChainStep,
    apply_block,
    tree_bytes,
    tree_hash,
    tree_leaves,
)
from repro_torch.core.equivalence import param_equivalence
from repro_torch.core.surrogates import build_surrogate

DEDUP_THRESHOLD = 0.995   # parametric: treat as the same block
EQUIV_THRESHOLD = 0.98    # paper §7.1: adaptive-serving equivalence


def _layer_params(stacked: dict, i: int) -> dict:
    return {k: v[i] for k, v in stacked.items()}


@dataclass
class ProfileRecord:
    """Paper §6: per-block profiling for the online cost model."""
    compute_time_per_token: Dict[int, float] = field(default_factory=dict)  # batch -> s
    load_time_s: float = 0.0
    bytes: int = 0


class BlockZoo:
    def __init__(self):
        self.blocks: Dict[str, Block] = {}
        self.chains: Dict[str, BlockChain] = {}
        self.equivalences: Dict[Tuple[str, str], float] = {}
        self.stitches: Dict[Tuple[int, int], str] = {}  # (d_in,d_out) -> block id
        self.profiles: Dict[str, ProfileRecord] = {}
        self.surrogates: Dict[str, str] = {}  # block id -> surrogate block id
        # bounded surrogate cache for speculative serving (paper §5.2):
        # keyed by (parent block id — which embeds the parent params'
        # tree_hash — prune ratio, prune_kv); LRU-evicted so a long-lived
        # engine serving many chains cannot grow the zoo without bound
        self.surrogate_cache_max = 32
        self._surrogate_cache: "OrderedDict[Tuple, str]" = OrderedDict()
        # bookkeeping for Fig. 5 (redundancy of per-model provisioning)
        self.registered_model_bytes: Dict[str, int] = {}

    # ------------------------------------------------------------------
    def _add_block(self, block: Block) -> str:
        """Dedup by content hash."""
        if block.id in self.blocks:
            return block.id
        self.blocks[block.id] = block
        return block.id

    def _make_block(self, kind, model, layer_idx, d_in, d_out, params, cfg,
                    **meta) -> Block:
        return Block(id=f"{kind[:2]}-{tree_hash(params)}", kind=kind,
                     model=model, layer_idx=layer_idx, d_in=d_in, d_out=d_out,
                     params=params, cfg=cfg, meta=meta)

    # ------------------------------------------------------------------
    def register_foundation(self, name: str, cfg: ModelConfig, params: dict
                            ) -> BlockChain:
        D = cfg.d_model
        steps: List[ChainStep] = []
        embed = self._make_block("embed", name, None, 1, D,
                                 {"embed": params["embed"]}, cfg)
        steps.append(ChainStep(self._add_block(embed)))
        for i in range(cfg.num_layers):
            lp = _layer_params(params["layers"], i)
            blk = self._make_block("layer", name, i, D, D, lp, cfg)
            steps.append(ChainStep(self._add_block(blk)))
        head = self._make_block(
            "lm_head", name, None, D, cfg.vocab_size,
            {"final_ln": params["final_ln"], "lm_head": params["lm_head"]}, cfg)
        steps.append(ChainStep(self._add_block(head)))
        chain = BlockChain(name, steps)
        self.chains[name] = chain
        self.registered_model_bytes[name] = tree_bytes(params)
        return chain

    # ------------------------------------------------------------------
    def register_fpft(self, name: str, cfg: ModelConfig, params: dict,
                      foundation: str) -> BlockChain:
        """Full-parameter fine-tune: per-layer equivalence-driven sharing."""
        base_chain = self.chains[foundation]
        D = cfg.d_model
        steps: List[ChainStep] = []
        embed = self._make_block("embed", name, None, 1, D,
                                 {"embed": params["embed"]}, cfg)
        steps.append(ChainStep(self._add_block(embed)))
        for i in range(cfg.num_layers):
            lp = _layer_params(params["layers"], i)
            base_id = base_chain.steps[1 + i].block_id
            base_blk = self.blocks[base_id]
            eq = param_equivalence(lp, base_blk.params)
            if eq >= DEDUP_THRESHOLD:
                steps.append(ChainStep(base_id))  # share the foundation block
            else:
                # own copy: a view would keep the whole stacked tensor alive
                lp = {k: v.clone() for k, v in lp.items()}
                blk = self._make_block("layer", name, i, D, D, lp, cfg)
                bid = self._add_block(blk)
                steps.append(ChainStep(bid))
                if eq >= EQUIV_THRESHOLD:
                    self.add_equivalence(bid, base_id, eq)
        head = self._make_block(
            "lm_head", name, None, D, cfg.vocab_size,
            {"final_ln": params["final_ln"], "lm_head": params["lm_head"]}, cfg)
        steps.append(ChainStep(self._add_block(head)))
        chain = BlockChain(name, steps)
        self.chains[name] = chain
        self.registered_model_bytes[name] = tree_bytes(params)
        return chain

    # ------------------------------------------------------------------
    def register_peft(self, name: str, cfg: ModelConfig, foundation: str,
                      adapter_kind: str, adapter_trees: List[dict]
                      ) -> BlockChain:
        """PEFT: share foundation blocks, add tiny adapter blocks; split the
        layer block when the adapter only touches one sublayer (Fig. 11)."""
        base_chain = self.chains[foundation]
        steps: List[ChainStep] = [base_chain.steps[0]]
        attention_only = adapter_kind in ("lora", "bitfit")
        for i, atree in enumerate(adapter_trees):
            base_id = base_chain.steps[1 + i].block_id
            ablk = self._make_block(adapter_kind, name, i, cfg.d_model,
                                    cfg.d_model, atree, cfg)
            aid = self._add_block(ablk)
            if attention_only:
                att_id, ffn_id = self.split_layer_block(base_id)
                steps.append(ChainStep(att_id, (aid,)))
                steps.append(ChainStep(ffn_id))
            else:
                steps.append(ChainStep(base_id, (aid,)))
        steps.append(base_chain.steps[-1])
        chain = BlockChain(name, steps)
        self.chains[name] = chain
        base_bytes = self.registered_model_bytes[foundation]
        self.registered_model_bytes[name] = base_bytes + tree_bytes(adapter_trees)
        return chain

    # ------------------------------------------------------------------
    def split_layer_block(self, layer_id: str) -> Tuple[str, str]:
        """Split a layer block into attention + ffn blocks (idempotent);
        existing chains referencing the whole layer keep working.  The
        halves alias the layer block's tensors."""
        blk = self.blocks[layer_id]
        if "split" in blk.meta:
            return blk.meta["split"]
        p = blk.params
        att_p = {k: p[k] for k in ("ln1", "wq", "wk", "wv", "wo") if k in p}
        ffn_p = {k: p[k] for k in ("ln2", "w_gate", "w_up", "w_down") if k in p}
        att = self._make_block("attention", blk.model, blk.layer_idx,
                               blk.d_in, blk.d_out, att_p, blk.cfg)
        ffn = self._make_block("ffn", blk.model, blk.layer_idx,
                               blk.d_in, blk.d_out, ffn_p, blk.cfg)
        att_id, ffn_id = self._add_block(att), self._add_block(ffn)
        blk.meta["split"] = (att_id, ffn_id)
        return att_id, ffn_id

    # ------------------------------------------------------------------
    def surrogate_for(self, block_id: str, prune_ratio: float, *,
                      prune_kv: bool = False) -> str:
        """Return (building and registering on first use) the surrogate of
        ``block_id`` at ``prune_ratio`` for speculative serving (§5.2).

        The cache key is (parent block id, ratio, prune_kv) — the parent id
        embeds the parent params' ``tree_hash``, so a re-registered block
        with different weights gets a fresh surrogate.  Eviction removes
        the surrogate block from the zoo as well (the engine rebuilds it on
        next use), keeping surrogate storage bounded."""
        key = (block_id, round(float(prune_ratio), 6), bool(prune_kv))
        sid = self._surrogate_cache.get(key)
        if sid is not None:
            self._surrogate_cache.move_to_end(key)
            return sid
        sur = build_surrogate(self.blocks[block_id], prune_ratio,
                              prune_kv=prune_kv)
        self.blocks[sur.id] = sur
        self.surrogates[block_id] = sur.id
        self._surrogate_cache[key] = sur.id
        while len(self._surrogate_cache) > self.surrogate_cache_max:
            old_key, old_sid = self._surrogate_cache.popitem(last=False)
            self.blocks.pop(old_sid, None)
            if self.surrogates.get(old_key[0]) == old_sid:
                del self.surrogates[old_key[0]]
        return sur.id

    # ------------------------------------------------------------------
    def add_equivalence(self, a: str, b: str, score: float):
        self.equivalences[(a, b)] = score
        self.equivalences[(b, a)] = score

    def equivalent_blocks(self, block_id: str) -> List[Tuple[str, float]]:
        """(block id, score) of every block with an adaptive-serving
        equivalence edge to ``block_id``."""
        return [(b, s) for (a, b), s in self.equivalences.items()
                if a == block_id]

    def add_stitch(self, block: Block):
        self.blocks[block.id] = block
        self.stitches[(block.d_in, block.d_out)] = block.id

    # ------------------------------------------------------------------
    # storage accounting (paper Fig. 5)
    # ------------------------------------------------------------------
    def zoo_bytes(self) -> int:
        """Physical storage: split attention/ffn blocks alias the layer
        block's tensors, so count unique leaf tensors only."""
        seen = set()
        total = 0
        for b in self.blocks.values():
            for leaf in tree_leaves(b.params):
                if id(leaf) not in seen:
                    seen.add(id(leaf))
                    total += leaf.numel() * leaf.element_size()
        return total

    def per_model_bytes(self) -> int:
        """What per-model provisioning would store."""
        return sum(self.registered_model_bytes.values())

    def redundancy_fraction(self) -> float:
        pm = self.per_model_bytes()
        return 1.0 - self.zoo_bytes() / pm if pm else 0.0

    # ------------------------------------------------------------------
    def profile_block(self, block_id: str, batch_sizes=(1, 8, 32),
                      seq_len: int = 64) -> ProfileRecord:
        """Paper §6: measure per-batch compute time of a block where its
        parameters live, on bf16 zeros (token ids for an embed block),
        after one warm-up call.  On a CUDA device: CUDA events around one
        call, read after synchronizing; on the CPU: the host clock, as the
        reference times it."""
        block = self.blocks[block_id]
        rec = ProfileRecord(bytes=block.bytes)
        dev = tree_leaves(block.params)[0].device
        for bs in batch_sizes:
            if block.kind == "embed":
                x = torch.zeros((bs, seq_len), dtype=torch.int32, device=dev)
            else:
                x = torch.zeros((bs, seq_len, block.d_in),
                                dtype=torch.bfloat16, device=dev)
            with torch.no_grad():
                apply_block(block, x)  # warm-up: casts, kernel loads
                if dev.type == "cuda":
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    torch.cuda.synchronize(dev)
                    start.record()
                    apply_block(block, x)
                    end.record()
                    end.synchronize()
                    dt = start.elapsed_time(end) / 1e3
                else:
                    t0 = time.perf_counter()
                    apply_block(block, x)
                    dt = time.perf_counter() - t0
            rec.compute_time_per_token[bs] = dt / (bs * seq_len)
        self.profiles[block_id] = rec
        return rec
