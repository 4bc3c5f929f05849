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

Surrogates for speculation and the block profiler wait for a later slice.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.blocks import (
    Block,
    BlockChain,
    ChainStep,
    tree_bytes,
    tree_hash,
    tree_leaves,
)
from repro_torch.core.equivalence import param_equivalence

DEDUP_THRESHOLD = 0.995   # parametric: treat as the same block
EQUIV_THRESHOLD = 0.98    # paper §7.1: adaptive-serving equivalence


def _layer_params(stacked: dict, i: int) -> dict:
    return {k: v[i] for k, v in stacked.items()}


class BlockZoo:
    def __init__(self):
        self.blocks: Dict[str, Block] = {}
        self.chains: Dict[str, BlockChain] = {}
        self.equivalences: Dict[Tuple[str, str], float] = {}
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
    def add_equivalence(self, a: str, b: str, score: float):
        self.equivalences[(a, b)] = score
        self.equivalences[(b, a)] = score

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
