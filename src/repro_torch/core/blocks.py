"""Block abstraction (paper §4.2) in PyTorch — the port of
``repro.core.blocks``.

A Block is the unit of provisioning: a named dict of fp32 parameter tensors
plus an apply function determined by ``kind``.  Block ids are content
hashes computed exactly as the reference computes them, so identical
parameters get identical ids in both packages.

Numerics follow the reference: fp32 weights, activations in the compute
dtype, weights cast to the activation dtype at use.  ``Block.compute_params``
keeps one cached copy of each weight matrix in the activation dtype — the
same values the reference's per-use ``astype`` produces, bit for bit, but
read at half the bytes in bf16 on every decode step.

The reference pins every hop boundary with ``jax.lax.optimization_barrier``
so XLA cannot fuse across blocks.  Eager PyTorch never fuses across ops, so
the port needs no counterpart — and must not be wrapped in ``torch.compile``,
which would bring back the cross-hop fusion the barrier exists to stop.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import _mlp_layer

# ---------------------------------------------------------------------------
# parameter trees (nested dicts/lists of tensors or numpy arrays)
# ---------------------------------------------------------------------------


def _flatten_with_path(tree, prefix=()):
    """(path, leaf) pairs with each path entry rendered as JAX renders its
    key-path entries (``DictKey(key='wq')``, ``SequenceKey(idx=0)``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_path(tree[k],
                                          prefix + (f"DictKey(key={k!r})",))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _flatten_with_path(x, prefix + (f"SequenceKey(idx={i})",))
    else:
        yield prefix, tree


def _path_str(path: Tuple[str, ...]) -> str:
    """``str()`` of the key-path tuple, exactly as Python prints it."""
    if len(path) == 1:
        return f"({path[0]},)"
    return "(" + ", ".join(path) + ")"


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in _flatten_with_path(tree)]


def _leaf_bytes(leaf) -> np.ndarray:
    """The leaf's C-order bytes as a host buffer (one copy off the device,
    none on the host)."""
    if isinstance(leaf, torch.Tensor):
        flat = leaf.detach().reshape(-1).contiguous().cpu()
        return flat.view(torch.uint8).numpy()
    return np.ascontiguousarray(leaf).reshape(-1).view(np.uint8)


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return leaf.size * leaf.dtype.itemsize


def tree_bytes(tree) -> int:
    return sum(_nbytes(x) for x in tree_leaves(tree))


def tree_hash(tree) -> str:
    """sha1 over the sorted key-path strings and each leaf's C-order bytes —
    the reference's ``tree_hash``, so block ids agree across packages.
    Each leaf is copied to the host once."""
    h = hashlib.sha1()
    for path, leaf in sorted(_flatten_with_path(tree),
                             key=lambda kv: _path_str(kv[0])):
        h.update(_path_str(path).encode())
        h.update(_leaf_bytes(leaf))
    return h.hexdigest()[:16]


ATTENTION_KINDS = ("layer", "attention")  # block kinds that own KV state
# parameters kept in fp32 at use: norm scales (rms_norm computes in fp32)
# and the embedding (gathered in fp32, then cast, as in the reference)
_FP32_AT_USE = ("ln1", "ln2", "final_ln", "embed")


@dataclass
class Block:
    id: str
    kind: str  # embed | layer | attention | ffn | lm_head | lora | adapter | bitfit | stitch
    model: str  # model that first contributed it
    layer_idx: Optional[int]
    d_in: int
    d_out: int
    params: dict
    cfg: Optional[ModelConfig] = None
    meta: dict = field(default_factory=dict)
    _compute: Dict[torch.dtype, dict] = field(default_factory=dict,
                                              repr=False, compare=False)

    @property
    def n_params(self) -> int:
        return sum(x.numel() for x in tree_leaves(self.params))

    @property
    def has_kv(self) -> bool:
        """True for blocks that carry attention KV state when serving."""
        return self.kind in ATTENTION_KINDS

    @property
    def kv_signature(self) -> Tuple[int, int]:
        """(kv_heads, head_dim) — the KV-pool signature this block's slots
        live under (one shared pool per signature, DESIGN.md §2)."""
        cfg = self.cfg
        return (cfg.num_kv_heads or cfg.num_heads, cfg.resolved_head_dim)

    def flops_per_token(self) -> float:
        """2 * params is the dense-matmul flops estimate per token."""
        return 2.0 * self.n_params

    def compute_params(self, dtype: torch.dtype) -> dict:
        """The params as used in ``dtype`` compute: weights cast once and
        cached (bitwise what a cast at every use gives), norm scales and
        the embedding left in fp32."""
        out = self._compute.get(dtype)
        if out is None:
            out = {k: v if k in _FP32_AT_USE else v.to(dtype)
                   for k, v in self.params.items()}
            self._compute[dtype] = out
        return out


# ---------------------------------------------------------------------------
# apply fns (full-sequence; serving engine drives these per block instance)
# ---------------------------------------------------------------------------


def _proj(h, w):
    """h (B, S, D) @ w (D, ...) -> (B, S, ...)."""
    return (h @ w.reshape(w.shape[0], -1)).reshape(*h.shape[:-1],
                                                   *w.shape[1:])


def _out_proj(o, wo):
    """o (B, S, H, hd) @ wo (H, hd, D) -> (B, S, D)."""
    return o.reshape(*o.shape[:-2], -1) @ wo.reshape(-1, wo.shape[-1])


def _qkv(h, p, adapters):
    q = _proj(h, p["wq"])
    k = _proj(h, p["wk"])
    v = _proj(h, p["wv"])
    return _peft_qkv(h, q, k, v, adapters)


def _attn_sublayer(x, p, cfg, positions, adapters=()):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(h, p, adapters)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    o = L.causal_attention(q, k, v, chunk=cfg.attn_chunk,
                           window=cfg.sliding_window)
    return x + _out_proj(o, p["wo"])


def _ffn_sublayer(x, p, cfg, adapters=()):
    out = _mlp_layer(x, p, cfg)
    for a in adapters:
        if a.kind == "adapter":
            ap = a.compute_params(out.dtype)
            h = L.gelu(out @ ap["down"])
            out = out + h @ ap["up"]
    return out


def _positions(x, positions):
    if positions is not None:
        return positions
    B, S = x.shape[:2]
    return torch.arange(S, device=x.device)[None].expand(B, S)


def apply_block(block: Block, x, *, positions=None, adapters=(),
                compute_dtype: torch.dtype = L.COMPUTE_DTYPE):
    """x: hidden states (B, S, D) — or token ids for embed blocks, whose
    output is cast to ``compute_dtype``."""
    cfg = block.cfg
    if block.kind == "embed":
        return block.params["embed"][x.long()].to(compute_dtype)
    p = block.compute_params(x.dtype)
    if block.kind == "lm_head":
        h = L.rms_norm(x, p["final_ln"], cfg.norm_eps)
        return h @ p["lm_head"]
    if block.kind == "layer":
        positions = _positions(x, positions)
        x0 = x
        x = _attn_sublayer(x, p, cfg, positions, adapters)
        out = _ffn_sublayer(x, p, cfg, adapters)
        if "recover_a" in p:  # surrogate LoRA recovery (paper §5.2)
            out = out + (x0 @ p["recover_a"]) @ p["recover_b"]
        return out
    if block.kind == "attention":
        return _attn_sublayer(x, p, cfg, _positions(x, positions), adapters)
    if block.kind == "ffn":
        return _ffn_sublayer(x, p, cfg, adapters)
    if block.kind == "stitch":
        B, S, D = x.shape
        posval = torch.full((B, S, 1), float(block.meta["position_value"]),
                            dtype=x.dtype, device=x.device)
        return torch.cat([x, posval], dim=-1) @ p["w"]
    raise ValueError(f"apply_block: {block.kind}")


# ---------------------------------------------------------------------------
# stateful block execution (real serving engine: paged KV pools)
# ---------------------------------------------------------------------------


def block_prefill_raw(block: Block, x, *, positions=None, adapters=(),
                      compute_dtype: torch.dtype = L.COMPUTE_DTYPE):
    """Prefill one block, returning the raw rotated K and V alongside the
    output (``(out, k_r, v)``; ``k_r``/``v`` are ``None`` for blocks without
    attention state).  The serving engine scatters the raw K/V into its
    shared page pool."""
    if block.kind not in ATTENTION_KINDS:
        out = apply_block(block, x, positions=positions, adapters=adapters,
                          compute_dtype=compute_dtype)
        return out, None, None
    cfg = block.cfg
    p = block.compute_params(x.dtype)
    positions = _positions(x, positions)
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(h, p, adapters)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k_r = L.apply_rope(k, positions, cfg.rope_theta)
    o = L.causal_attention(q, k_r, v, chunk=cfg.attn_chunk,
                           window=cfg.sliding_window)
    out = x + _out_proj(o, p["wo"])
    if block.kind == "layer":
        out = _ffn_sublayer(out, p, cfg, adapters)
    return out, k_r, v


def block_decode_paged(block: Block, x, k_pages, v_pages, block_tables,
                       kv_len, *, adapters=(), attn_impl: str = "auto",
                       compute_dtype: torch.dtype = L.COMPUTE_DTYPE):
    """One-token step over a shared paged KV pool (DESIGN.md §2).

    x: (B, 1, D) hidden states (or token ids for embed blocks);
    k_pages/v_pages: (P, page_size, KVH, hd) pool slabs; block_tables:
    (B, n) page ids per sequence; kv_len: (B,) tokens already cached.

    Writes the new token's K/V into the pool slabs in place and attends
    over the pages through the paged-attention kernel (CUDA on the card,
    the plain version on the CPU).  Returns (out, k_pages, v_pages).
    """
    if block.kind not in ATTENTION_KINDS:
        return (apply_block(block, x, adapters=adapters,
                            compute_dtype=compute_dtype), k_pages, v_pages)
    from repro_torch.kernels.paged_attention.ops import paged_decode_step

    cfg = block.cfg
    p = block.compute_params(x.dtype)
    positions = kv_len[:, None]
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(h, p, adapters)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    o, k_pages, v_pages = paged_decode_step(
        q[:, 0], k[:, 0], v[:, 0], k_pages, v_pages, block_tables, kv_len,
        impl=attn_impl)
    out = x + _out_proj(o.to(x.dtype), p["wo"])[:, None]
    if block.kind == "layer":
        out = _ffn_sublayer(out, p, cfg, adapters)
    return out, k_pages, v_pages


def _peft_qkv(h, q, k, v, adapters):
    for a in adapters:
        ap = a.compute_params(h.dtype)
        if a.kind == "lora":
            s = ap["scaling"]
            dq = ((h @ ap["a_q"]) @ ap["b_q"]) * s
            dv = ((h @ ap["a_v"]) @ ap["b_v"]) * s
            q = q + dq.reshape(q.shape).to(h.dtype)
            v = v + dv.reshape(v.shape).to(h.dtype)
        elif a.kind == "bitfit":
            q = q + ap["bq"]
            k = k + ap["bk"]
            v = v + ap["bv"]
    return q, k, v


# ---------------------------------------------------------------------------
# chain-level fused execution (one call for all hops of a chain)
# ---------------------------------------------------------------------------


def chain_signature(steps) -> Tuple:
    """Fusion key for a resolved chain: the ordered tuple of
    (block id, adapter ids) hops.  Requests with identical signatures run
    the same computation and can share one fused megastep."""
    return tuple((block.id, tuple(a.id for a in adapters))
                 for block, adapters in steps)


def _chain_step_fused(steps, pool_index, tokens, pools_k, pools_v, tables,
                      kv_len, attn_impl: str, compute_dtype: torch.dtype):
    """One single-token walk of a whole chain over the paged pools; the
    slabs in ``pools_k``/``pools_v`` are written in place.  Returns
    (next_tokens, probs)."""
    x = tokens[:, None]  # (B, 1) ids; the embed hop maps them to hidden
    hop = 0
    for block, adapters in steps:
        if block.has_kv:
            pi = pool_index[hop]
            x, _, _ = block_decode_paged(
                block, x, pools_k[pi], pools_v[pi], tables[hop], kv_len,
                adapters=adapters, attn_impl=attn_impl,
                compute_dtype=compute_dtype)
            hop += 1
        else:
            x = apply_block(block, x, adapters=adapters,
                            compute_dtype=compute_dtype)
    logits = x[:, 0]  # (B, V)
    next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)  # first max
    probs = torch.softmax(logits.float(), dim=-1)
    return next_tokens, probs


def chain_decode_fused(steps, pool_index, tokens, pools_k, pools_v, tables,
                       kv_len, *, attn_impl: str = "auto",
                       compute_dtype: torch.dtype = L.COMPUTE_DTYPE):
    """One full-chain decode megastep for a batch of sequences (DESIGN.md
    §2): embedding -> every attention/MLP/adapter hop (paged-KV decode with
    a single-token K/V scatter) -> lm_head -> greedy argmax + softmax, all
    on the device, with no host synchronisation.

    tokens: (B,) pending token ids; pools_k/pools_v: page slabs, one per
    KV-pool signature the chain touches, updated in place (the reference
    donates them instead); pool_index[i]: which slab the i-th attention hop
    uses; tables: one (B, n) page table per attention hop; kv_len: (B,)
    tokens already cached.

    Returns (next_tokens, probs, pools_k, pools_v, kv_len + 1).
    """
    next_tokens, probs = _chain_step_fused(
        steps, pool_index, tokens, pools_k, pools_v, tables, kv_len,
        attn_impl, compute_dtype)
    return next_tokens, probs, tuple(pools_k), tuple(pools_v), kv_len + 1


def chain_prefill_fused(steps, tokens, lens, *,
                        compute_dtype: torch.dtype = L.COMPUTE_DTYPE):
    """Batched multi-request prefill through a whole chain.

    tokens: (B, S) ids right-padded to the bucket length; lens: (B,) true
    prompt lengths.  Causality makes the padded tail inert for every valid
    position, so per-row results match the unpadded single-request path.

    Returns (next_tokens, probs, kvs) where kvs[i] = (k_r, v) raw rotated
    K/V (B, S, KVH, hd) for the i-th attention hop.
    """
    x = tokens
    kvs = []
    for block, adapters in steps:
        x, k_r, v = block_prefill_raw(block, x, adapters=adapters,
                                      compute_dtype=compute_dtype)
        if k_r is not None:
            kvs.append((k_r, v))
    B = x.shape[0]
    rows = torch.arange(B, device=x.device)
    logits = x[rows, lens.long() - 1]  # last valid position per row
    next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float(), dim=-1)
    return next_tokens, probs, kvs


@dataclass
class ChainStep:
    block_id: str
    adapter_ids: Tuple[str, ...] = ()


@dataclass
class BlockChain:
    model: str
    steps: List[ChainStep]

    def block_ids(self):
        return [s.block_id for s in self.steps]


def run_chain(zoo, chain: BlockChain, tokens, *, block_override=None,
              compute_dtype: torch.dtype = L.COMPUTE_DTYPE):
    """Execute a chain end-to-end (offline/eval path; the online engine
    drives blocks individually with KV state)."""
    x = tokens
    for step in chain.steps:
        bid = (block_override or {}).get(step.block_id, step.block_id)
        block = zoo.blocks[bid]
        adapters = tuple(zoo.blocks[a] for a in step.adapter_ids)
        x = apply_block(block, x, adapters=adapters,
                        compute_dtype=compute_dtype)
    return x
