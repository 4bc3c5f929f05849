"""Block abstraction (paper §4.2) in PyTorch — the port of
``repro.core.blocks``.

A Block is the unit of provisioning: a named dict of fp32 parameter tensors
plus an apply function determined by ``kind``.  Block ids are content
hashes computed exactly as the reference computes them, so identical
parameters get identical ids in both packages.

Numerics follow the reference: fp32 weights, activations in the compute
dtype, weights cast to the activation dtype at use.  ``Block.compute_params``
reads one cached copy of each weight matrix in the activation dtype — the
same values the reference's per-use ``astype`` produces, bit for bit, but
read at half the bytes in bf16 on every decode step.  The copy is cached
per source tensor, so blocks that alias a tensor (a surrogate and its
parent, a split attention/FFN block and its layer block) share one cast.

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
from repro_torch.kernels.batched_lora.ops import batched_lora
from repro_torch.models import layers as L
from repro_torch.models.layers import cast_once as _cast
from repro_torch.models.transformer import (
    _kernel_impl,
    _mlp_layer,
    _out_proj,
    prefill_attention,
)
from repro_torch.tree import (  # noqa: F401 (re-exported)
    _flatten_with_path,
    _path_str,
    tree_leaves,
)

# ---------------------------------------------------------------------------
# parameter trees (nested dicts/lists of tensors or numpy arrays), walked
# in JAX's flatten order (``repro_torch.tree``)
# ---------------------------------------------------------------------------


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
    _scaling: Dict[torch.dtype, float] = field(default_factory=dict,
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

    @property
    def bytes(self) -> int:
        return tree_bytes(self.params)

    def flops_per_token(self) -> float:
        """2 * params is the dense-matmul flops estimate per token."""
        return 2.0 * self.n_params

    def compute_params(self, dtype: torch.dtype) -> dict:
        """The params as used in ``dtype`` compute: weights cast once per
        tensor and shared with every block that aliases it (bitwise what a
        cast at every use gives), norm scales and the embedding left in
        fp32."""
        out = self._compute.get(dtype)
        if out is None:
            out = {k: v if k in _FP32_AT_USE else _cast(v, dtype)
                   for k, v in self.params.items()}
            self._compute[dtype] = out
            if self.kind == "lora":  # read off the device once, here
                self._scaling[dtype] = float(out["scaling"])
        return out

    def lora_scaling(self, dtype: torch.dtype) -> float:
        """A LoRA block's scaling in ``dtype`` as a Python float, read when
        the block is first cast: the LoRA kernel takes a float, and reading
        the device tensor at every hop would sync the host each time."""
        self.compute_params(dtype)
        return self._scaling[dtype]


# ---------------------------------------------------------------------------
# apply fns (full-sequence; serving engine drives these per block instance)
# ---------------------------------------------------------------------------


def _proj(h, w):
    """h (B, S, D) @ w (D, ...) -> (B, S, ...)."""
    return (h @ w.reshape(w.shape[0], -1)).reshape(*h.shape[:-1],
                                                   *w.shape[1:])


def _plain_qkv(h, p, adapters):
    q = _proj(h, p["wq"])
    k = _proj(h, p["wk"])
    v = _proj(h, p["wv"])
    return _peft_qkv(h, q, k, v, adapters)


_LORA_BT = 128  # row tile of the LoRA kernel's adapter ids (one adapter)
_ZERO_TILES: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _zero_tiles(n: int, device) -> torch.Tensor:
    """All-zeros int32 tile ids (one adapter), made once per (device, n)
    on the device itself: no host-to-device copy per call."""
    key = (torch.device(device), n)
    t = _ZERO_TILES.get(key)
    if t is None:
        t = _ZERO_TILES[key] = torch.zeros(n, dtype=torch.int32,
                                           device=device)
    return t


def _lora_proj(h, w, a, b, scaling: float, impl: str):
    """h (B, S, D) @ w (D, H, hd) + scaling * (h @ a) @ b through the
    batched-LoRA kernel with one adapter (G = 1)."""
    D = h.shape[-1]
    x = h.reshape(-1, D)
    tiles = _zero_tiles(-(-x.shape[0] // _LORA_BT), x.device)
    y = batched_lora(x, w.reshape(D, -1), a[None], b[None], tiles,
                     bt=_LORA_BT, scaling=scaling, impl=impl)
    return y.reshape(*h.shape[:-1], *w.shape[1:])


def _qkv(h, p, adapters, attn_impl: str = "auto"):
    """q, k, v projections with the hop's PEFT deltas.  Under a kernel
    route a LoRA adapter's q and v go through the batched-LoRA kernel
    (base product and low-rank delta in one fp32 sum); ``auto`` on a CPU
    tensor computes the reference's products (``_peft_qkv``)."""
    impl = _kernel_impl(h, attn_impl)
    lora = [a for a in adapters if a.kind == "lora"]
    if impl is None or not lora:
        return _plain_qkv(h, p, adapters)
    if len(lora) > 1:
        raise NotImplementedError(
            "the batched-LoRA kernel takes one LoRA adapter per hop")
    q = _adapted_proj(h, p["wq"], lora[0], "q", impl)
    k = _proj(h, p["wk"])
    v = _adapted_proj(h, p["wv"], lora[0], "v", impl)
    # BitFit biases after the LoRA deltas, as in the reference's loop
    return _peft_qkv(h, q, k, v, [x for x in adapters if x.kind != "lora"])


def _adapted_proj(h, w, lora, which: str, impl: Optional[str]):
    """``h @ w`` with LoRA adapter ``lora``'s delta for projection
    ``which`` (q or v), as ``_qkv`` computes it on route ``impl``: through
    the batched-LoRA kernel, or on the reference's route (``None``) the
    plain product plus the delta.  ``lora`` None: the plain product."""
    if lora is None:
        return _proj(h, w)
    ap = lora.compute_params(h.dtype)
    if impl is None:
        y = _proj(h, w)
        return y + _lora_delta(h, ap, which).reshape(y.shape).to(h.dtype)
    return _lora_proj(h, w, ap[f"a_{which}"], ap[f"b_{which}"],
                      lora.lora_scaling(h.dtype), impl)


def _attn_sublayer(x, p, cfg, positions, adapters=(), attn_impl="auto"):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _plain_qkv(h, p, adapters)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    o = prefill_attention(q, k, v, cfg, attn_impl)
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
                attn_impl: str = "auto",
                compute_dtype: torch.dtype = L.COMPUTE_DTYPE):
    """x: hidden states (B, S, D) — or token ids for embed blocks, whose
    output is cast to ``compute_dtype``.  Attention follows ``attn_impl``
    (``models.transformer.prefill_attention``): the flash kernel on a CUDA
    tensor under ``auto``."""
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
        x = _attn_sublayer(x, p, cfg, positions, adapters, attn_impl)
        out = _ffn_sublayer(x, p, cfg, adapters)
        if "recover_a" in p:  # surrogate LoRA recovery (paper §5.2)
            out = out + (x0 @ p["recover_a"]) @ p["recover_b"]
        return out
    if block.kind == "attention":
        return _attn_sublayer(x, p, cfg, _positions(x, positions), adapters,
                              attn_impl)
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
                      attn_impl: str = "auto",
                      compute_dtype: torch.dtype = L.COMPUTE_DTYPE):
    """Prefill one block, returning the raw rotated K and V alongside the
    output (``(out, k_r, v)``; ``k_r``/``v`` are ``None`` for blocks without
    attention state).  The serving engine scatters the raw K/V into its
    shared page pool.  ``attn_impl`` routes attention and LoRA q/v through
    the flash-attention and batched-LoRA kernels (``cuda``), their plain
    versions (``ref``), or by device (``auto``: kernels on a CUDA tensor,
    the port's copy of the reference's plain code on a CPU tensor); see
    ``models.transformer.prefill_attention``."""
    if block.kind not in ATTENTION_KINDS:
        out = apply_block(block, x, positions=positions, adapters=adapters,
                          compute_dtype=compute_dtype)
        return out, None, None
    cfg = block.cfg
    p = block.compute_params(x.dtype)
    positions = _positions(x, positions)
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(h, p, adapters, attn_impl)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k_r = L.apply_rope(k, positions, cfg.rope_theta)
    o = prefill_attention(q, k_r, v, cfg, attn_impl)
    out = x + _out_proj(o, p["wo"])
    if block.kind == "layer":
        out = _ffn_sublayer(out, p, cfg, adapters)
    return out, k_r, v


def block_prefill(block: Block, x, *, positions=None, adapters=(),
                  max_len=None, attn_impl: str = "auto",
                  compute_dtype: torch.dtype = L.COMPUTE_DTYPE):
    """Like apply_block, but attention-bearing blocks also return their
    dense KV cache (a dict: ``k``/``v`` (B, S, KVH, hd), int8 with scales
    if configured, a ring buffer under a sliding window) for
    ``block_decode``; other blocks return ``None`` for it."""
    out, k_r, v = block_prefill_raw(block, x, positions=positions,
                                    adapters=adapters, attn_impl=attn_impl,
                                    compute_dtype=compute_dtype)
    if k_r is None:
        return out, None
    return out, L.finalize_prefill_cache(k_r, v, block.cfg, max_len)


def block_decode(block: Block, x, cache, kv_len, *, adapters=(),
                 compute_dtype: torch.dtype = L.COMPUTE_DTYPE):
    """One-token step over the dense cache ``block_prefill`` returned.
    x: (B, 1, D); kv_len (B,).  Returns (out, new_cache); a write at or
    past the cache's end is dropped (a ring buffer wraps instead).

    The reference runs plain jnp here (no TPU kernel), and so does this,
    on any device; the serving engine's decode is ``block_decode_paged``."""
    cfg = block.cfg
    if block.kind not in ATTENTION_KINDS:
        return apply_block(block, x, adapters=adapters,
                           compute_dtype=compute_dtype), cache
    p = block.compute_params(x.dtype)
    positions = kv_len[:, None]
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _plain_qkv(h, p, adapters)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    cache = L.cache_insert(cache, k, v, kv_len, cfg)
    kc, vc = L.cache_kv_arrays(cache, cfg, x.dtype)
    S = kc.shape[1]
    valid = torch.clamp(kv_len + 1, max=S)
    o = L.decode_attention(q, kc, vc, valid, window=0)
    out = x + _out_proj(o.to(x.dtype), p["wo"])
    if block.kind == "layer":
        out = _ffn_sublayer(out, p, cfg, adapters)
    return out, cache


def block_decode_paged(block: Block, x, k_pages, v_pages, block_tables,
                       kv_len, *, adapters=(), attn_impl: str = "auto",
                       compute_dtype: torch.dtype = L.COMPUTE_DTYPE):
    """One-token step over a shared paged KV pool (DESIGN.md §2).

    x: (B, 1, D) hidden states (or token ids for embed blocks);
    k_pages/v_pages: (P, page_size, KVH, hd) pool slabs; block_tables:
    (B, n) page ids per sequence; kv_len: (B,) tokens already cached.

    Writes the new token's K/V into the pool slabs in place and attends
    over the pages through the paged-attention kernel (CUDA on the card,
    the plain version on the CPU); LoRA q/v follow ``attn_impl`` as in
    ``block_prefill_raw``.  Returns (out, k_pages, v_pages).
    """
    if block.kind not in ATTENTION_KINDS:
        return (apply_block(block, x, adapters=adapters,
                            compute_dtype=compute_dtype), k_pages, v_pages)
    from repro_torch.kernels.paged_attention.ops import paged_decode_step

    cfg = block.cfg
    p = block.compute_params(x.dtype)
    positions = kv_len[:, None]
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(h, p, adapters, attn_impl)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    o, k_pages, v_pages = paged_decode_step(
        q[:, 0], k[:, 0], v[:, 0], k_pages, v_pages, block_tables, kv_len,
        impl=attn_impl)
    out = x + _out_proj(o.to(x.dtype), p["wo"])[:, None]
    if block.kind == "layer":
        out = _ffn_sublayer(out, p, cfg, adapters)
    return out, k_pages, v_pages


def _lora_delta(h, ap, which: str):
    """A LoRA adapter's low-rank product for projection ``which`` (q or v),
    scaled, in the reference's order."""
    return ((h @ ap[f"a_{which}"]) @ ap[f"b_{which}"]) * ap["scaling"]


def _peft_qkv(h, q, k, v, adapters):
    for a in adapters:
        ap = a.compute_params(h.dtype)
        if a.kind == "lora":
            q = q + _lora_delta(h, ap, "q").reshape(q.shape).to(h.dtype)
            v = v + _lora_delta(h, ap, "v").reshape(v.shape).to(h.dtype)
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
    return _sample(x)


def _sample(x):
    """Greedy next tokens and their distributions from the head's (B, 1, V)
    output."""
    logits = x[:, 0]  # (B, V)
    next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)  # first max
    probs = torch.softmax(logits.float(), dim=-1)
    return next_tokens, probs


# ---------------------------------------------------------------------------
# one decode walk over several chains (per-block batching across apps,
# paper §5.2): the lanes of every chain run together, hop position by hop
# position, and each weight is read once a walk
# ---------------------------------------------------------------------------

_ATTN_PARAMS = frozenset(("ln1", "wq", "wk", "wv", "wo"))
_FFN_PARAMS = frozenset(("ln2", "w_gate", "w_up", "w_down"))
# the weight ops of each sublayer kind, in walk order
_OPS = {"embed": ("embed",), "attn": ("ln1", "q", "k", "v", "wo"),
        "ffn": ("ffn",), "head": ("head",)}
# the parameters each op reads (q and v also read the position's LoRA)
_OP_PARAMS = {"embed": ("embed",), "ln1": ("ln1",), "q": ("wq",),
              "k": ("wk",), "v": ("wv",), "wo": ("wo",),
              "ffn": tuple(sorted(_FFN_PARAMS)),
              "head": ("final_ln", "lm_head")}


@dataclass(eq=False)
class ChainLayout:
    """A chain's decode walk as sublayer positions (``chain_layout``).

    ``subs``: per position ``(kind, block, lora)``: kind ``embed``,
    ``attn`` (a ``layer`` block's attention part or an ``attention``
    block), ``ffn`` (a ``layer`` block's FFN part or an ``ffn`` block) or
    ``head``; ``lora`` the attention part's LoRA adapter or None.
    ``shape``: what two chains need alike to run as one walk: each
    position's kind, KV-pool signature and widths.  ``weights``: (position,
    op, weight key) of every op the walk runs."""
    subs: Tuple[Tuple[str, Block, Optional[Block]], ...]
    shape: Tuple
    weights: frozenset


def _weight_key(op: str, block: Block, lora: Optional[Block]) -> Tuple:
    """What an op reads.  Tensors are compared by identity: a split half
    aliases its layer block's tensors, and a block that dedup made shared
    is one object, so chains that share a weight give the same key."""
    key = tuple(id(block.params[n]) for n in _OP_PARAMS[op])
    if op in ("q", "v"):
        key += (None if lora is None else lora.id,)
    return key


def chain_layout(steps) -> Optional[ChainLayout]:
    """The chain's ``ChainLayout``, or None where the merged walk cannot
    run it: an adapter other than one LoRA adapter on an attention part
    (BitFit, bottleneck adapters: those chains keep their own megastep), or
    a block with parameters beyond the dense block's (a surrogate's
    recovery, MoE experts, a stitch)."""
    subs = []
    for block, adapters in steps:
        if len(adapters) > 1 or any(a.kind != "lora" for a in adapters):
            return None
        lora = adapters[0] if adapters else None
        keys = set(block.params)
        if block.kind == "embed" and keys == {"embed"}:
            subs.append(("embed", block, None))
        elif block.kind == "lm_head" and keys == {"final_ln", "lm_head"}:
            subs.append(("head", block, None))
        elif block.kind == "layer" and keys == _ATTN_PARAMS | _FFN_PARAMS:
            subs += [("attn", block, lora), ("ffn", block, None)]
        elif block.kind == "attention" and keys == _ATTN_PARAMS:
            subs.append(("attn", block, lora))
        elif block.kind == "ffn" and keys == _FFN_PARAMS and lora is None:
            subs.append(("ffn", block, None))
        else:
            return None
    shape = []
    for kind, block, _ in subs:
        cfg = block.cfg
        widths = (block.d_in, block.d_out, cfg.norm_eps)
        if kind == "attn":
            widths += (block.kv_signature, cfg.num_heads, cfg.rope_theta,
                       cfg.sliding_window)
        shape.append((kind,) + widths)
    weights = frozenset((j, op, _weight_key(op, block, lora))
                        for j, (kind, block, lora) in enumerate(subs)
                        for op in _OPS[kind])
    return ChainLayout(tuple(subs), tuple(shape), weights)


class MergedChains:
    """The single-token decode walk of several chains with one
    ``ChainLayout.shape``, over one batch of lanes, each lane tagged with
    its chain's index by ``lane_chain``.

    At each position every weight op runs once per distinct weight set
    (``positions``: per op, the sets in order, each with the chains that
    read it) over every lane; each lane keeps the output of its own
    chain's set (``torch.where``), so it computes its own chain's
    arithmetic on its own weights.  An op whose set every chain shares runs
    once, as does each position's paged attention call, which reads and
    writes every lane's own pages: a lane's K/V come from its own chain's
    projections.  With one chain the walk is ``_chain_step_fused``'s.

    ``subsets``: the chain sets whose lane masks a walk needs;
    ``n_attn``: paged attention calls a walk issues; ``lora_projections``:
    LoRA q and v projections a walk issues, each over every lane."""

    def __init__(self, layouts):
        self.layouts = tuple(layouts)
        if len({lay.shape for lay in self.layouts}) != 1:
            raise ValueError("merged chains need one sublayer layout")
        self.positions = []
        subsets = set()
        self.lora_projections = 0
        for subs in zip(*(lay.subs for lay in self.layouts)):
            kind = subs[0][0]
            ops = {}
            for op in _OPS[kind]:
                sets: Dict[Tuple, Tuple[Tuple, set]] = {}
                for c, (_, block, lora) in enumerate(subs):
                    sets.setdefault(_weight_key(op, block, lora),
                                    ((block, lora), set()))[1].add(c)
                ops[op] = tuple((w, frozenset(cs)) for w, cs in sets.values())
                subsets.update(cs for _, cs in ops[op][1:])
                if op in ("q", "v"):
                    self.lora_projections += sum(
                        lora is not None for (_, lora), _ in ops[op])
            self.positions.append((kind, ops))
        self.subsets = tuple(sorted(subsets, key=sorted))
        self.n_attn = sum(kind == "attn" for kind, _ in self.positions)


def _select(op, masks, fn, *args):
    """``fn(block, lora, *args)`` of the op's first weight set over every
    lane, overwritten on the lanes of each further set by that set's."""
    (w, _), *rest = op
    out = fn(*w, *args)
    for w, chains in rest:
        y = fn(*w, *args)
        m = masks[chains].view(-1, *(1,) * (y.dim() - 1))
        out = torch.where(m, y, out)
    return out


def _apply_op(block, _lora, x, compute_dtype):
    return apply_block(block, x, compute_dtype=compute_dtype)


def _ffn_op(block, _lora, x):
    return _ffn_sublayer(x, block.compute_params(x.dtype), block.cfg)


def _norm_op(block, _lora, x):
    return L.rms_norm(x, block.compute_params(x.dtype)["ln1"],
                      block.cfg.norm_eps)


def _proj_op(block, lora, h, name: str, impl):
    w = block.compute_params(h.dtype)[f"w{name}"]
    return _proj(h, w) if name == "k" else _adapted_proj(h, w, lora, name,
                                                         impl)


def _out_op(block, _lora, o):
    return _out_proj(o, block.compute_params(o.dtype)["wo"])


def _merged_attn(x, ops, masks, k_pages, v_pages, table, kv_len,
                 attn_impl: str):
    """An attention position of the merged walk: ``block_decode_paged``'s
    attention sublayer, each weight op per weight set, one paged call."""
    from repro_torch.kernels.paged_attention.ops import paged_decode_step

    cfg = ops["ln1"][0][0][0].cfg
    impl = _kernel_impl(x, attn_impl)
    positions = kv_len[:, None]
    h = _select(ops["ln1"], masks, _norm_op, x)
    q = _select(ops["q"], masks, _proj_op, h, "q", impl)
    k = _select(ops["k"], masks, _proj_op, h, "k", impl)
    v = _select(ops["v"], masks, _proj_op, h, "v", impl)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    o, _, _ = paged_decode_step(q[:, 0], k[:, 0], v[:, 0], k_pages, v_pages,
                                table, kv_len, impl=attn_impl)
    return x + _select(ops["wo"], masks, _out_op, o.to(x.dtype))[:, None]


def _merged_step_fused(plan: MergedChains, pool_index, tokens, pools_k,
                       pools_v, tables, kv_len, lane_chain, attn_impl: str,
                       compute_dtype: torch.dtype):
    """``_chain_step_fused`` over the lanes of every chain of ``plan``;
    ``lane_chain``: (B,) each lane's chain index in the plan."""
    masks = {}
    for chains in plan.subsets:
        c0, *rest = sorted(chains)
        m = lane_chain == c0
        for c in rest:
            m = m | (lane_chain == c)
        masks[chains] = m
    x = tokens[:, None]  # (B, 1) ids; the embed position maps them
    hop = 0
    for kind, ops in plan.positions:
        if kind == "attn":
            pi = pool_index[hop]
            x = _merged_attn(x, ops, masks, pools_k[pi], pools_v[pi],
                             tables[hop], kv_len, attn_impl)
            hop += 1
        elif kind == "ffn":
            x = _select(ops["ffn"], masks, _ffn_op, x)
        else:
            x = _select(ops[kind], masks, _apply_op, x, compute_dtype)
    return _sample(x)


def chain_decode_fused(steps, pool_index, tokens, pools_k, pools_v, tables,
                       kv_len, *, attn_impl: str = "auto",
                       compute_dtype: torch.dtype = L.COMPUTE_DTYPE,
                       lane_chain: Optional[torch.Tensor] = None):
    """One full-chain decode megastep for a batch of sequences (DESIGN.md
    §2): embedding -> every attention/MLP/adapter hop (paged-KV decode with
    a single-token K/V scatter) -> lm_head -> greedy argmax + softmax, all
    on the device, with no host synchronisation.

    tokens: (B,) pending token ids; pools_k/pools_v: page slabs, one per
    KV-pool signature the chain touches, updated in place (the reference
    donates them instead); pool_index[i]: which slab the i-th attention hop
    uses; tables: one (B, n) page table per attention hop; kv_len: (B,)
    tokens already cached.

    ``steps`` may be a ``MergedChains``: then one walk serves the lanes of
    all its chains, ``lane_chain`` (B,) naming each lane's chain, and the
    i-th attention hop is every chain's i-th (its tables hold each lane's
    own pages).

    Returns (next_tokens, probs, pools_k, pools_v, kv_len + 1).
    """
    if isinstance(steps, MergedChains):
        next_tokens, probs = _merged_step_fused(
            steps, pool_index, tokens, pools_k, pools_v, tables, kv_len,
            lane_chain, attn_impl, compute_dtype)
    else:
        next_tokens, probs = _chain_step_fused(
            steps, pool_index, tokens, pools_k, pools_v, tables, kv_len,
            attn_impl, compute_dtype)
    return next_tokens, probs, tuple(pools_k), tuple(pools_v), kv_len + 1


def chain_decode_spec_fused(steps, sur_steps, pool_index, tokens, pools_k,
                            pools_v, tables, kv_len, budget, *,
                            lookahead: int, attn_impl: str = "auto",
                            compute_dtype: torch.dtype = L.COMPUTE_DTYPE):
    """Draft-verify speculative decode megastep (paper §5.2, DESIGN.md §2):
    one call that commits up to ``lookahead`` tokens per sequence while
    staying bitwise identical to ``lookahead`` plain ``chain_decode_fused``
    calls.

    Phase 1 (draft): the surrogate chain ``sur_steps`` — the same chain
    with its FFN hops structurally pruned
    (``core.surrogates.build_surrogate(prune_kv=False)``, so every
    attention hop keeps the full chain's KV signature and page tables) —
    runs ``lookahead - 1`` sequential single-token walks, drafting tokens
    d_1..d_{k-1} after the pending token p.  Its K/V writes land in the
    shared pools at positions kv_len..kv_len+k-2 as scratch.

    Phase 2 (verify): the full chain replays [p, d_1, .., d_{k-1}] through
    ``_chain_step_fused``, the very call the plain megastep makes,
    overwriting the draft scratch with true K/V and producing the true
    next token n_j at every position.  d_j is accepted iff it equals
    n_{j-1}, so the committed stream is the full model's greedy stream,
    bit for bit.

    Rollback is positional: ``kv_len`` only advances past accepted
    positions, so K/V written beyond the accepted prefix is dead — later
    steps overwrite those slots and attention masks them out meanwhile.
    Callers must size KV slots with ``lookahead`` tokens of headroom
    because both phases write up to ``kv_len + lookahead - 1``.

    budget: (B,) max tokens each lane may commit this call (the engine
    passes remaining gen budget minus one, keeping the pending-token
    finish protocol intact); accepted drafts are clamped to ``budget - 1``.

    Returns (commit_tok (B, k) committed-token candidates [p, d_1, ..],
    commit_cnt (B,) how many of them committed (>= 1), accepted (B,)
    drafts accepted, attempts (B,) drafts that could have committed,
    next_tokens (B,) new pending token, probs (B, V) its distribution,
    pools_k, pools_v, kv_len + commit_cnt).
    """
    k = lookahead
    if k < 2:
        raise ValueError("speculative decode needs lookahead >= 2")
    B = tokens.shape[0]
    # phase 1: sequential surrogate drafts (cheap pruned-FFN chain walks)
    cur = tokens
    drafts = []
    for j in range(k - 1):
        cur, _ = _chain_step_fused(sur_steps, pool_index, cur, pools_k,
                                   pools_v, tables, kv_len + j, attn_impl,
                                   compute_dtype)
        drafts.append(cur)
    # The reference pins this phase boundary with an optimization_barrier
    # so XLA cannot fuse draft numerics into the verify pass; eager PyTorch
    # runs each op as issued, so the verify walks below are the plain
    # megastep's calls unchanged and need no counterpart.
    # phase 2: exact sequential verify of [p, d_1, .., d_{k-1}]
    inputs = [tokens] + drafts
    outs, probs_steps = [], []
    for j in range(k):
        nxt, probs = _chain_step_fused(steps, pool_index, inputs[j], pools_k,
                                       pools_v, tables, kv_len + j,
                                       attn_impl, compute_dtype)
        outs.append(nxt)
        probs_steps.append(probs)
    commit_tok = torch.stack(inputs, dim=1)    # (B, k)
    outs_m = torch.stack(outs, dim=1)          # (B, k): n_0..n_{k-1}
    probs_m = torch.stack(probs_steps, dim=1)  # (B, k, V)
    # accept: longest drafted prefix matching the true argmaxes, clamped so
    # a lane never commits past its remaining generation budget
    match = (commit_tok[:, 1:] == outs_m[:, :-1]).to(torch.int32)
    accepted = torch.cumprod(match, dim=1).sum(dim=1, dtype=torch.int32)
    attempts = torch.clamp(budget.to(torch.int32) - 1, min=0, max=k - 1)
    accepted = torch.minimum(accepted, attempts)
    commit_cnt = accepted + 1
    lane = torch.arange(B, device=tokens.device)
    acc = accepted.long()
    next_tokens = outs_m[lane, acc]
    probs_out = probs_m[lane, acc]
    return (commit_tok, commit_cnt, accepted, attempts, next_tokens,
            probs_out, tuple(pools_k), tuple(pools_v), kv_len + commit_cnt)


def chain_prefill_fused(steps, tokens, lens, *, attn_impl: str = "auto",
                        compute_dtype: torch.dtype = L.COMPUTE_DTYPE):
    """Batched multi-request prefill through a whole chain.

    tokens: (B, S) ids right-padded to the bucket length; lens: (B,) true
    prompt lengths.  Causality makes the padded tail inert for every valid
    position, so per-row results match the unpadded single-request path.
    ``attn_impl`` routes each hop as in ``block_prefill_raw``.

    Returns (next_tokens, probs, kvs) where kvs[i] = (k_r, v) raw rotated
    K/V (B, S, KVH, hd) for the i-th attention hop.
    """
    x = tokens
    kvs = []
    for block, adapters in steps:
        x, k_r, v = block_prefill_raw(block, x, adapters=adapters,
                                      attn_impl=attn_impl,
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
              attn_impl: str = "auto",
              compute_dtype: torch.dtype = L.COMPUTE_DTYPE):
    """Execute a chain end-to-end (offline/eval path; the online engine
    drives blocks individually with KV state).  Attention follows
    ``attn_impl``, as in ``apply_block``."""
    x = tokens
    for step in chain.steps:
        bid = (block_override or {}).get(step.block_id, step.block_id)
        block = zoo.blocks[bid]
        adapters = tuple(zoo.blocks[a] for a in step.adapter_ids)
        x = apply_block(block, x, adapters=adapters, attn_impl=attn_impl,
                        compute_dtype=compute_dtype)
    return x
