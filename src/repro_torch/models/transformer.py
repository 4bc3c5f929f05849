"""Dense decoder-only transformer (llama/qwen family, with qwen2-vl's
M-RoPE backbone) in PyTorch — the port of ``repro.models.transformer``'s
init, prefill and decode entry points (training waits: ROADMAP.md §1).

Parameters are dicts of fp32 tensors in the reference's layouts:
``wq (D,H,hd)``, ``wk``/``wv (D,KVH,hd)``, ``wo (H,hd,D)``,
``w_gate``/``w_up (D,F)``, ``w_down (F,D)``, ``embed (V,D)``,
``lm_head (D,V)``, ``bq``/``bk``/``bv`` with ``qkv_bias``; ``init_dense``
stacks the layers on a leading axis.  Weights are cast to the compute
dtype once per tensor (``layers.cast_once``), not at every use.

Attention goes through the port's kernels on a CUDA tensor (``attn_impl``
``auto`` or ``cuda``): prefill through the flash-attention kernel, decode
over the stacked bf16/fp32 cache through the paged-attention kernel, each
layer's ``(B, S, KVH, hd)`` cache slice seen as a pool of one S-token page
per sequence (one launch per layer: the token's K/V write and the
attention).  ``ref`` runs the kernels' plain versions on any device;
``auto`` on a CPU tensor runs the reference's plain code.  An int8 cache
or a sliding window takes the reference's plain route whatever
``attn_impl`` says: the reference has no kernel for either.
A shape the kernels do not take raises ``NotImplementedError`` under
``auto``/``cuda``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention import kernel as pa_kernel
from repro_torch.kernels.paged_attention.ops import (
    paged_attention,
    paged_decode_step,
)
from repro_torch.models import layers as L
from repro_torch.models.layers import cast_once

ATTN_IMPLS = ("auto", "ref", "cuda")

# attention calls of dense_decode_step by route since the counts were last
# set to 0, one per layer: ``paged`` (the kernel), ``paged_ref`` (its plain
# version), ``int8`` and ``window`` (the reference's plain routes the config
# picks), ``plain`` (the reference's plain code: ``auto`` on a CPU tensor)
DECODE_ROUTES = {"paged": 0, "paged_ref": 0, "int8": 0, "window": 0,
                 "plain": 0}

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_dense_layer(cfg: ModelConfig, gen: torch.Generator,
                     device=None) -> dict:
    hd = cfg.resolved_head_dim
    D, F, H, KVH = cfg.d_model, cfg.d_ff, cfg.num_heads, cfg.num_kv_heads
    dev = device if device is not None else gen.device
    p = {
        "ln1": torch.ones((D,), dtype=torch.float32, device=dev),
        "ln2": torch.ones((D,), dtype=torch.float32, device=dev),
        "wq": L.dense_init(gen, (D, H, hd), device=dev),
        "wk": L.dense_init(gen, (D, KVH, hd), device=dev),
        "wv": L.dense_init(gen, (D, KVH, hd), device=dev),
        "wo": L.dense_init(gen, (H, hd, D), in_axis_size=H * hd, device=dev),
        "w_gate": L.dense_init(gen, (D, F), device=dev),
        "w_up": L.dense_init(gen, (D, F), device=dev),
        "w_down": L.dense_init(gen, (F, D), in_axis_size=F, device=dev),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, hd), dtype=torch.float32, device=dev)
        p["bk"] = torch.zeros((KVH, hd), dtype=torch.float32, device=dev)
        p["bv"] = torch.zeros((KVH, hd), dtype=torch.float32, device=dev)
    return p


def init_dense(cfg: ModelConfig, gen: torch.Generator, device=None) -> dict:
    """Random fp32 parameters drawn from ``gen``, on ``device`` (default
    ``gen``'s; ``meta`` gives shapes and allocates nothing); layers stacked
    on a leading (L, ...) axis as in the reference."""
    dev = device if device is not None else gen.device
    embed = L.dense_init(gen, (cfg.vocab_size, cfg.d_model),
                         in_axis_size=cfg.d_model, device=dev)
    per_layer = [init_dense_layer(cfg, gen, dev)
                 for _ in range(cfg.num_layers)]
    layers = {k: torch.stack([p[k] for p in per_layer])
              for k in per_layer[0]}
    del per_layer
    return {
        "embed": embed,
        "layers": layers,
        "final_ln": torch.ones((cfg.d_model,), dtype=torch.float32,
                               device=dev),
        "lm_head": L.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                device=dev),
    }


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def _mlp_layer(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU MLP sublayer with its residual: x + W_down(silu(W_g h) * W_u h),
    h = rms_norm(x).  Weights are cast to the activation dtype at use (a
    no-op when the caller hands in weights already cast)."""
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    g = torch.nn.functional.silu(h @ p["w_gate"].to(h.dtype))
    u = h @ p["w_up"].to(h.dtype)
    o = (g * u) @ p["w_down"].to(h.dtype)
    return x + o


def _dense_layer_fwd(x, p, cfg: ModelConfig, positions,
                     attn_impl: str = "auto") -> torch.Tensor:
    x = _attn_layer_full(x, p, cfg, positions, attn_impl=attn_impl)
    return _mlp_layer(x, p, cfg)


# ---------------------------------------------------------------------------
# attention routes
# ---------------------------------------------------------------------------


def _kernel_impl(x, attn_impl: str) -> Optional[str]:
    """The kernel route ``attn_impl`` selects for a tensor: ``None`` for the
    reference's plain code (``auto`` on a CPU tensor), else ``"cuda"`` or
    ``"ref"`` (the kernel's plain version)."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r}; one of {ATTN_IMPLS}")
    if attn_impl == "auto":
        return "cuda" if x.is_cuda else None
    return attn_impl


def prefill_attention(q, k, v, cfg: ModelConfig, attn_impl: str):
    """Causal prefill attention over (B, S, H, hd) tensors: the flash
    kernel (``cuda``) or its plain version (``ref``) on transposed views,
    or the reference's query-chunked ``layers.causal_attention`` (``auto``
    on a CPU tensor)."""
    impl = _kernel_impl(q, attn_impl)
    if impl is None:
        return L.causal_attention(q, k, v, chunk=cfg.attn_chunk,
                                  window=cfg.sliding_window)
    if cfg.sliding_window:
        raise NotImplementedError(
            "the flash-attention kernel has no sliding window")
    hd = q.shape[-1]
    if impl == "cuda" and hd not in fa_kernel.HEAD_DIMS:
        raise NotImplementedError(
            f"the flash-attention kernel has no head dim {hd} (it takes "
            f"{fa_kernel.HEAD_DIMS})")
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=True, impl=impl)
    return o.transpose(1, 2)


def decode_route(cfg: ModelConfig, x, attn_impl: str) -> str:
    """The decode attention route, from the config first (an int8 cache or
    a sliding window runs the reference's plain route), then from
    ``attn_impl``: a key of ``DECODE_ROUTES``."""
    if cfg.kv_cache_dtype == "int8":
        return "int8"
    if cfg.sliding_window:
        return "window"
    impl = _kernel_impl(x, attn_impl)
    if impl is None:
        return "plain"
    hd, G = cfg.resolved_head_dim, cfg.num_heads // cfg.num_kv_heads
    if impl == "cuda" and (hd not in pa_kernel.HEAD_DIMS
                           or G > pa_kernel.MAX_GROUP):
        raise NotImplementedError(
            f"the paged-attention kernel has no head dim {hd} with "
            f"{G} query heads per KV head (it takes {pa_kernel.HEAD_DIMS}, "
            f"at most {pa_kernel.MAX_GROUP})")
    return "paged" if impl == "cuda" else "paged_ref"


# ---------------------------------------------------------------------------
# shared pieces of the entry points
# ---------------------------------------------------------------------------


def _layer_params(params: dict, i: int, dtype: torch.dtype) -> dict:
    """Layer ``i``'s parameters for ``dtype`` compute: weights from one
    cast of each stacked tensor, norm scales in fp32."""
    return {k: v[i] if k in ("ln1", "ln2") else cast_once(v, dtype)[i]
            for k, v in params["layers"].items()}


def _embed_tokens(params: dict, cfg: ModelConfig, batch: dict,
                  dtype: torch.dtype) -> torch.Tensor:
    tokens = batch["tokens"]
    h = params["embed"][tokens.long()].to(dtype)
    if cfg.num_visual_tokens and "visual_embeds" in batch:
        vis = batch["visual_embeds"].to(device=h.device, dtype=dtype)
        # after BOS; the start clamps as dynamic_update_slice's does
        start = max(0, min(1, h.shape[1] - vis.shape[1]))
        h[:, start:start + vis.shape[1]] = vis
    return h


def _positions(cfg: ModelConfig, batch: dict, B: int, S: int, device,
               offset=None) -> torch.Tensor:
    """(B, S) positions from 0 or from ``offset`` (B,), or M-RoPE's
    (B, S, 3) streams (the batch's ``mrope_positions`` if it has them,
    else the same position in each stream)."""
    if cfg.mrope_sections and "mrope_positions" in batch:
        return batch["mrope_positions"].to(device)
    base = torch.arange(S, device=device)[None, :]
    if offset is not None:
        base = offset.to(device).long()[:, None] + base
    base = base.expand(B, S)
    if cfg.mrope_sections:
        return base[..., None].expand(B, S, len(cfg.mrope_sections))
    return base


def _qkv(x, p, cfg: ModelConfig):
    B, S, D = x.shape
    q, k, v = ((x @ p[w].reshape(D, -1)).reshape(B, S, -1,
                                                  cfg.resolved_head_dim)
               for w in ("wq", "wk", "wv"))
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def _out_proj(o, wo):
    """o (B, S, H, hd) @ wo (H, hd, D) -> (B, S, D)."""
    return o.reshape(*o.shape[:-2], -1) @ wo.reshape(-1, wo.shape[-1])


def _attn_layer_full(x, p, cfg: ModelConfig, positions, *,
                     attn_impl: str = "auto", return_kv: bool = False):
    """Full-sequence attention sublayer with its residual (prefill)."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(h, p, cfg)
    q = L.apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = L.apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    o = prefill_attention(q, k, v, cfg, attn_impl)
    x = x + _out_proj(o, p["wo"])
    if return_kv:
        return x, (k, v)
    return x


def _logits(params: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    h = L.rms_norm(h, params["final_ln"], cfg.norm_eps)
    return h @ cast_once(params["lm_head"], h.dtype)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def dense_prefill(params: dict, cfg: ModelConfig, batch: dict, *,
                  max_len=None, attn_impl: str = "auto",
                  compute_dtype: torch.dtype = L.COMPUTE_DTYPE):
    """Returns (last-prompt-position logits (B, V), cache, prompt_lens (B,)).

    batch: ``tokens`` (B, S), optionally ``prompt_lens`` (B,) (default S),
    ``visual_embeds`` and ``mrope_positions`` (qwen2-vl).  ``max_len``
    over-allocates the cache for decode growth; the cache is the stacked
    ``(L, B, max_len, KVH, hd)`` dict of ``layers.init_kv_cache``.
    """
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = params["embed"].device
    h = _embed_tokens(params, cfg, batch, compute_dtype)
    positions = _positions(cfg, batch, B, S, dev)
    prompt_lens = batch.get("prompt_lens")
    if prompt_lens is None:
        prompt_lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    cache = None
    for i in range(cfg.num_layers):
        p = _layer_params(params, i, compute_dtype)
        h, (k, v) = _attn_layer_full(h, p, cfg, positions,
                                     attn_impl=attn_impl, return_kv=True)
        h = _mlp_layer(h, p, cfg)
        layer = L.finalize_prefill_cache(k, v, cfg, max_len)
        if cache is None:
            cache = {n: torch.empty((cfg.num_layers,) + t.shape,
                                    dtype=t.dtype, device=t.device)
                     for n, t in layer.items()}
        for n, t in layer.items():
            cache[n][i] = t
    # hidden state at the last prompt position of each sequence
    idx = torch.clamp(prompt_lens.to(dev).long() - 1, 0, S - 1)
    h_last = h[torch.arange(B, device=dev), idx]
    return _logits(params, cfg, h_last), cache, prompt_lens


def dense_decode_step(params: dict, cfg: ModelConfig, cache: dict,
                      batch: dict, *, attn_impl: str = "auto",
                      compute_dtype: torch.dtype = L.COMPUTE_DTYPE):
    """batch: ``tokens`` (B, 1), ``kv_len`` (B,).  Returns (logits (B, V),
    cache), the cache updated in place with one token write per layer
    (what donation does in the reference).

    A write at ``kv_len >= S`` (the cache's length) is dropped and the
    token attends over the S cached positions, as in the reference (JAX
    drops an out-of-bounds scatter).  On the paged routes the step reads
    ``max(kv_len)`` on the host once to know: when some row has run out,
    each layer writes through the plain masked insert and launches the
    attend-only kernel over ``min(kv_len + 1, S)`` positions instead of
    the fused write-and-attend launch.
    """
    tokens = batch["tokens"]
    kv_len = batch["kv_len"]
    B = tokens.shape[0]
    dev = params["embed"].device
    x = params["embed"][tokens.long()].to(compute_dtype)
    positions = _positions(cfg, batch, B, 1, dev, offset=kv_len)
    route = decode_route(cfg, x, attn_impl)
    S = cache["k"].shape[2]
    valid = torch.clamp(kv_len.to(dev) + 1, max=S).to(torch.int32)
    if route in ("paged", "paged_ref"):
        impl = "cuda" if route == "paged" else "ref"
        kv32 = kv_len.to(device=dev, dtype=torch.int32)
        tables = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
        overflow = int(kv32.max()) >= S
    for i in range(cfg.num_layers):
        p = _layer_params(params, i, compute_dtype)
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = _qkv(h, p, cfg)
        q = L.apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = L.apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
        if route in ("paged", "paged_ref"):
            # the layer's (B, S, KVH, hd) slice: B pages of S tokens
            k_pages, v_pages = cache["k"][i], cache["v"][i]
            if overflow:
                L.cache_insert_layer(cache, i, k, v, kv_len, cfg)
                o = paged_attention(q[:, 0], k_pages, v_pages, tables, valid,
                                    impl=impl)
            else:
                o, _, _ = paged_decode_step(q[:, 0], k[:, 0], v[:, 0],
                                            k_pages, v_pages, tables, kv32,
                                            impl=impl)
            o = o[:, None]
        else:
            L.cache_insert_layer(cache, i, k, v, kv_len, cfg)
            kc, vc = L.cache_layer_arrays(cache, i, cfg, compute_dtype)
            o = L.decode_attention(q, kc, vc, valid,
                                   kv_chunk=cfg.decode_kv_chunk)
        DECODE_ROUTES[route] += 1
        x = x + _out_proj(o.to(x.dtype), p["wo"])
        x = _mlp_layer(x, p, cfg)
    return _logits(params, cfg, x[:, 0]), cache


def init_cache_shape(cfg: ModelConfig, batch: int, max_len: int, *,
                     dtype: torch.dtype = L.COMPUTE_DTYPE, device="meta"):
    """The decode cache's tensors for (batch, max_len), on ``device``
    (``meta``: shapes and dtypes only)."""
    return L.init_kv_cache(cfg, cfg.num_layers, batch, max_len,
                           cfg.num_kv_heads, dtype=dtype, device=device)
