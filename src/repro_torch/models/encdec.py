"""Encoder-decoder transformer backbone (seamless-m4t-medium) in PyTorch —
the port of ``repro.models.encdec``: init, the encoder, the train loss,
prefill and decode.

The speech frontend is a stub, as in the reference: ``frames`` arrive as
precomputed (B, S_src, d_model) embeddings.  The encoder is bidirectional;
the decoder has causal self-attention, then cross-attention over the
encoder's output.  The cross-attention K/V (``xk``/``xv``) are computed
once at prefill and kept in the cache beside the self-attention K/V.

Attention routes on a CUDA tensor (``attn_impl`` ``auto``/``cuda``; ``ref``
runs the kernels' plain versions; ``auto`` on a CPU tensor the reference's
plain code), counted in ``transformer.PREFILL_ROUTES``/``DECODE_ROUTES``:

- encoder self-attention: the flash kernel with ``causal=False``;
- decoder self-attention: flash, causal, in prefill; in decode the fused
  paged step over the decoder's (Ld, B, S, H, hd) cache, one page of S
  tokens a sequence, as the dense family's decode;
- cross-attention at decode: the attend-only paged kernel over the layer's
  ``xk``/``xv`` slice as B pages of S_src tokens, at lengths ``src_len``
  (default S_src); the kernel only reads them;
- cross-attention in prefill: the reference's plain ``bidir_attention`` on
  every route (its queries and keys differ in length, which the flash
  kernel does not take: ROADMAP.md §2).

As in the reference, prefill's cross-attention attends over all S_src
frames, and decode's masks at ``src_len``.  The train loss runs every
attention on the reference's plain code, each encoder and decoder layer
checkpointed.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import bidir_attention
from repro_torch.models.sharding import (
    ShardingCtx,
    constrain,
    linear,
    local_as,
    project,
    reshape,
)

# the encoder's and decoder's SwiGLU MLP sublayer is the dense family's
_mlp = T._mlp_layer
# the decoder layer's parameters read in fp32: its three norms
DEC_FP32 = T.NORMS + ("ln_x",)

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _attn_proj_init(cfg: ModelConfig, gen, dev, prefix: str = "") -> dict:
    hd = cfg.resolved_head_dim
    D, H = cfg.d_model, cfg.num_heads
    return {
        prefix + "wq": L.dense_init(gen, (D, H, hd), device=dev),
        prefix + "wk": L.dense_init(gen, (D, H, hd), device=dev),
        prefix + "wv": L.dense_init(gen, (D, H, hd), device=dev),
        prefix + "wo": L.dense_init(gen, (H, hd, D), in_axis_size=H * hd,
                                    device=dev),
    }


def _mlp_init(cfg: ModelConfig, gen, dev) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    return {
        "w_gate": L.dense_init(gen, (D, F), device=dev),
        "w_up": L.dense_init(gen, (D, F), device=dev),
        "w_down": L.dense_init(gen, (F, D), in_axis_size=F, device=dev),
    }


def _ones(cfg: ModelConfig, dev) -> torch.Tensor:
    return torch.ones((cfg.d_model,), dtype=torch.float32, device=dev)


def init_enc_layer(cfg: ModelConfig, gen: torch.Generator,
                   device=None) -> dict:
    dev = device if device is not None else gen.device
    p = {"ln1": _ones(cfg, dev), "ln2": _ones(cfg, dev)}
    p.update(_attn_proj_init(cfg, gen, dev))
    p.update(_mlp_init(cfg, gen, dev))
    return p


def init_dec_layer(cfg: ModelConfig, gen: torch.Generator,
                   device=None) -> dict:
    dev = device if device is not None else gen.device
    p = {"ln1": _ones(cfg, dev), "ln_x": _ones(cfg, dev),
         "ln2": _ones(cfg, dev)}
    p.update(_attn_proj_init(cfg, gen, dev))
    p.update(_attn_proj_init(cfg, gen, dev, prefix="x"))
    p.update(_mlp_init(cfg, gen, dev))
    return p


def _stack(layers: list) -> dict:
    return {k: torch.stack([p[k] for p in layers]) for k in layers[0]}


def init_encdec(cfg: ModelConfig, gen: torch.Generator, device=None) -> dict:
    """Random fp32 parameters drawn from ``gen``, on ``device`` (default
    ``gen``'s; ``meta`` gives shapes and allocates nothing); the encoder's
    and decoder's layers stacked on a leading axis each."""
    dev = device if device is not None else gen.device
    embed = L.dense_init(gen, (cfg.vocab_size, cfg.d_model),
                         in_axis_size=cfg.d_model, device=dev)
    enc = _stack([init_enc_layer(cfg, gen, dev)
                  for _ in range(cfg.encoder_layers)])
    dec = _stack([init_dec_layer(cfg, gen, dev)
                  for _ in range(cfg.decoder_layers)])
    return {
        "embed": embed,
        "encoder": enc,
        "decoder": dec,
        "enc_final_ln": _ones(cfg, dev),
        "final_ln": _ones(cfg, dev),
        "lm_head": L.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                device=dev),
    }


# ---------------------------------------------------------------------------
# attention helpers
# ---------------------------------------------------------------------------


def _proj(x, w):
    """x (B, S, D) @ w (D, H, hd) -> (B, S, H, hd)."""
    return reshape(linear(x, reshape(w, w.shape[0], -1)), *x.shape[:-1],
                   *w.shape[1:])


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def encode(params: dict, cfg: ModelConfig, frames, *,
           attn_impl: str = "auto",
           compute_dtype: torch.dtype = L.COMPUTE_DTYPE,
           shd: Optional[ShardingCtx] = None) -> torch.Tensor:
    """frames: (B, S_src, D) precomputed embeddings (the stub frontend).
    Returns the encoder's normed output (B, S_src, D)."""
    dev = params["embed"].device
    h = constrain(shd, "residual", frames.to(device=dev, dtype=compute_dtype))
    positions = T._positions(cfg, {}, *h.shape[:2], dev)
    for i in range(cfg.encoder_layers):
        p = T._layer_params(params, i, compute_dtype, key="encoder")
        h = T._attn_layer_full(h, p, cfg, positions, attn_impl=attn_impl,
                               causal=False, shd=shd)
        h = _mlp(h, p, cfg, shd)
    return L.rms_norm(h, params["enc_final_ln"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


def _dec_layer_full(x, p, cfg: ModelConfig, positions, enc_out, *,
                    attn_impl: str = "auto", return_kv: bool = False,
                    shd: Optional[ShardingCtx] = None):
    x, (k, v) = T._attn_layer_full(x, p, cfg, positions,
                                   attn_impl=attn_impl, return_kv=True,
                                   shd=shd)
    h = L.rms_norm(x, p["ln_x"], cfg.norm_eps)
    xq = _proj(h, p["xwq"])
    xk, xv = _proj(enc_out, p["xwk"]), _proj(enc_out, p["xwv"])
    if attn_impl != T.TRAIN:  # the train loss counts its layers' calls
        T.PREFILL_ROUTES["cross_plain"] += 1
    o = bidir_attention(xq, xk, xv, cfg.attn_chunk)
    x = constrain(shd, "residual", x + T._out_proj(o, p["xwo"]))
    x = _mlp(x, p, cfg, shd)
    return (x, (k, v, xk, xv)) if return_kv else x


def _train_enc_layer(x, p, cfg: ModelConfig, positions,
                     shd: Optional[ShardingCtx] = None) -> torch.Tensor:
    p = T.cast_at_use(p, x.dtype)
    x = T._attn_layer_full(x, p, cfg, positions, attn_impl=T.TRAIN,
                           causal=False, shd=shd)
    return _mlp(x, p, cfg, shd)


def _train_dec_layer(x, p, cfg: ModelConfig, positions, enc_out,
                     shd: Optional[ShardingCtx] = None):
    p = T.cast_at_use(p, x.dtype, DEC_FP32)
    return _dec_layer_full(x, p, cfg, positions, enc_out, attn_impl=T.TRAIN,
                           shd=shd)


def encdec_train_loss(params: dict, cfg: ModelConfig, batch: dict, *,
                      vocab_chunk: int = 0, attn_impl: str = "auto",
                      compute_dtype: torch.dtype = L.COMPUTE_DTYPE,
                      shd: Optional[ShardingCtx] = None) -> torch.Tensor:
    """The next-token loss of the decoder over ``tokens``/``labels`` (B, S)
    given ``frames`` (B, S_src, D): the encoder, then the decoder's layers
    with cross-attention over its output, every layer checkpointed and
    casting its weights at use, every attention the reference's plain code
    (counted once a forward: ``plain`` per encoder and decoder layer,
    ``cross_plain`` per decoder layer)."""
    T.train_attention_impl(attn_impl)
    dev = params["embed"].device
    h = constrain(shd, "residual",
                  batch["frames"].to(device=dev, dtype=compute_dtype))
    positions = T._positions(cfg, {}, *h.shape[:2], dev)
    for p in T.unstack(params["encoder"]):
        T.PREFILL_ROUTES["plain"] += 1
        h = T.checkpointed(_train_enc_layer, h, p, cfg, positions, shd)
    enc_out = L.rms_norm(h, params["enc_final_ln"], cfg.norm_eps)
    tokens = batch["tokens"]
    h = constrain(shd, "residual", T.embed(params, tokens, compute_dtype))
    positions = T._positions(cfg, batch, *tokens.shape, dev)
    for p in T.unstack(params["decoder"]):
        T.PREFILL_ROUTES["plain"] += 1
        T.PREFILL_ROUTES["cross_plain"] += 1
        h = T.checkpointed(_train_dec_layer, h, p, cfg, positions, enc_out,
                           shd)
    h = L.rms_norm(h, params["final_ln"], cfg.norm_eps)
    return T.cross_entropy(h, params["lm_head"], batch["labels"],
                           vocab_chunk, shd)


def encdec_prefill(params: dict, cfg: ModelConfig, batch: dict, *,
                   max_len=None, attn_impl: str = "auto",
                   compute_dtype: torch.dtype = L.COMPUTE_DTYPE,
                   shd: Optional[ShardingCtx] = None):
    """Encode ``frames``, then prefill the decoder over ``tokens`` (B, S)
    (``prompt_lens`` (B,) optional, default S).  Returns (last-prompt
    logits (B, V), cache, prompt_lens): the cache holds the decoder's
    self-attention ``k``/``v`` (Ld, B, max_len, H, hd), padded for decode
    growth, and the cross-attention ``xk``/``xv`` (Ld, B, S_src, H, hd)."""
    enc_out = encode(params, cfg, batch["frames"], attn_impl=attn_impl,
                     compute_dtype=compute_dtype, shd=shd)
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = params["embed"].device
    h = constrain(shd, "residual", T.embed(params, tokens, compute_dtype))
    positions = T._positions(cfg, batch, B, S, dev)
    prompt_lens = batch.get("prompt_lens")
    if prompt_lens is None:
        prompt_lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    cache = None
    for i in range(cfg.decoder_layers):
        p = T._layer_params(params, i, compute_dtype, key="decoder",
                            fp32=DEC_FP32)
        h, (k, v, xk, xv) = _dec_layer_full(h, p, cfg, positions, enc_out,
                                            attn_impl=attn_impl,
                                            return_kv=True, shd=shd)
        layer = L.finalize_prefill_cache(k, v, cfg, max_len)
        layer["xk"], layer["xv"] = xk.to(compute_dtype), xv.to(compute_dtype)
        cache = T._cache_layer(cache, i, cfg.decoder_layers, layer)
    return (T._last_logits(params, cfg, h, prompt_lens, shd),
            T.stack_cache(cache), prompt_lens)


def _cross_decode(xq, xk, xv, src_len, route: str):
    """One-token cross-attention of xq (B, 1, H, hd) over a layer's
    xk/xv (B, S_src, H, hd) at lengths ``src_len`` (B,) int32: B pages of
    S_src tokens for the attend-only kernel (``cross_paged``) or its plain
    version (``cross_paged_ref``), else ``layers.decode_attention``."""
    T.DECODE_ROUTES[route] += 1
    if route == "cross_plain":
        return L.decode_attention(xq, xk, xv, src_len)
    dt = isinstance(xq, DTensor)
    if dt:  # on each device's rows and heads (``transformer.head_shards``)
        pl, mesh, (xq,) = T.head_shards(xq)
        if tuple(xk.placements) != tuple(pl):
            raise NotImplementedError(
                f"the cross-attention kernel route needs the source cache "
                f"placed as the query ({xk.placements} against {pl})")
        xk, xv = xk.to_local(), xv.to_local()
        src_len = local_as(src_len, project(pl, {0: 0}), mesh)
    tables = torch.arange(xq.shape[0], dtype=torch.int32,
                          device=xq.device)[:, None]
    impl = "cuda" if route == "cross_paged" else "ref"
    o = paged_attention(xq[:, 0], xk, xv, tables, src_len,
                        impl=impl)[:, None]
    return DTensor.from_local(o, mesh, pl, run_check=False) if dt else o


def encdec_decode_step(params: dict, cfg: ModelConfig, cache: dict,
                       batch: dict, *, attn_impl: str = "auto",
                       compute_dtype: torch.dtype = L.COMPUTE_DTYPE,
                       shd: Optional[ShardingCtx] = None):
    """batch: ``tokens`` (B, 1), ``kv_len`` (B,), optionally ``src_len``
    (B,) (default S_src).  Returns (logits (B, V), cache): ``k``/``v``
    updated in place with one token write per layer (a write past their
    end dropped), ``xk``/``xv`` only read."""
    tokens, kv_len = batch["tokens"], batch["kv_len"]
    B = tokens.shape[0]
    dev = params["embed"].device
    x = T.embed(params, tokens, compute_dtype)
    positions = T._positions(cfg, batch, B, 1, dev, offset=kv_len)
    self_cache = {n: t for n, t in cache.items() if n not in ("xk", "xv")}
    attn = T.DecodeAttention.plan(cfg, x, attn_impl, self_cache, kv_len)
    cross = T.decode_route(cfg, x, attn_impl, cross=True)
    S_src = cache["xk"].shape[2]
    src_len = batch.get("src_len")
    src_len = (torch.full((B,), S_src, dtype=torch.int32, device=dev)
               if src_len is None else
               torch.clamp(src_len.to(dev), max=S_src).to(torch.int32))
    for i in range(cfg.decoder_layers):
        p = T._layer_params(params, i, compute_dtype, key="decoder",
                            fp32=DEC_FP32)
        x = T._attn_layer_decode(x, p, cfg, positions, self_cache, i, attn,
                                 compute_dtype, shd)
        xq = _proj(L.rms_norm(x, p["ln_x"], cfg.norm_eps), p["xwq"])
        o = _cross_decode(xq, cache["xk"][i], cache["xv"][i], src_len, cross)
        x = _mlp(x + T._out_proj(o.to(x.dtype), p["xwo"]), p, cfg, shd)
    return T._logits(params, cfg, x[:, 0], shd), cache
