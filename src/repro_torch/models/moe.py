"""Mixture-of-Experts decoder (mixtral-8x22b, dbrx-132b) in PyTorch — the
port of ``repro.models.moe``: init, the train loss, prefill and decode.

Layers are the dense family's with the SwiGLU MLP replaced by E experts:
``router (D, E)``, ``e_gate``/``e_up (E, D, F)``, ``e_down (E, F, D)``,
stacked on a leading layer axis.  The router runs on fp32 logits; each
token takes its top-k experts, weighted by a softmax over the k selected.
Three routes compute the experts, as in the reference:

- the dense expert scan (the default): every expert on every token,
  ``acc += w_e * y_e`` in fp32, in expert order;
- ``moe_impl="dispatch"``: capacity slots (``models.moe_dispatch``);
- ``moe_decode_gather`` at one token a sequence: only the top-k experts'
  weights are read, one product per selected expert over the rows that
  chose it (the same function as the reference's ``(B, k, D, F)`` gather,
  which would be 2.1 GB per weight in bf16 at dbrx's width).

In training, the router's gradient reaches it through the combine weights
(the softmax over the k selected logits), as in the reference; the top-k
choice itself is not differentiated.

The expert products are ``torch.matmul``: the reference computes them in
``jnp`` outside any Pallas kernel.  Attention, the KV cache and their
routes are the dense family's as they are (``models.transformer``): flash
in prefill (with the sliding window, at any prompt length), the paged
kernel in decode (a sliding window's ring buffer too).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.moe_dispatch import moe_dispatch_mlp
from repro_torch.models.sharding import ShardingCtx, constrain, linear

# the routing of ``_moe_mlp``'s calls while a list is set here (None: not
# recorded), one dict per call in call order: ``margin`` (B, S), the gap
# between the k-th and (k+1)-th router logits (inf with k = E), and
# ``experts`` (B, S, k), the selected experts in ascending order.  A
# diagnostic for comparing two runs, whose tokens may take another expert
# where the gap is within their rounding.
margin_log: Optional[list] = None

# the layer parameters read in fp32: the norms and the router (the
# reference routes on fp32 logits)
FP32_PARAMS = T.NORMS + ("router",)

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _layer_shapes(cfg: ModelConfig) -> dict:
    """name -> (shape, fan-in) of one layer's drawn weights, in the draw
    order of the reference's ``init_moe_layer``."""
    hd = cfg.resolved_head_dim
    D, F, H, KVH, E = (cfg.d_model, cfg.d_ff, cfg.num_heads,
                       cfg.num_kv_heads, cfg.num_experts)
    return {
        "wq": ((D, H, hd), D),
        "wk": ((D, KVH, hd), D),
        "wv": ((D, KVH, hd), D),
        "wo": ((H, hd, D), H * hd),
        "router": ((D, E), D),
        "e_gate": ((E, D, F), D),
        "e_up": ((E, D, F), D),
        "e_down": ((E, F, D), F),
    }


def _norms_and_biases(cfg: ModelConfig, lead: tuple, dev) -> dict:
    hd, H, KVH = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    p = {"ln1": torch.ones(lead + (cfg.d_model,), device=dev),
         "ln2": torch.ones(lead + (cfg.d_model,), device=dev)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(lead + (H, hd), device=dev)
        p["bk"] = torch.zeros(lead + (KVH, hd), device=dev)
        p["bv"] = torch.zeros(lead + (KVH, hd), device=dev)
    return p


def init_moe_layer(cfg: ModelConfig, gen: torch.Generator,
                   device=None) -> dict:
    dev = device if device is not None else gen.device
    p = _norms_and_biases(cfg, (), dev)
    for name, (shape, fan_in) in _layer_shapes(cfg).items():
        p[name] = L.dense_init(gen, shape, in_axis_size=fan_in, device=dev)
    return p


def init_moe(cfg: ModelConfig, gen: torch.Generator, device=None) -> dict:
    """Random fp32 parameters drawn from ``gen``, on ``device`` (default
    ``gen``'s; ``meta`` gives shapes and allocates nothing).  The stacked
    (L, ...) tensors are allocated once and filled layer by layer, in
    ``init_moe_layer``'s draw order: at dbrx's width a layer's experts are
    12.7 GB in fp32, so per-layer tensors stacked afterwards would hold
    them twice."""
    dev = device if device is not None else gen.device
    n = cfg.num_layers
    embed = L.dense_init(gen, (cfg.vocab_size, cfg.d_model),
                         in_axis_size=cfg.d_model, device=dev)
    shapes = _layer_shapes(cfg)
    layers = _norms_and_biases(cfg, (n,), dev)
    layers.update({name: torch.empty((n,) + shape, device=dev)
                   for name, (shape, _) in shapes.items()})
    if torch.device(dev).type != "meta":
        for i in range(n):
            for name, (_, fan_in) in shapes.items():
                L.dense_fill(gen, layers[name][i], fan_in)
    return {
        "embed": embed,
        "layers": layers,
        "final_ln": torch.ones((cfg.d_model,), device=dev),
        "lm_head": L.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                device=dev),
    }


# ---------------------------------------------------------------------------
# routing and the expert routes
# ---------------------------------------------------------------------------


def _router_logits(h, router) -> torch.Tensor:
    return linear(h.float(), router.float())


def _log_routing(logits: torch.Tensor, k: int) -> None:
    top, idx = torch.topk(logits, min(k + 1, logits.shape[-1]), dim=-1)
    margin = (top[..., k - 1] - top[..., k] if top.shape[-1] > k
              else torch.full(top.shape[:-1], math.inf, device=top.device))
    margin_log.append({"margin": margin,
                       "experts": idx[..., :k].sort(dim=-1).values})


def router_weights(h, router, cfg: ModelConfig) -> torch.Tensor:
    """Top-k routing -> per-expert combine weights (B, S, E) fp32: a
    softmax over the k selected logits, zero elsewhere."""
    logits = _router_logits(h, router)
    if margin_log is not None:
        _log_routing(logits, cfg.num_experts_per_tok)
    top, idx = torch.topk(logits, cfg.num_experts_per_tok, dim=-1)
    return torch.zeros_like(logits).scatter(-1, idx,
                                            torch.softmax(top, dim=-1))


def _expert(h, wg, wu, wd, shd: Optional[ShardingCtx] = None):
    """One expert's SwiGLU on h (..., D) in h's dtype; ``shd`` places its
    (B, S, F) hidden as the reference's scan does."""
    g = torch.nn.functional.silu(linear(h, wg.to(h.dtype)))
    return linear(constrain(shd, "ffn", g * linear(h, wu.to(h.dtype))),
                  wd.to(h.dtype))


def _decode_gather(h, p, cfg: ModelConfig) -> torch.Tensor:
    """h (B, 1, D): the top-k experts of each row, weighted by the softmax
    over their logits.  Each selected expert runs once, over the rows that
    chose it (the host reads the (B, k) choice once a layer); the (B, k, D)
    outputs are combined in h's dtype, as the reference's gather does.
    Returns (B, 1, D)."""
    logits = _router_logits(h, p["router"])[:, 0]
    if margin_log is not None:
        _log_routing(logits[:, None], cfg.num_experts_per_tok)
    top, idx = torch.topk(logits, cfg.num_experts_per_tok, dim=-1)
    w = torch.softmax(top, dim=-1)
    hh = h[:, 0]
    y = hh.new_empty(idx.shape + (hh.shape[-1],))  # (B, k, D)
    chosen = idx.cpu()
    for e in chosen.unique().tolist():
        rows, slots = (chosen == e).nonzero(as_tuple=True)
        rows, slots = rows.to(h.device), slots.to(h.device)
        y[rows, slots] = _expert(hh[rows], p["e_gate"][e], p["e_up"][e],
                                 p["e_down"][e])
    return torch.einsum("bk,bkd->bd", w.to(y.dtype), y)[:, None]


def _moe_mlp(x, p, cfg: ModelConfig,
             shd: Optional[ShardingCtx] = None) -> torch.Tensor:
    """The MoE feed-forward sublayer with its residual; the route follows
    the config (module docstring)."""
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe_decode_gather and h.shape[1] == 1:
        return constrain(shd, "residual", x + _decode_gather(h, p, cfg))
    combine = router_weights(h, p["router"], cfg)  # (B, S, E)
    if cfg.moe_impl == "dispatch":
        out = moe_dispatch_mlp(h, combine, p, cfg)
        return constrain(shd, "residual", x + out.to(x.dtype))
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    experts = zip(*(p[w].unbind(0) for w in ("e_gate", "e_up", "e_down")))
    # the reference's scan, in its order (``unbind``: under autograd one
    # gradient of the stacked experts, not one per expert read)
    for e, (wg, wu, wd) in enumerate(experts):
        y = _expert(h, wg, wu, wd, shd)
        acc = acc + combine[..., e, None] * y.float()
    return constrain(shd, "residual", x + acc.to(x.dtype))


def _moe_layer_fwd(x, p, cfg: ModelConfig, positions,
                   attn_impl: str = "auto",
                   shd: Optional[ShardingCtx] = None) -> torch.Tensor:
    x = T._attn_layer_full(x, p, cfg, positions, attn_impl=attn_impl,
                           shd=shd)
    return _moe_mlp(x, p, cfg, shd)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def moe_train_loss(params: dict, cfg: ModelConfig, batch: dict, *,
                   vocab_chunk: int = 0, attn_impl: str = "auto",
                   compute_dtype: torch.dtype = L.COMPUTE_DTYPE,
                   shd: Optional[ShardingCtx] = None) -> torch.Tensor:
    """The next-token loss, as ``transformer.dense_train_loss`` computes
    it (checkpointed layers, the reference's plain attention), with the
    experts in place of the MLP on the config's route (the dense expert
    scan or capacity dispatch)."""
    return T.decoder_train_loss(params, cfg, batch, _moe_mlp,
                                vocab_chunk=vocab_chunk, attn_impl=attn_impl,
                                compute_dtype=compute_dtype,
                                fp32=FP32_PARAMS, shd=shd)


def moe_prefill(params: dict, cfg: ModelConfig, batch: dict, *,
                max_len=None, attn_impl: str = "auto",
                compute_dtype: torch.dtype = L.COMPUTE_DTYPE,
                shd: Optional[ShardingCtx] = None):
    """Returns (last-prompt-position logits (B, V), cache, prompt_lens
    (B,)), as ``transformer.dense_prefill`` does, with the experts in place
    of the MLP."""
    return T.decoder_prefill(params, cfg, batch, _moe_mlp, max_len=max_len,
                             attn_impl=attn_impl, compute_dtype=compute_dtype,
                             fp32=FP32_PARAMS, shd=shd)


def moe_decode_step(params: dict, cfg: ModelConfig, cache: dict,
                    batch: dict, *, attn_impl: str = "auto",
                    compute_dtype: torch.dtype = L.COMPUTE_DTYPE,
                    shd: Optional[ShardingCtx] = None):
    """batch: ``tokens`` (B, 1), ``kv_len`` (B,).  Returns (logits (B, V),
    cache), the cache updated in place, as ``transformer.dense_decode_step``
    does."""
    return T.decoder_decode_step(params, cfg, cache, batch, _moe_mlp,
                                 attn_impl=attn_impl,
                                 compute_dtype=compute_dtype,
                                 fp32=FP32_PARAMS, shd=shd)
