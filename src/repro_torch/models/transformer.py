"""Dense decoder-only transformer (llama/qwen family, with qwen2-vl's
M-RoPE backbone) in PyTorch — the port of ``repro.models.transformer``:
init, the train loss, prefill and decode.

Parameters are dicts of fp32 tensors in the reference's layouts:
``wq (D,H,hd)``, ``wk``/``wv (D,KVH,hd)``, ``wo (H,hd,D)``,
``w_gate``/``w_up (D,F)``, ``w_down (F,D)``, ``embed (V,D)``,
``lm_head (D,V)``, ``bq``/``bk``/``bv`` with ``qkv_bias``; ``init_dense``
stacks the layers on a leading axis.  Serving casts weights to the compute
dtype once per tensor (``layers.cast_once``), not at every use; the train
loss casts at each use, inside each checkpointed layer.

Attention goes through the port's kernels on a CUDA tensor (``attn_impl``
``auto`` or ``cuda``): prefill through the flash-attention kernel, decode
over the stacked bf16/fp32 cache through the paged-attention kernel, each
layer's ``(B, S, KVH, hd)`` cache slice seen as a pool of one S-token page
per sequence (one launch per layer: the token's K/V write and the
attention).  ``ref`` runs the kernels' plain versions on any device;
``auto`` on a CPU tensor runs the reference's plain code.  An int8 cache
takes the reference's plain decode route whatever ``attn_impl`` says: the
reference has no kernel for it.  A sliding window's prefill runs flash
with the window (row i keeps keys i - W < j <= i, as the reference's
``causal_attention(window=W)``), at any prompt length; its
decode runs the paged kernel over the ring buffer's slots (the cache holds
at most the window, and the reference's decode attends over all of its
``min(kv_len + 1, S)`` written slots, in whatever order the ring left
them).  A shape the kernels do not take raises ``NotImplementedError``
under ``auto``/``cuda``.

The train loss runs the reference's own plain attention on every device
(``train_attention_impl``): neither the Pallas kernel nor the port's flash
kernel has a backward.

The MoE family (``models.moe``) and the encoder-decoder's decoder
(``models.encdec``) reuse these attention pieces and routes as they are.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

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
from repro_torch.models.sharding import (
    ShardingCtx,
    constrain,
    head_shards,
    linear,
    local_as,
    project,
    replicate_partial,
    reshape,
)

ATTN_IMPLS = ("auto", "ref", "cuda")

# decode attention calls by route since the counts were last set to 0, one
# per layer: ``paged`` (the kernel), ``paged_ref`` (its plain version),
# ``int8`` (the reference's plain route an int8 cache picks), ``plain`` (the
# reference's plain code: ``auto`` on a CPU tensor); and the
# encoder-decoder's cross-attention: ``cross_paged`` (the attend-only
# kernel), ``cross_paged_ref``, ``cross_plain``
DECODE_ROUTES = {"paged": 0, "paged_ref": 0, "int8": 0, "plain": 0,
                 "cross_paged": 0, "cross_paged_ref": 0, "cross_plain": 0}
# prefill attention calls by route, likewise: ``flash`` (the kernel),
# ``flash_ref`` (its plain version), ``plain`` (the reference's plain code);
# ``cross_plain``: the encoder-decoder's cross-attention (queries and keys
# of different lengths, which no kernel takes: plain on every route).  The
# train loss counts each layer's attention once a forward, in ``plain``
# and ``cross_plain``: a checkpointed layer's recompute in backward is not
# counted again
PREFILL_ROUTES = {"flash": 0, "flash_ref": 0, "plain": 0, "cross_plain": 0}
# ``attn_impl`` inside the train loss's layers: the reference's plain
# attention, not counted here (the loss counts it once a forward)
TRAIN = "train"

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


def _mlp_layer(x: torch.Tensor, p: dict, cfg: ModelConfig,
               shd: Optional[ShardingCtx] = None) -> torch.Tensor:
    """SwiGLU MLP sublayer with its residual: x + W_down(silu(W_g h) * W_u h),
    h = rms_norm(x).  Weights are cast to the activation dtype at use (a
    no-op when the caller hands in weights already cast)."""
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    g = torch.nn.functional.silu(linear(h, p["w_gate"].to(h.dtype)))
    u = linear(h, p["w_up"].to(h.dtype))
    o = linear(constrain(shd, "ffn", g * u), p["w_down"].to(h.dtype))
    return constrain(shd, "residual", x + o)


def _dense_layer_fwd(x, p, cfg: ModelConfig, positions,
                     attn_impl: str = "auto",
                     shd: Optional[ShardingCtx] = None) -> torch.Tensor:
    x = _attn_layer_full(x, p, cfg, positions, attn_impl=attn_impl, shd=shd)
    return _mlp_layer(x, p, cfg, shd)


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


def prefill_route(cfg: ModelConfig, q, attn_impl: str) -> str:
    """The prefill attention route for q (B, S, H, hd): a key of
    ``PREFILL_ROUTES``.  Flash takes a sliding window at any S; at a head
    dim the kernel lacks, the ``cuda`` route raises before any launch."""
    impl = _kernel_impl(q, attn_impl)
    if impl is None:
        return "plain"
    hd = q.shape[-1]
    if impl == "cuda" and hd not in fa_kernel.HEAD_DIMS:
        raise NotImplementedError(
            f"the flash-attention kernel has no head dim {hd} (it takes "
            f"{fa_kernel.HEAD_DIMS})")
    return "flash" if impl == "cuda" else "flash_ref"


def prefill_attention(q, k, v, cfg: ModelConfig, attn_impl: str, *,
                      causal: bool = True,
                      shd: Optional[ShardingCtx] = None):
    """Prefill self-attention over (B, S, H, hd) tensors: the flash kernel
    (``cuda``) or its plain version (``ref``) on transposed views, or the
    reference's query-chunked plain code (``auto`` on a CPU or ``meta``
    tensor, and ``TRAIN`` on any device): ``layers.causal_attention``, or
    ``layers.bidir_attention`` for the encoder's non-causal attention.
    DTensors go through a kernel route on each device's shard
    (``head_shards``) and come back as a DTensor of q's placements."""
    if attn_impl == TRAIN:  # the train loss counts its layers' calls
        route = "plain"
    else:
        route = prefill_route(cfg, q, attn_impl)
        PREFILL_ROUTES[route] += 1
    if route == "plain":
        if not causal:
            return L.bidir_attention(q, k, v, cfg.attn_chunk)
        return L.causal_attention(q, k, v, chunk=cfg.attn_chunk,
                                  window=cfg.sliding_window, shd=shd)
    dt = isinstance(q, DTensor)
    if dt:
        pl, mesh, (q, k, v) = head_shards(q, k, v)
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal,
                        window=cfg.sliding_window if causal else 0,
                        impl="cuda" if route == "flash" else "ref")
    o = o.transpose(1, 2)
    if dt:
        return DTensor.from_local(o, mesh, pl, run_check=False)
    return o


def decode_route(cfg: ModelConfig, x, attn_impl: str, *,
                 cross: bool = False) -> str:
    """The decode attention route, a key of ``DECODE_ROUTES``: an int8 cache
    runs the reference's plain route; otherwise ``attn_impl`` picks the
    paged kernel, its plain version or the reference's plain code, raising
    under ``cuda`` where the kernel does not take the config's heads.
    ``cross``: the encoder-decoder's cross-attention over its source cache
    (attend only; the ``cross_`` routes)."""
    if cfg.kv_cache_dtype == "int8" and not cross:
        return "int8"
    impl = _kernel_impl(x, attn_impl)
    hd, G = cfg.resolved_head_dim, cfg.num_heads // cfg.num_kv_heads
    if impl == "cuda" and (hd not in pa_kernel.HEAD_DIMS
                           or G > pa_kernel.MAX_GROUP):
        raise NotImplementedError(
            f"the paged-attention kernel has no head dim {hd} with "
            f"{G} query heads per KV head (it takes {pa_kernel.HEAD_DIMS}, "
            f"at most {pa_kernel.MAX_GROUP})")
    route = {None: "plain", "cuda": "paged", "ref": "paged_ref"}[impl]
    return "cross_" + route if cross else route


# ---------------------------------------------------------------------------
# shared pieces of the entry points
# ---------------------------------------------------------------------------


# the layer parameters read in fp32 whatever the compute dtype: the norm
# scales (a family adds its own: the MoE router, the cross-attention norm)
NORMS = ("ln1", "ln2")


def _layer_params(params: dict, i: int, dtype: torch.dtype,
                  key: str = "layers", fp32: tuple = NORMS) -> dict:
    """Layer ``i`` of the stack ``params[key]`` for ``dtype`` compute:
    weights from one cast of each stacked tensor, the ``fp32`` keys as they
    are."""
    return {k: v[i] if k in fp32 else cast_once(v, dtype)[i]
            for k, v in params[key].items()}


def embed(params: dict, tokens, dtype: torch.dtype) -> torch.Tensor:
    """The rows of ``embed`` for ``tokens``, in ``dtype`` (an embedding
    lookup: on a vocab-split DTensor, a masked partial sum, reduced
    here)."""
    return replicate_partial(torch.nn.functional.embedding(
        tokens.long(), params["embed"])).to(dtype)


def _embed_tokens(params: dict, cfg: ModelConfig, batch: dict,
                  dtype: torch.dtype,
                  shd: Optional[ShardingCtx] = None) -> torch.Tensor:
    h = embed(params, batch["tokens"], dtype)
    if cfg.num_visual_tokens and "visual_embeds" in batch:
        vis = batch["visual_embeds"].to(device=h.device, dtype=dtype)
        # after BOS; the start clamps as dynamic_update_slice's does
        start = max(0, min(1, h.shape[1] - vis.shape[1]))
        h = torch.cat([h[:, :start], vis, h[:, start + vis.shape[1]:]],
                      dim=1)
    return constrain(shd, "residual", h)


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


def _qkv(x, p, cfg: ModelConfig, shd: Optional[ShardingCtx] = None):
    B, S, D = x.shape
    q, k, v = (reshape(linear(x, reshape(p[w], D, -1)), B, S, -1,
                       cfg.resolved_head_dim)
               for w in ("wq", "wk", "wv"))
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return constrain(shd, "heads", q), k, v


def _out_proj(o, wo):
    """o (B, S, H, hd) @ wo (H, hd, D) -> (B, S, D)."""
    return linear(reshape(o, *o.shape[:-2], -1), reshape(wo, -1, wo.shape[-1]))


def _attn_layer_full(x, p, cfg: ModelConfig, positions, *,
                     attn_impl: str = "auto", return_kv: bool = False,
                     causal: bool = True,
                     shd: Optional[ShardingCtx] = None):
    """Full-sequence self-attention sublayer with its residual (prefill;
    ``causal=False``: the encoder-decoder's encoder, whose reference
    places no attention output)."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(h, p, cfg, shd)
    q = L.apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = L.apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    o = prefill_attention(q, k, v, cfg, attn_impl, causal=causal, shd=shd)
    if causal:
        o = constrain(shd, "heads", o)
    x = constrain(shd, "residual", x + _out_proj(o, p["wo"]))
    if return_kv:
        return x, (k, v)
    return x


def _logits(params: dict, cfg: ModelConfig, h: torch.Tensor,
            shd: Optional[ShardingCtx] = None) -> torch.Tensor:
    h = L.rms_norm(h, params["final_ln"], cfg.norm_eps)
    return constrain(shd, "logits",
                     linear(h, cast_once(params["lm_head"], h.dtype)))


# ---------------------------------------------------------------------------
# the train loss
# ---------------------------------------------------------------------------


def train_attention_impl(attn_impl: str) -> None:
    """Refuse an ``attn_impl`` the train loss cannot take.  Its attention
    is the reference's plain code on every device (``auto``): neither the
    Pallas kernel nor the port's flash kernel has a backward, and nothing
    falls back quietly from a kernel route."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r}; one of {ATTN_IMPLS}")
    if attn_impl != "auto":
        raise NotImplementedError(
            f"train_loss with attn_impl={attn_impl!r}: the train loss runs "
            "the reference's plain attention (attn_impl='auto'); the "
            "flash-attention kernel has no backward")


def unstack(stacked: dict) -> list:
    """The layers of a stacked ``(L, ...)`` parameter dict as L dicts of
    views, from one ``unbind`` per leaf.  Under autograd, reading layer i
    as ``v[i]`` would give each layer's backward a zero gradient the size
    of the whole stack; ``unbind``'s backward stacks the L gradients
    once."""
    parts = {k: v.unbind(0) for k, v in stacked.items()}
    n = len(next(iter(parts.values())))
    return [{k: t[i] for k, t in parts.items()} for i in range(n)]


def cast_at_use(p: dict, dtype: torch.dtype, fp32: tuple = NORMS) -> dict:
    """One layer's parameters for ``dtype`` compute, cast here, as the
    reference's ``astype`` does at each use; the ``fp32`` keys as they
    are.  Inside a checkpointed layer no cast outlives its forward."""
    return {k: v if k in fp32 else v.to(dtype) for k, v in p.items()}


def checkpointed(fn: Callable, *args):
    """``fn(*args)`` with its activations recomputed in backward instead
    of kept (``jax.checkpoint``)."""
    return checkpoint(fn, *args, use_reentrant=False)


def _train_layer(x, p, cfg: ModelConfig, positions, mlp: Callable,
                 fp32: tuple, shd: Optional[ShardingCtx] = None
                 ) -> torch.Tensor:
    p = cast_at_use(p, x.dtype, fp32)
    x = _attn_layer_full(x, p, cfg, positions, attn_impl=TRAIN, shd=shd)
    return mlp(x, p, cfg, shd)


def cross_entropy(h, lm_head, labels, vocab_chunk: int = 0,
                  shd: Optional[ShardingCtx] = None) -> torch.Tensor:
    """The mean next-token loss from fp32 logits.  h: (B, S, D) after the
    final norm; labels: (B, S), -1 masked; divided by max(#unmasked, 1).

    ``vocab_chunk`` > 0 dividing V: a streaming logsumexp over vocab
    chunks that never holds the (B, S, V) fp32 logits at once (the
    reference's ``lax.scan``, here a loop over the chunks)."""
    labels = labels.to(h.device).long()
    mask = (labels >= 0).float()
    safe = torch.clamp(labels, min=0)
    V = lm_head.shape[-1]
    w = lm_head.to(h.dtype)
    if not vocab_chunk or V % vocab_chunk:
        logits = constrain(shd, "logits", linear(h, w)).float()
        lse = torch.logsumexp(logits, dim=-1)
        # a gather over a vocab-sharded DTensor is a masked partial sum:
        # reduced while it still has the index's shape
        ll = replicate_partial(logits.gather(-1, safe[..., None]))[..., 0]
    else:
        c = vocab_chunk
        m = torch.full(labels.shape, L.NEG_INF, dtype=torch.float32,
                       device=h.device)
        s = torch.zeros(labels.shape, dtype=torch.float32, device=h.device)
        gold = torch.zeros_like(s)
        for i in range(V // c):
            lg = linear(h, w[:, i * c:(i + 1) * c]).float()
            nm = torch.maximum(m, lg.amax(dim=-1))
            s = s * torch.exp(m - nm) + torch.exp(lg - nm[..., None]).sum(-1)
            loc = safe - i * c
            hit = (loc >= 0) & (loc < c)
            g = replicate_partial(
                lg.gather(-1, torch.clamp(loc, 0, c - 1)[..., None]))[..., 0]
            gold = torch.where(hit, g, gold)
            m = nm
        lse, ll = m + torch.log(s), gold
    nll = (lse - ll) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def decoder_train_loss(params: dict, cfg: ModelConfig, batch: dict,
                       mlp: Callable, *, vocab_chunk: int = 0,
                       attn_impl: str = "auto",
                       compute_dtype: torch.dtype = L.COMPUTE_DTYPE,
                       fp32: tuple = NORMS,
                       shd: Optional[ShardingCtx] = None) -> torch.Tensor:
    """The decoder-only train loss with the feed-forward sublayer ``mlp``
    and the ``fp32`` layer parameters as in ``decoder_prefill``; see
    ``dense_train_loss``."""
    train_attention_impl(attn_impl)
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = params["embed"].device
    h = _embed_tokens(params, cfg, batch, compute_dtype, shd)
    positions = _positions(cfg, batch, B, S, dev)
    for p in unstack(params["layers"]):
        PREFILL_ROUTES["plain"] += 1
        h = checkpointed(_train_layer, h, p, cfg, positions, mlp, fp32, shd)
    h = L.rms_norm(h, params["final_ln"], cfg.norm_eps)
    return cross_entropy(h, params["lm_head"], batch["labels"], vocab_chunk,
                         shd)


def dense_train_loss(params: dict, cfg: ModelConfig, batch: dict, *,
                     vocab_chunk: int = 0, attn_impl: str = "auto",
                     compute_dtype: torch.dtype = L.COMPUTE_DTYPE,
                     shd: Optional[ShardingCtx] = None) -> torch.Tensor:
    """The next-token loss (0-d fp32) of ``tokens`` (B, S) against
    ``labels`` (B, S) (-1 masked); qwen2-vl's ``visual_embeds`` and
    ``mrope_positions`` as in prefill.  Each layer is checkpointed (its
    activations recomputed in backward, as ``jax.checkpoint`` does in the
    reference) and casts its weights at use; attention is the reference's
    plain code (``train_attention_impl``)."""
    return decoder_train_loss(params, cfg, batch, _mlp_layer,
                              vocab_chunk=vocab_chunk, attn_impl=attn_impl,
                              compute_dtype=compute_dtype, shd=shd)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def decoder_prefill(params: dict, cfg: ModelConfig, batch: dict,
                    mlp: Callable, *, max_len=None, attn_impl: str = "auto",
                    compute_dtype: torch.dtype = L.COMPUTE_DTYPE,
                    fp32: tuple = NORMS, shd: Optional[ShardingCtx] = None):
    """The decoder-only prefill with the feed-forward sublayer ``mlp(x, p,
    cfg)`` (``_mlp_layer``, or the MoE's ``_moe_mlp``) and the layer
    parameters ``fp32`` kept in fp32; see ``dense_prefill``."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = params["embed"].device
    h = _embed_tokens(params, cfg, batch, compute_dtype, shd)
    positions = _positions(cfg, batch, B, S, dev)
    prompt_lens = batch.get("prompt_lens")
    if prompt_lens is None:
        prompt_lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    cache = None
    for i in range(cfg.num_layers):
        p = _layer_params(params, i, compute_dtype, fp32=fp32)
        h, (k, v) = _attn_layer_full(h, p, cfg, positions,
                                     attn_impl=attn_impl, return_kv=True,
                                     shd=shd)
        h = mlp(h, p, cfg, shd)
        cache = _cache_layer(cache, i, cfg.num_layers,
                             L.finalize_prefill_cache(k, v, cfg, max_len))
    return (_last_logits(params, cfg, h, prompt_lens, shd), stack_cache(cache),
            prompt_lens)


def _cache_layer(cache: Optional[dict], i: int, n: int, layer: dict) -> dict:
    """Store one layer's cache entries at ``i`` of a stacked (n, ...) cache,
    allocated at the first layer; DTensor entries are kept in a list for
    ``stack_cache``."""
    if any(isinstance(t, DTensor) for t in layer.values()):
        cache = cache if cache is not None else {k: [] for k in layer}
        for k, t in layer.items():
            cache[k].append(t)
        return cache
    if cache is None:
        cache = {k: torch.empty((n,) + t.shape, dtype=t.dtype,
                                device=t.device) for k, t in layer.items()}
    for k, t in layer.items():
        cache[k][i] = t
    return cache


def stack_cache(cache: dict) -> dict:
    """A cache ``_cache_layer`` built: the stacked dict, with its DTensor
    entries' layer lists stacked."""
    return {k: torch.stack(t) if isinstance(t, list) else t
            for k, t in cache.items()}


def _last_logits(params: dict, cfg: ModelConfig, h, prompt_lens,
                 shd: Optional[ShardingCtx] = None):
    """Logits at the last prompt position of each sequence of h (B, S, D)
    (a gather along S: DTensor propagates its placements)."""
    S, D = h.shape[1], h.shape[2]
    idx = torch.clamp(prompt_lens.to(h.device).long() - 1, 0, S - 1)
    last = torch.gather(h, 1, idx[:, None, None].expand(-1, 1, D))[:, 0]
    return _logits(params, cfg, last, shd)


def dense_prefill(params: dict, cfg: ModelConfig, batch: dict, *,
                  max_len=None, attn_impl: str = "auto",
                  compute_dtype: torch.dtype = L.COMPUTE_DTYPE,
                  shd: Optional[ShardingCtx] = None):
    """Returns (last-prompt-position logits (B, V), cache, prompt_lens (B,)).

    batch: ``tokens`` (B, S), optionally ``prompt_lens`` (B,) (default S),
    ``visual_embeds`` and ``mrope_positions`` (qwen2-vl).  ``max_len``
    over-allocates the cache for decode growth; the cache is the stacked
    ``(L, B, max_len, KVH, hd)`` dict of ``layers.init_kv_cache``.
    """
    return decoder_prefill(params, cfg, batch, _mlp_layer, max_len=max_len,
                           attn_impl=attn_impl, compute_dtype=compute_dtype,
                           shd=shd)


@dataclasses.dataclass
class DecodeAttention:
    """One decode step's self-attention over a stacked (L, B, S, KVH, hd)
    cache, fixed before its first layer: the route (``decode_route``), the
    lengths and, on the paged routes, the one-page-per-sequence tables and
    whether some row has run out of cache.

    A write at ``kv_len >= S`` is dropped and the token attends over the S
    cached positions, as in the reference (JAX drops an out-of-bounds
    scatter); a sliding window's ring buffer writes slot ``kv_len % S``
    instead.  On the paged routes the step reads ``max(kv_len)`` on the
    host once to know: when some row has reached S, each layer writes
    through the plain insert (masked, or the ring's) and launches the
    attend-only kernel over ``min(kv_len + 1, S)`` positions instead of the
    fused write-and-attend launch, which writes at ``kv_len``.
    """
    cfg: ModelConfig
    route: str
    kv_len: torch.Tensor
    valid: torch.Tensor  # min(kv_len + 1, S)
    tables: Optional[torch.Tensor] = None
    overflow: bool = False

    @classmethod
    def plan(cls, cfg: ModelConfig, x, attn_impl: str, cache: dict,
             kv_len) -> "DecodeAttention":
        route = decode_route(cfg, x, attn_impl)
        S = cache["k"].shape[2]
        kv_len = kv_len.to(device=x.device, dtype=torch.int32)
        step = cls(cfg, route, kv_len, torch.clamp(kv_len + 1, max=S))
        if route in ("paged", "paged_ref") and not isinstance(x, DTensor):
            step.plan_pages(kv_len, S)
        return step

    def plan_pages(self, kv_len, S: int) -> None:
        """The page tables (one page per row) and the overflow flag of the
        rows ``kv_len`` (B,) holds."""
        self.tables = torch.arange(kv_len.shape[0], dtype=torch.int32,
                                   device=kv_len.device)[:, None]
        self.overflow = int(kv_len.max()) >= S

    def __call__(self, cache: dict, i: int, q, k, v, compute_dtype):
        """Layer ``i``: write the token's K/V (B, 1, KVH, hd) into the
        cache and attend q (B, 1, Hq, hd) over it; counted in
        ``DECODE_ROUTES``.  Returns (B, 1, Hq, hd).  DTensors go through
        the paged routes on each device's shard: its rows and heads of q,
        the new K/V and the cache, which the kernel writes in place."""
        cfg, route = self.cfg, self.route
        DECODE_ROUTES[route] += 1
        if route not in ("paged", "paged_ref"):
            L.cache_insert_layer(cache, i, k, v, self.kv_len, cfg)
            kc, vc = L.cache_layer_arrays(cache, i, cfg, compute_dtype)
            return L.decode_attention(q, kc, vc, self.valid,
                                      kv_chunk=cfg.decode_kv_chunk)
        # the layer's (B, S, KVH, hd) slice: B pages of S tokens
        k_pages, v_pages = cache["k"][i], cache["v"][i]
        if not isinstance(q, DTensor):
            return self._paged(cache, i, q, k, v, k_pages, v_pages,
                               self.kv_len, self.valid)
        pl, mesh, (q, k, v) = head_shards(q, k, v)
        if tuple(k_pages.placements) != tuple(pl):
            raise NotImplementedError(
                f"the paged routes need the cache placed as the query "
                f"({k_pages.placements} against {pl})")
        rows = project(pl, {0: 0})
        kv_len, valid = (local_as(t, rows, mesh)
                         for t in (self.kv_len, self.valid))
        if self.tables is None:  # this device's rows
            self.plan_pages(kv_len, k_pages.shape[1])
        local = {n: t.to_local() for n, t in cache.items()}
        o = self._paged(local, i, q, k, v, k_pages.to_local(),
                        v_pages.to_local(), kv_len, valid)
        return DTensor.from_local(o, mesh, pl, run_check=False)

    def _paged(self, cache, i, q, k, v, k_pages, v_pages, kv_len, valid):
        impl = "cuda" if self.route == "paged" else "ref"
        if self.overflow:
            L.cache_insert_layer(cache, i, k, v, kv_len, self.cfg)
            o = paged_attention(q[:, 0], k_pages, v_pages, self.tables,
                                valid, impl=impl)
        else:
            o, _, _ = paged_decode_step(q[:, 0], k[:, 0], v[:, 0], k_pages,
                                        v_pages, self.tables, kv_len,
                                        impl=impl)
        return o[:, None]


def _attn_layer_decode(x, p, cfg: ModelConfig, positions, cache: dict,
                       i: int, attn: DecodeAttention, compute_dtype,
                       shd: Optional[ShardingCtx] = None):
    """One-token self-attention sublayer with its residual (decode): x
    (B, 1, D), the token's K/V written into layer ``i`` of the cache."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(h, p, cfg, shd)
    q = L.apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = L.apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    o = attn(cache, i, q, k, v, compute_dtype)
    return x + _out_proj(o.to(x.dtype), p["wo"])


def decoder_decode_step(params: dict, cfg: ModelConfig, cache: dict,
                        batch: dict, mlp: Callable, *,
                        attn_impl: str = "auto",
                        compute_dtype: torch.dtype = L.COMPUTE_DTYPE,
                        fp32: tuple = NORMS,
                        shd: Optional[ShardingCtx] = None):
    """The decoder-only decode step with the feed-forward sublayer
    ``mlp(x, p, cfg)`` and the ``fp32`` layer parameters as in
    ``decoder_prefill``; see ``dense_decode_step``."""
    tokens = batch["tokens"]
    B = tokens.shape[0]
    dev = params["embed"].device
    x = embed(params, tokens, compute_dtype)
    positions = _positions(cfg, batch, B, 1, dev, offset=batch["kv_len"])
    attn = DecodeAttention.plan(cfg, x, attn_impl, cache, batch["kv_len"])
    for i in range(cfg.num_layers):
        p = _layer_params(params, i, compute_dtype, fp32=fp32)
        x = _attn_layer_decode(x, p, cfg, positions, cache, i, attn,
                               compute_dtype, shd)
        x = mlp(x, p, cfg, shd)
    return _logits(params, cfg, x[:, 0], shd), cache


def dense_decode_step(params: dict, cfg: ModelConfig, cache: dict,
                      batch: dict, *, attn_impl: str = "auto",
                      compute_dtype: torch.dtype = L.COMPUTE_DTYPE,
                      shd: Optional[ShardingCtx] = None):
    """batch: ``tokens`` (B, 1), ``kv_len`` (B,).  Returns (logits (B, V),
    cache), the cache updated in place with one token write per layer
    (what donation does in the reference); a write past the cache's end is
    dropped (``DecodeAttention``)."""
    return decoder_decode_step(params, cfg, cache, batch, _mlp_layer,
                               attn_impl=attn_impl,
                               compute_dtype=compute_dtype, shd=shd)


def init_cache_shape(cfg: ModelConfig, batch: int, max_len: int, *,
                     dtype: torch.dtype = L.COMPUTE_DTYPE, device="meta"):
    """The decode cache's tensors for (batch, max_len), on ``device``
    (``meta``: shapes and dtypes only)."""
    return L.init_kv_cache(cfg, cfg.num_layers, batch, max_len,
                           cfg.num_kv_heads, dtype=dtype, device=device)
