"""Mamba2 (SSD) layers and the Zamba2 hybrid in PyTorch — the port of
``repro.models.mamba2``: init, the train loss, prefill and decode.

SSD runs in its chunked form: quadratic products within a chunk and a
recurrence across chunks, a Python loop over the chunks where the
reference scans.  The scan and the depthwise causal conv are plain
PyTorch, as the reference computes them in ``jnp`` outside any Pallas
kernel, with the reference's fp32 islands: ``dt``, the scan and its
state, the D skip and the gate run in fp32 (the conv's fp32 weights
promote its output to fp32, as in the reference), and the conv state
stays in the compute dtype.

The Zamba2 shared transformer block is one set of weights applied every
``shared_attn_every`` mamba layers; each application has its own KV cache
slot ``layer_idx`` in ``cache["attn"]``, stacked ``(n_super, B, W, KVH,
hd)``.  Its attention takes the dense family's routes as they are
(``models.transformer``): flash in prefill with the sliding window, at
any prompt length, and in decode one
``DecodeAttention`` plan a step over ``cache["attn"]``, the fused paged
step while every row is inside the ring, else the ring's insert and the
attend-only launch.

The train loss checkpoints each mamba layer, as the reference does (the
shared block is not), and runs the shared block's attention on the
reference's plain code.

Prefill runs the recurrences over the whole padded sequence, as the
reference does: a ragged row's conv state (the last W - 1 positions) and
SSM state have absorbed its pad tokens (ROADMAP.md §3).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.layers import cast_once
from repro_torch.models.sharding import (
    ShardingCtx,
    constrain,
    linear,
    on_batch_shards,
    reshape,
)

# the weights cast to the compute dtype at use (the rest is read in fp32)
MAMBA_CAST = ("w_in", "w_out")
SHARED_FP32 = ("ln1", "ln2", "ln_concat")

# ---------------------------------------------------------------------------
# dims and init
# ---------------------------------------------------------------------------


def mamba_dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    N = cfg.ssm_state
    conv_ch = d_inner + 2 * N
    d_in_proj = 2 * d_inner + 2 * N + H  # z, xBC, dt
    return d_inner, H, N, conv_ch, d_in_proj


def _mamba_empty(cfg: ModelConfig, lead: tuple, dev) -> dict:
    """One or a stack of mamba layers: the deterministic tensors set, the
    drawn ones allocated (``_mamba_draw`` fills them)."""
    D = cfg.d_model
    d_inner, H, N, conv_ch, d_in_proj = mamba_dims(cfg)

    def full(shape, value):
        return torch.full(lead + shape, value, dtype=torch.float32,
                          device=dev)

    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                     device=dev))
    return {
        "ln": full((D,), 1.0),
        "w_in": torch.empty(lead + (D, d_in_proj), device=dev),
        "conv_w": torch.empty(lead + (cfg.ssm_conv_width, conv_ch),
                              device=dev),
        "conv_b": full((conv_ch,), 0.0),
        "A_log": a_log.expand(lead + (H,)).clone(),
        "dt_bias": torch.empty(lead + (H,), device=dev),
        "D_skip": full((H,), 1.0),
        "w_out": torch.empty(lead + (d_inner, D), device=dev),
        "ln_gate": full((d_inner,), 1.0),
    }


def _mamba_draw(cfg: ModelConfig, gen: torch.Generator, p: dict) -> None:
    """Fill one layer's drawn tensors in place, in the reference's order:
    w_in, conv_w ~ 0.1 N(0, 1), dt_bias = log(expm1(10^U(-4, -1))), w_out."""
    d_inner = mamba_dims(cfg)[0]
    L.dense_fill(gen, p["w_in"], cfg.d_model)
    p["conv_w"].normal_(0.0, 1.0, generator=gen).mul_(0.1)
    u = torch.empty_like(p["dt_bias"]).uniform_(-4.0, -1.0, generator=gen)
    p["dt_bias"].copy_(torch.log(torch.expm1(10.0 ** u)))
    L.dense_fill(gen, p["w_out"], d_inner)


def init_mamba_layer(cfg: ModelConfig, gen: torch.Generator,
                     device=None) -> dict:
    dev = device if device is not None else gen.device
    p = _mamba_empty(cfg, (), dev)
    if torch.device(dev).type != "meta":
        _mamba_draw(cfg, gen, p)
    return p


def init_zamba(cfg: ModelConfig, gen: torch.Generator, device=None) -> dict:
    """Random fp32 parameters drawn from ``gen``, on ``device`` (default
    ``gen``'s; ``meta`` gives shapes and allocates nothing): ``mamba``
    stacked (n_super, every, ...), filled layer by layer; the shared block
    is the dense layer with ``w_concat`` (2D, D) and ``ln_concat``."""
    if cfg.num_layers % cfg.shared_attn_every:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers, shared "
                         f"block every {cfg.shared_attn_every}")
    dev = device if device is not None else gen.device
    n_super = cfg.num_layers // cfg.shared_attn_every
    every = cfg.shared_attn_every
    embed = L.dense_init(gen, (cfg.vocab_size, cfg.d_model),
                         in_axis_size=cfg.d_model, device=dev)
    mamba = _mamba_empty(cfg, (n_super, every), dev)
    if torch.device(dev).type != "meta":
        for i in range(n_super):
            for j in range(every):
                _mamba_draw(cfg, gen, {k: v[i, j] for k, v in mamba.items()})
    shared = T.init_dense_layer(cfg, gen, dev)
    D = cfg.d_model
    shared["w_concat"] = L.dense_init(gen, (2 * D, D), in_axis_size=2 * D,
                                      device=dev)
    shared["ln_concat"] = torch.ones((2 * D,), dtype=torch.float32,
                                     device=dev)
    return {
        "embed": embed,
        "mamba": mamba,
        "shared_attn": shared,
        "final_ln": torch.ones((D,), dtype=torch.float32, device=dev),
        "lm_head": L.dense_init(gen, (D, cfg.vocab_size), device=dev),
    }


# ---------------------------------------------------------------------------
# SSD forward
# ---------------------------------------------------------------------------


def _conv1d_causal(xBC, w, b, state=None):
    """Depthwise causal conv.  xBC: (B, S, C); w: (W, C) fp32; state:
    (B, W - 1, C).  Returns (silu(conv + b), fp32 as the fp32 weights make
    it; the last W - 1 positions of the padded input, xBC's dtype)."""
    W = w.shape[0]
    if state is None:
        pad = xBC.new_zeros(xBC.shape[:1] + (W - 1,) + xBC.shape[2:])
    else:
        pad = state.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)  # (B, S + W - 1, C)
    S = xBC.shape[1]
    out = sum(xp[:, i:i + S] * w[i] for i in range(W))
    return F.silu(out + b), xp[:, -(W - 1):]


def ssd_scan(x, Bmat, Cmat, dt, A, chunk: int, h0=None):
    """Chunked SSD.  x: (B, S, H, P); Bmat/Cmat: (B, S, N); dt: (B, S, H);
    A: (H,) < 0.  Returns y (B, S, H, P) and the final state (B, H, P, N),
    fp32.  S is padded up to a multiple of the chunk with dt = 0 (no state
    update, unit decay: exact).  DTensors run on each device's rows
    (``sharding.on_batch_shards``)."""
    if isinstance(x, DTensor):
        rows = [x, Bmat, Cmat, dt] + ([] if h0 is None else [h0])
        return on_batch_shards(
            lambda *t: ssd_scan(*t[:4], t[-1], chunk,
                                t[4] if len(t) == 6 else None), rows, [A])
    Bsz, S, H, P = x.shape
    N = Bmat.shape[-1]
    Q = min(chunk, S)
    Sp = -(-S // Q) * Q
    if Sp != S:
        x = F.pad(x, (0, 0, 0, 0, 0, Sp - S))
        Bmat = F.pad(Bmat, (0, 0, 0, Sp - S))
        Cmat = F.pad(Cmat, (0, 0, 0, Sp - S))
        dt = F.pad(dt, (0, 0, 0, Sp - S))
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    ys = []
    for c0 in range(0, Sp, Q):
        xq, bq, cq, dq = (t[:, c0:c0 + Q].float()
                          for t in (x, Bmat, Cmat, dt))
        cum = torch.cumsum(dq * A, dim=1)  # (B, Q, H), negative
        # intra-chunk: scores(i, j, h) = (C_i . B_j) exp(cum_i - cum_j) dt_j
        cb = torch.einsum("bin,bjn->bij", cq, bq)
        decay = torch.exp(cum[:, :, None] - cum[:, None, :])  # (B, Q, Q, H)
        w = cb[..., None] * decay * dq[:, None]
        w = torch.where(mask[None, :, :, None], w, 0.0)
        y_intra = torch.einsum("bijh,bjhp->bihp", w, xq)
        # inter-chunk: y_i += exp(cum_i) C_i . h
        y_inter = torch.einsum("bih,bin,bhpn->bihp", torch.exp(cum), cq, h)
        # state update, decayed to the chunk's end
        seg = torch.exp(cum[:, -1:, :] - cum)
        dx = xq * (dq * seg)[..., None]
        h = torch.exp(cum[:, -1])[:, :, None, None] * h + torch.einsum(
            "bqhp,bqn->bhpn", dx, bq)
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1)[:, :S], h


def mamba_forward(x, p, cfg: ModelConfig, conv_state=None, ssm_state=None,
                  shd: Optional[ShardingCtx] = None):
    """One mamba layer with its residual: the whole sequence (prefill) when
    both states are None and S > 1, else one recurrent step from them.
    ``p``'s ``w_in``/``w_out`` in x's dtype (cast by the caller), the rest
    fp32.  Returns (out, (new conv state, new SSM state))."""
    d_inner, H, N, conv_ch, _ = mamba_dims(cfg)
    res = x
    xh = L.rms_norm(x, p["ln"], cfg.norm_eps)
    proj = linear(xh, p["w_in"].to(xh.dtype))
    z, xBC, dt_raw = torch.split(proj, [d_inner, conv_ch, H], dim=-1)
    xBC, new_conv = _conv1d_causal(xBC, p["conv_w"], p["conv_b"], conv_state)
    xs, Bmat, Cmat = torch.split(xBC, [d_inner, N, N], dim=-1)
    Bsz, S = xs.shape[:2]
    xs = reshape(xs, Bsz, S, H, cfg.ssm_head_dim)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    if ssm_state is None and S > 1:
        y, h_final = ssd_scan(xs, Bmat, Cmat, dt, A, cfg.ssm_chunk)
    else:
        h0 = ssm_state if ssm_state is not None else torch.zeros(
            (Bsz, H, cfg.ssm_head_dim, N), dtype=torch.float32,
            device=x.device)
        dA = torch.exp(dt[:, 0] * A)  # (B, H)
        dx = xs[:, 0].float() * dt[:, 0][..., None]  # (B, H, P)
        h_final = dA[:, :, None, None] * h0 + torch.einsum(
            "bhp,bn->bhpn", dx, Bmat[:, 0].float())
        y = torch.einsum("bn,bhpn->bhp", Cmat[:, 0].float(), h_final)[:, None]
    y = y + xs.float() * p["D_skip"][:, None]
    y = reshape(y, Bsz, S, d_inner)
    y = y * F.silu(z.float())
    y = L.rms_norm(y.to(x.dtype), p["ln_gate"], cfg.norm_eps)
    out = linear(y, p["w_out"].to(x.dtype))
    return constrain(shd, "residual", res + out), (new_conv, h_final)


# ---------------------------------------------------------------------------
# the shared attention block
# ---------------------------------------------------------------------------


def shared_attn_block(x, h0, p, cfg: ModelConfig, positions, *,
                      attn_impl: str = "auto", cache=None,
                      attn: Optional[T.DecodeAttention] = None,
                      layer_idx=None,
                      compute_dtype: torch.dtype = L.COMPUTE_DTYPE,
                      shd: Optional[ShardingCtx] = None):
    """The shared transformer block on concat(x, h0) (h0: the initial
    embeddings), its weights in x's dtype and its norms fp32.  Prefill
    (``cache`` None) returns (out, (k, v)) of the whole sequence; decode
    writes the token's K/V into application ``layer_idx`` of ``cache``
    through the step's ``attn`` plan and returns (out, cache)."""
    cat = L.rms_norm(torch.cat([x, h0], dim=-1), p["ln_concat"],
                     cfg.norm_eps)
    h = linear(cat, p["w_concat"])
    hh = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    q, k, v = T._qkv(hh, p, cfg, shd)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    if cache is None:
        o = T.prefill_attention(q, k, v, cfg, attn_impl, shd=shd)
        new_cache = (k, v)
    else:
        o = attn(cache, layer_idx, q, k, v, compute_dtype)
        new_cache = cache
    h = h + T._out_proj(o.to(x.dtype), p["wo"])
    hh = L.rms_norm(h, p["ln2"], cfg.norm_eps)
    g = F.silu(linear(hh, p["w_gate"]))
    ff = linear(constrain(shd, "ffn", g * linear(hh, p["w_up"])),
                p["w_down"])
    return constrain(shd, "residual", x + h + ff), new_cache


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _shared_params(params: dict, dtype: torch.dtype) -> dict:
    return {k: v if k in SHARED_FP32 else cast_once(v, dtype)
            for k, v in params["shared_attn"].items()}


def _mamba_params(params: dict, i: int, j: int, dtype: torch.dtype) -> dict:
    """Mamba layer (i, j): ``w_in``/``w_out`` from one cast of each
    stacked tensor, the rest fp32."""
    return {k: (cast_once(v, dtype) if k in MAMBA_CAST else v)[i, j]
            for k, v in params["mamba"].items()}


def _train_mamba(x, p, cfg: ModelConfig,
                 shd: Optional[ShardingCtx] = None) -> torch.Tensor:
    """One mamba layer of the train loss: its weights cast at use, its
    states dropped."""
    p = {k: v.to(x.dtype) if k in MAMBA_CAST else v for k, v in p.items()}
    return mamba_forward(x, p, cfg, shd=shd)[0]


def _zamba_trunk(params: dict, cfg: ModelConfig, h, positions, *,
                 attn_impl: str = "auto",
                 compute_dtype: torch.dtype = L.COMPUTE_DTYPE,
                 collect: bool = True, shd: Optional[ShardingCtx] = None):
    """The full-sequence trunk.  Returns (h, the shared block's K/V
    ``{"k", "v"}`` stacked (n_super, B, S, KVH, hd), the mamba states
    (conv (n_super, every, B, W - 1, C), ssm (n_super, every, B, H, P,
    N))).  ``collect`` False (the train loss): no K/V or state is kept
    (nothing is written in place), each mamba layer is checkpointed, and
    the shared block attends on the reference's plain route, counted once
    an application; returns (h, None, None)."""
    h0 = h
    shared = _shared_params(params, compute_dtype)
    n_super, every = params["mamba"]["w_in"].shape[:2]
    if not collect:
        layers = T.unstack({k: v.flatten(0, 1)
                            for k, v in params["mamba"].items()})
        for i in range(n_super):
            T.PREFILL_ROUTES["plain"] += 1
            h, _ = shared_attn_block(h, h0, shared, cfg, positions,
                                     attn_impl=T.TRAIN, shd=shd)
            for p in layers[i * every:(i + 1) * every]:
                h = T.checkpointed(_train_mamba, h, p, cfg, shd)
        return h, None, None
    kv = conv = ssm = None
    for i in range(n_super):
        h, (k, v) = shared_attn_block(h, h0, shared, cfg, positions,
                                      attn_impl=attn_impl, shd=shd)
        kv = T._cache_layer(kv, i, n_super, {"k": k, "v": v})
        states = []
        for j in range(every):
            h, st = mamba_forward(
                h, _mamba_params(params, i, j, compute_dtype), cfg, shd=shd)
            states.append(st)
        conv = T._cache_layer(conv, i, n_super, {
            "conv": _stack_states([c for c, _ in states])})
        ssm = T._cache_layer(ssm, i, n_super, {
            "ssm": _stack_states([s for _, s in states])})
    return (h, T.stack_cache(kv), (T.stack_cache(conv)["conv"],
                                   T.stack_cache(ssm)["ssm"]))


def _stack_states(states: list):
    """One application's ``every`` layer states stacked (DTensors by
    ``torch.stack``)."""
    if isinstance(states[0], DTensor):
        return torch.stack(states)
    out = states[0].new_empty((len(states),) + states[0].shape)
    for j, st in enumerate(states):
        out[j] = st
    return out


def zamba_train_loss(params: dict, cfg: ModelConfig, batch: dict, *,
                     vocab_chunk: int = 0, attn_impl: str = "auto",
                     compute_dtype: torch.dtype = L.COMPUTE_DTYPE,
                     shd: Optional[ShardingCtx] = None) -> torch.Tensor:
    """The next-token loss of ``tokens`` against ``labels`` (B, S), -1
    masked: the trunk without its states (``_zamba_trunk(collect=False)``),
    then the final norm and ``transformer.cross_entropy``."""
    T.train_attention_impl(attn_impl)
    tokens = batch["tokens"]
    dev = params["embed"].device
    h = constrain(shd, "residual", T.embed(params, tokens, compute_dtype))
    positions = T._positions(cfg, batch, *tokens.shape, dev)
    h, _, _ = _zamba_trunk(params, cfg, h, positions,
                           compute_dtype=compute_dtype, collect=False,
                           shd=shd)
    h = L.rms_norm(h, params["final_ln"], cfg.norm_eps)
    return T.cross_entropy(h, params["lm_head"], batch["labels"],
                           vocab_chunk, shd)


def zamba_prefill(params: dict, cfg: ModelConfig, batch: dict, *,
                  max_len=None, attn_impl: str = "auto",
                  compute_dtype: torch.dtype = L.COMPUTE_DTYPE,
                  shd: Optional[ShardingCtx] = None):
    """Returns (last-prompt-position logits (B, V), cache, prompt_lens
    (B,)).  The cache: ``attn`` (the shared block's K/V per application,
    (n_super, B, W, KVH, hd): padded to ``max_len``, or the last W tokens
    at their ring slots under the sliding window), ``conv`` and ``ssm``
    (the mamba states after the whole padded sequence)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = params["embed"].device
    h = T._embed_tokens(params, cfg, batch, compute_dtype, shd)
    positions = T._positions(cfg, batch, B, S, dev)
    prompt_lens = batch.get("prompt_lens")
    if prompt_lens is None:
        prompt_lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    h, kv, (conv, ssm) = _zamba_trunk(params, cfg, h, positions,
                                      attn_impl=attn_impl,
                                      compute_dtype=compute_dtype, shd=shd)
    attn = L.finalize_prefill_cache(kv["k"], kv["v"], cfg, max_len,
                                    seq_axis=2)
    cache = {"attn": attn, "conv": conv, "ssm": ssm}
    return (T._last_logits(params, cfg, h, prompt_lens, shd), cache,
            prompt_lens)


def zamba_decode_step(params: dict, cfg: ModelConfig, cache: dict,
                      batch: dict, *, attn_impl: str = "auto",
                      compute_dtype: torch.dtype = L.COMPUTE_DTYPE,
                      shd: Optional[ShardingCtx] = None):
    """batch: ``tokens`` (B, 1), ``kv_len`` (B,).  Returns (logits (B, V),
    cache), the cache updated in place: one K/V write per application of
    the shared block (one ``DecodeAttention`` plan a step over
    ``cache["attn"]``), each mamba layer's conv and SSM state."""
    tokens = batch["tokens"]
    B = tokens.shape[0]
    dev = params["embed"].device
    h = T.embed(params, tokens, compute_dtype)
    h0 = h
    positions = T._positions(cfg, batch, B, 1, dev, offset=batch["kv_len"])
    attn = T.DecodeAttention.plan(cfg, h, attn_impl, cache["attn"],
                                  batch["kv_len"])
    shared = _shared_params(params, compute_dtype)
    n_super, every = params["mamba"]["w_in"].shape[:2]
    for i in range(n_super):
        h, _ = shared_attn_block(h, h0, shared, cfg, positions,
                                 cache=cache["attn"], attn=attn, layer_idx=i,
                                 compute_dtype=compute_dtype, shd=shd)
        for j in range(every):
            h, (cst, sst) = mamba_forward(
                h, _mamba_params(params, i, j, compute_dtype), cfg,
                conv_state=cache["conv"][i, j], ssm_state=cache["ssm"][i, j],
                shd=shd)
            L.write_state(cache["conv"], (i, j), cst)
            L.write_state(cache["ssm"], (i, j), sst)
    return T._logits(params, cfg, h[:, 0], shd), cache
