"""xLSTM in PyTorch: alternating mLSTM (matrix memory) and sLSTM (scalar
memory) blocks — the port of ``repro.models.xlstm``: init, the train loss,
prefill and decode.

- The mLSTM's prefill runs its parallel (attention-like, exp-gated) form
  in query chunks, its scores in fp32 from fp32 operands (the reference
  contracts bf16 with ``preferred_element_type=float32``); decode runs its
  O(1) recurrent step.
- The sLSTM is recurrent in time (its gates read h_{t-1}): a Python loop
  over positions, where the reference scans.
- Prefill hands decode the mLSTM's final (C, n, m) from a second loop over
  every position of the padded sequence (``mlstm_final_state``), as the
  reference does: a ragged row's state has absorbed its pad tokens
  (ROADMAP.md §3).

The train loss runs the mLSTM's parallel form and the sLSTM's scan over the
whole sequence and keeps no state; as in the reference, no block is
checkpointed.

There is no attention and no KV cache: the decode state is (C, n, m) per
mLSTM block and (c, n, h, m) per sLSTM block, a tuple per block, updated
in place by ``xlstm_decode_step``.  No kernel runs on this path; the two
time loops' steps are counted in ``LOOP_STEPS``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import cast_once
from repro_torch.models.sharding import (
    ShardingCtx,
    along,
    constrain,
    linear,
    on_batch_shards,
    pointwise,
    reshape,
)
from repro_torch.models.transformer import (
    _last_logits,
    _logits,
    cross_entropy,
    embed,
    train_attention_impl,
)

# steps of the two time loops since the counts were last set to 0: the
# sLSTM's scan (one per position and block) and the mLSTM's final-state
# recurrence in prefill
LOOP_STEPS = {"slstm_scan": 0, "mlstm_final_state": 0}
# the weights read in fp32 whatever the compute dtype: norms, the gates'
# projections and biases, the sLSTM's recurrent kernels
FP32_PARAMS = ("ln", "ln_cell", "ln_out", "w_i", "w_f", "b_i", "b_f",
               "w_gates", "r_gates", "b_gates")
NEG_INIT = -1e30  # the stabilizer m before any step

# block i is mLSTM if i % 2 == 0 else sLSTM


def _dims(cfg: ModelConfig):
    D = cfg.d_model
    Di = 2 * D  # mLSTM up-projection factor 2
    H = cfg.num_heads
    dk = Di // H
    dh = D // H  # sLSTM head dim
    Fs = int(round(4 * D / 3 / 64) * 64) or 64  # sLSTM ffn pf 4/3
    return D, Di, H, dk, dh, Fs


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _ones(n: int, dev) -> torch.Tensor:
    return torch.ones((n,), dtype=torch.float32, device=dev)


def init_mlstm_block(cfg: ModelConfig, gen: torch.Generator,
                     device=None) -> dict:
    D, Di, H, _, _, _ = _dims(cfg)
    dev = device if device is not None else gen.device
    return {
        "ln": _ones(D, dev),
        "w_up": L.dense_init(gen, (D, 2 * Di), device=dev),
        "wq": L.dense_init(gen, (Di, Di), in_axis_size=Di, device=dev),
        "wk": L.dense_init(gen, (Di, Di), in_axis_size=Di, device=dev),
        "wv": L.dense_init(gen, (Di, Di), in_axis_size=Di, device=dev),
        "w_i": L.dense_init(gen, (Di, H), in_axis_size=Di, device=dev),
        "w_f": L.dense_init(gen, (Di, H), in_axis_size=Di, device=dev),
        "b_i": torch.zeros((H,), dtype=torch.float32, device=dev),
        "b_f": 3.0 * _ones(H, dev),  # forget-gate bias init
        "ln_cell": _ones(Di, dev),
        "w_down": L.dense_init(gen, (Di, D), in_axis_size=Di, device=dev),
    }


def init_slstm_block(cfg: ModelConfig, gen: torch.Generator,
                     device=None) -> dict:
    D, _, H, _, dh, Fs = _dims(cfg)
    dev = device if device is not None else gen.device
    w_gates = L.dense_init(gen, (D, 4, H, dh), device=dev)
    r_gates = torch.empty((4, H, dh, dh), dtype=torch.float32, device=dev)
    if torch.device(dev).type != "meta":
        r_gates.normal_(0.0, 1.0, generator=gen).mul_(0.1 / math.sqrt(dh))
    b_gates = torch.zeros((4, H, dh), dtype=torch.float32, device=dev)
    b_gates[1] = 3.0  # the forget gate's
    return {
        "ln": _ones(D, dev),
        "w_gates": w_gates,  # i, f, z, o input kernels
        "r_gates": r_gates,
        "b_gates": b_gates,
        "ln_out": _ones(D, dev),
        "ffn_gate": L.dense_init(gen, (D, Fs), device=dev),
        "ffn_up": L.dense_init(gen, (D, Fs), device=dev),
        "ffn_down": L.dense_init(gen, (Fs, D), in_axis_size=Fs, device=dev),
    }


def init_xlstm(cfg: ModelConfig, gen: torch.Generator, device=None) -> dict:
    """Random fp32 parameters drawn from ``gen``, on ``device`` (default
    ``gen``'s; ``meta`` gives shapes and allocates nothing); ``blocks`` a
    list, mLSTM at even indices and sLSTM at odd."""
    dev = device if device is not None else gen.device
    embed = L.dense_init(gen, (cfg.vocab_size, cfg.d_model),
                         in_axis_size=cfg.d_model, device=dev)
    blocks = [(init_mlstm_block if i % 2 == 0 else init_slstm_block)(
        cfg, gen, dev) for i in range(cfg.num_layers)]
    return {
        "embed": embed,
        "blocks": blocks,
        "final_ln": _ones(cfg.d_model, dev),
        "lm_head": L.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                device=dev),
    }


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def _mlstm_parallel(q, k, v, i_raw, f_raw, chunk: int):
    """Parallel exp-gated form over query chunks.  q, k, v: (B, S, H, dk);
    i_raw, f_raw: (B, S, H).  Returns (B, S, H, dk) fp32.  A row's result
    depends on its own query only, so the last chunk runs short where the
    reference pads it."""
    B, S, H, dk = q.shape
    logf = pointwise(F.logsigmoid, f_raw.float())  # (B, S, H)
    Fcum = along(lambda t: torch.cumsum(t, dim=1), logf, 1)  # inclusive
    i32 = i_raw.float()
    k32, v32 = k.float(), v.float()
    kpos = torch.arange(S, device=q.device)
    C = min(chunk, S)
    ys = []
    for c0 in range(0, S, C):
        qc = q[:, c0:c0 + C].float()
        n = qc.shape[1]
        qpos = c0 + torch.arange(n, device=q.device)
        # log decay D(i, j) = i_j + F_i - F_j
        logD = (Fcum[:, c0:c0 + n, None, :] - Fcum[:, None, :, :]
                + i32[:, None])  # (B, n, S, H)
        mask = (kpos[None, :] <= qpos[:, None])[None, :, :, None]
        logD = logD.masked_fill(~mask, -math.inf)
        m = torch.clamp(logD.amax(dim=2, keepdim=True), min=NEG_INIT)
        s = torch.einsum("bchd,bshd->bcsh", qc, k32) / math.sqrt(dk)
        w = s * torch.exp(logD - m)
        w = torch.where(mask, w, 0.0)
        norm = torch.maximum(w.sum(dim=2, keepdim=True).abs(),
                             torch.exp(-m))  # (B, n, 1, H)
        y = torch.einsum("bcsh,bshd->bchd", w, v32)
        ys.append(y / norm[:, :, 0][..., None])
    return torch.cat(ys, dim=1)


def _mlstm_step(q, k, v, i_raw, f_raw, state):
    """Recurrent step.  q, k, v: (B, H, dk); gates: (B, H); state (C, n,
    m): (B, H, dk, dk), (B, H, dk), (B, H), fp32."""
    Cm, nm, m = state
    dk = q.shape[-1]
    logf = pointwise(F.logsigmoid, f_raw.float())
    i32 = i_raw.float()
    m_new = torch.maximum(logf + m, i32)
    fdec = torch.exp(logf + m - m_new)[..., None]
    iexp = torch.exp(i32 - m_new)[..., None]
    k32, v32, q32 = k.float(), v.float(), q.float()
    C_new = fdec[..., None] * Cm + iexp[..., None] * k32[..., :, None] \
        * v32[..., None, :]
    n_new = fdec * nm + iexp * k32
    qs = q32 / math.sqrt(dk)
    h_num = torch.einsum("bhd,bhde->bhe", qs, C_new)
    h_den = torch.maximum(torch.einsum("bhd,bhd->bh", qs, n_new).abs(),
                          torch.exp(-m_new))
    return h_num / h_den[..., None], (C_new, n_new, m_new)


def _mlstm_inputs(x, p, cfg: ModelConfig):
    """The block's pre-norm projections: (gate, q, k, v (B, S, H, dk) in
    x's dtype, i_raw, f_raw (B, S, H) fp32)."""
    _, _, H, dk, _, _ = _dims(cfg)
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    u, gate = linear(h, p["w_up"]).chunk(2, dim=-1)
    B, S = u.shape[:2]
    q, k, v = (reshape(linear(u, p[w]), B, S, H, dk)
               for w in ("wq", "wk", "wv"))
    u32 = u.float()
    i_raw = linear(u32, p["w_i"]) + p["b_i"]
    f_raw = linear(u32, p["w_f"]) + p["b_f"]
    return gate, q, k, v, i_raw, f_raw


def mlstm_block(x, p, cfg: ModelConfig, state=None, inputs=None,
                shd: Optional[ShardingCtx] = None):
    """The mLSTM block with its residual: the parallel form over the whole
    sequence (``state`` None), else one recurrent step.  ``inputs``: the
    block's ``_mlstm_inputs`` when the caller has them.  Returns (out, new
    state or None)."""
    _, Di, _, _, _, _ = _dims(cfg)
    gate, q, k, v, i_raw, f_raw = (inputs if inputs is not None
                                   else _mlstm_inputs(x, p, cfg))
    B, S = q.shape[:2]
    if state is None:
        y = _mlstm_parallel(q, k, v, i_raw, f_raw, cfg.attn_chunk)
        new_state = None
    else:
        y, new_state = _mlstm_step(q[:, 0], k[:, 0], v[:, 0], i_raw[:, 0],
                                   f_raw[:, 0], state)
        y = y[:, None]
    y = L.rms_norm(reshape(y, B, S, Di).to(x.dtype), p["ln_cell"],
                   cfg.norm_eps)
    y = y * F.silu(gate)
    return constrain(shd, "residual", x + linear(y, p["w_down"])), new_state


def mlstm_final_state(q, k, v, i_raw, f_raw):
    """The final (C, n, m) after a whole prefill sequence, stepped over
    every position in order (for the decode handoff), on each device's
    rows of DTensors (``sharding.on_batch_shards``)."""
    if isinstance(q, DTensor):
        return on_batch_shards(mlstm_final_state, [q, k, v, i_raw, f_raw])
    B, S, H, dk = q.shape
    state = (torch.zeros((B, H, dk, dk), dtype=torch.float32,
                         device=q.device),
             torch.zeros((B, H, dk), dtype=torch.float32, device=q.device),
             torch.full((B, H), NEG_INIT, dtype=torch.float32,
                        device=q.device))
    for t in range(S):
        _, state = _mlstm_step(q[:, t], k[:, t], v[:, t], i_raw[:, t],
                               f_raw[:, t], state)
        LOOP_STEPS["mlstm_final_state"] += 1
    return state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def _slstm_scan(g_in, r, state):
    """g_in: (B, S, 4, H, dh) input-kernel preactivations (with the bias);
    r: (4, H, dh, dh) recurrent kernels; state (c, n, h, m), each (B, H,
    dh).  Returns (hs (B, S, H, dh), the final state), fp32.  DTensors
    run on each device's rows with the recurrent kernels whole
    (``sharding.on_batch_shards``)."""
    if isinstance(g_in, DTensor):
        return on_batch_shards(
            lambda g, c, n, h, m, r_: _slstm_scan(g, r_, (c, n, h, m)),
            [g_in, *state], [r])
    c, n, h, m = state
    hs = []
    for t in range(g_in.shape[1]):
        rec = torch.einsum("bhd,ghde->bghe", h, r)  # (B, 4, H, dh)
        it, ft, zt, ot = (g_in[:, t, i] + rec[:, i] for i in range(4))
        m_new = torch.maximum(ft + m, it)
        i_g = torch.exp(it - m_new)
        f_g = torch.exp(ft + m - m_new)
        c = f_g * c + i_g * torch.tanh(zt)
        n = f_g * n + i_g
        h = torch.sigmoid(ot) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
        LOOP_STEPS["slstm_scan"] += 1
    return torch.stack(hs, dim=1), (c, n, h, m)


def slstm_block(x, p, cfg: ModelConfig, state=None,
                shd: Optional[ShardingCtx] = None):
    """The sLSTM block (the recurrence, then a gated FFN of width Fs), each
    with its residual.  Returns (out, new state)."""
    D, _, H, _, dh, _ = _dims(cfg)
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    B, S = h.shape[:2]
    w = p["w_gates"]  # (D, 4, H, dh)
    g_in = reshape(linear(h.float(), reshape(w, D, -1)), B, S,
                   *w.shape[1:]) \
        + p["b_gates"]
    if state is None:
        z = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
        state = (z, z, z, torch.full_like(z, NEG_INIT))
    hs, new_state = _slstm_scan(g_in, p["r_gates"], state)
    y = L.rms_norm(reshape(hs, B, S, D).to(x.dtype), p["ln_out"],
                   cfg.norm_eps)
    x = x + y
    g = F.silu(linear(x, p["ffn_gate"]))
    out = x + linear(g * linear(x, p["ffn_up"]), p["ffn_down"])
    return constrain(shd, "residual", out), new_state


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _block_params(p: dict, dtype: torch.dtype) -> dict:
    return {k: v if k in FP32_PARAMS else cast_once(v, dtype)
            for k, v in p.items()}


def _block(h, raw: dict, cfg: ModelConfig, i: int, state=None,
           collect: bool = False, compute_dtype=L.COMPUTE_DTYPE,
           shd: Optional[ShardingCtx] = None):
    """Block ``i`` (its fp32 parameters ``raw``) on h: one step from
    ``state`` (decode), or the whole sequence, with ``collect`` also the
    mLSTM's final state from ``mlstm_final_state`` (prefill).  Returns (h,
    the new state)."""
    p = _block_params(raw, compute_dtype)
    if i % 2:
        return slstm_block(h, p, cfg, state=state, shd=shd)
    if collect and state is None:
        inputs = _mlstm_inputs(h, p, cfg)
        final = mlstm_final_state(*inputs[1:])
        h, _ = mlstm_block(h, p, cfg, inputs=inputs, shd=shd)
        return h, final
    return mlstm_block(h, p, cfg, state=state, shd=shd)


def _trunk(params: dict, cfg: ModelConfig, h, states=None,
           collect: bool = False, compute_dtype=L.COMPUTE_DTYPE,
           keep_states: bool = True, shd: Optional[ShardingCtx] = None):
    """Every block in order.  ``states`` (decode): one state tuple per
    block.  ``collect`` (prefill): also the mLSTM's final state.
    ``keep_states`` False (the train loss): no state is kept.  Returns (h,
    the new states, or None)."""
    new_states = []
    for i, raw in enumerate(params["blocks"]):
        h, ns = _block(h, raw, cfg, i,
                       state=states[i] if states is not None else None,
                       collect=collect, compute_dtype=compute_dtype, shd=shd)
        if keep_states:
            new_states.append(ns)
    return h, new_states if keep_states else None


def xlstm_train_loss(params: dict, cfg: ModelConfig, batch: dict, *,
                     vocab_chunk: int = 0, attn_impl: str = "auto",
                     compute_dtype: torch.dtype = L.COMPUTE_DTYPE,
                     shd: Optional[ShardingCtx] = None) -> torch.Tensor:
    """The next-token loss of ``tokens`` against ``labels`` (B, S), -1
    masked, through every block over the whole sequence (the sLSTM's time
    loop, counted in ``LOOP_STEPS``) with no state kept.  ``attn_impl``
    is checked as for every family (no block attends)."""
    train_attention_impl(attn_impl)
    tokens = batch["tokens"]
    h = constrain(shd, "residual", embed(params, tokens, compute_dtype))
    h, _ = _trunk(params, cfg, h, compute_dtype=compute_dtype,
                  keep_states=False, shd=shd)
    h = L.rms_norm(h, params["final_ln"], cfg.norm_eps)
    return cross_entropy(h, params["lm_head"], batch["labels"], vocab_chunk,
                         shd)


def xlstm_prefill(params: dict, cfg: ModelConfig, batch: dict, *,
                  max_len=None, attn_impl: str = "auto",
                  compute_dtype: torch.dtype = L.COMPUTE_DTYPE,
                  shd: Optional[ShardingCtx] = None):
    """Returns (last-prompt-position logits (B, V), the decode state (a
    tuple of per-block state tuples), prompt_lens (B,)).  ``max_len`` and
    ``attn_impl`` are taken for the Model API's signature: the state does
    not grow and no block attends."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = params["embed"].device
    h = constrain(shd, "residual", embed(params, tokens, compute_dtype))
    prompt_lens = batch.get("prompt_lens")
    if prompt_lens is None:
        prompt_lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    h, states = _trunk(params, cfg, h, collect=True,
                       compute_dtype=compute_dtype, shd=shd)
    return (_last_logits(params, cfg, h, prompt_lens, shd), tuple(states),
            prompt_lens)


def xlstm_decode_step(params: dict, cfg: ModelConfig, cache: tuple,
                      batch: dict, *, attn_impl: str = "auto",
                      compute_dtype: torch.dtype = L.COMPUTE_DTYPE,
                      shd: Optional[ShardingCtx] = None):
    """batch: ``tokens`` (B, 1) (``kv_len`` is not read: the state holds
    the history).  Returns (logits (B, V), cache), every state tensor
    updated in place."""
    h = embed(params, batch["tokens"], compute_dtype)
    h, new_states = _trunk(params, cfg, h, states=list(cache),
                           compute_dtype=compute_dtype, shd=shd)
    for old, new in zip(cache, new_states):
        for a, b in zip(old, new):
            L.write_state(a, (), b)
    return _logits(params, cfg, h[:, 0], shd), cache
