"""Shared neural-net layers in PyTorch (fp32 params, bf16 compute) — the
port of ``repro.models.layers``: norms, RoPE (and qwen2-vl's M-RoPE), the
reference attention, the dense KV cache (a ring buffer under a sliding
window, int8 per (token, head) as an option) and the MLPs.

The compute dtype is an explicit argument wherever it is chosen (the embed
cast, the KV caches and pools), never read from the environment, so a
caller picks fp32 for tight comparisons without depending on import order.
Every other function computes in the dtype of its input, as the reference
does.

Where the reference contracts with ``preferred_element_type=float32``
(attention scores), the operands are up-cast to fp32 before the product so
the sum is never rounded to bf16.

The cache helpers write in place where the reference scatters into a
donated buffer.  A write past the cache's end is dropped, as JAX drops an
out-of-bounds scatter (torch indexing would raise instead).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Shard
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs.base import ModelConfig
from repro_torch.models.sharding import (
    head_shards,
    local_as,
    on_head_shards,
    project,
    reshape,
)

# bf16 activations by default; fp32 weights are cast at use (DESIGN.md §2)
COMPUTE_DTYPE = torch.bfloat16

NEG_INF = -1e30


def resolve_dtype(dtype) -> torch.dtype:
    """``torch.dtype`` from a dtype or its name (``"bfloat16"``, ``"float32"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return out


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, in_axis_size: Optional[int] = None,
               device=None) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init, fp32 params."""
    out = torch.empty(shape, dtype=torch.float32,
                      device=device if device is not None else gen.device)
    return dense_fill(gen, out,
                      in_axis_size if in_axis_size is not None else shape[0])


def dense_fill(gen: torch.Generator, out: torch.Tensor,
               fan_in: int) -> torch.Tensor:
    """``dense_init``'s draw into ``out`` in place (a stacked tensor's
    layer, filled without a per-layer copy)."""
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return out.mul_(1.0 / math.sqrt(max(fan_in, 1)))


# source tensor -> {dtype: (its version when cast, its cast)}: one cast per
# tensor, whoever reads it; keyed by identity (a tensor's == is
# elementwise) and weakly, so an entry lives as long as its source tensor
_CASTS = WeakIdKeyDictionary()


def cast_once(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t.to(dtype)``, made once per (tensor, dtype) and shared: bitwise
    what the reference's per-use ``astype`` gives, read at half the bytes
    in bf16 on every later use.

    The cache is skipped while autograd records ``t`` (a training step): a
    kept cast would hold that step's graph and go stale at the optimizer's
    update, so training casts at each use, as the reference does.  A cast
    made before an in-place write to ``t`` is made again (the tensor's
    version counter moved)."""
    if t.dtype == dtype:  # no copy; an entry holding t would keep t alive
        return t
    if t.requires_grad and torch.is_grad_enabled():
        return t.to(dtype)
    casts = _CASTS.get(t)
    if casts is None:
        casts = _CASTS[t] = {}
    version, out = casts.get(dtype, (None, None))
    if out is None or version != t._version:
        out = t.to(dtype)
        casts[dtype] = (t._version, out)
    return out


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim // 2, dtype=torch.float32,
                        device=device) * 2.0 / head_dim
    return 1.0 / (theta ** exps)


def _mrope_slots(sections: Tuple[int, ...], n: int) -> torch.Tensor:
    """Section id of each of the ``n`` frequency slots: ``jnp.repeat`` with
    ``total_repeat_length=n`` (cut at n, or the last id repeated up to n)."""
    ids = [i for i, c in enumerate(sections) for _ in range(c)][:n]
    ids += [ids[-1]] * (n - len(ids))
    return torch.tensor(ids, dtype=torch.long)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Tuple[int, ...] = ()) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) integer, or (B, S, 3) for
    M-RoPE.  Rotates split halves in fp32 and casts back to x's dtype.

    M-RoPE (qwen2-vl): the head_dim/2 frequency slots are split into
    sections; each section takes its angle from a different position
    stream (temporal / height / width)."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, device=x.device)  # (hd/2,)
    if mrope_sections:
        if positions.dim() != 3 or positions.shape[-1] != len(mrope_sections):
            raise ValueError(f"M-RoPE positions {tuple(positions.shape)}: "
                             f"want (B, S, {len(mrope_sections)})")
        sec = _mrope_slots(mrope_sections, hd // 2).to(positions.device)
        pos = positions.float().index_select(-1, sec)  # (B, S, hd/2)
        ang = pos * inv[None, None, :]
    else:
        ang = positions.float()[..., None] * inv[None, None, :]  # (B,S,hd/2)
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA sharding helper: KV-head replication (DESIGN.md §5)
# ---------------------------------------------------------------------------


def kv_replication_factor(num_heads: int, num_kv_heads: int, axis_size: int) -> int:
    """Pick r | (H/KVH) maximizing TP utilization of KVH*r heads on axis_size
    shards; ties -> smaller r (less KV memory)."""
    group = num_heads // num_kv_heads
    best_r, best_util = 1, -1.0
    for r in range(1, group + 1):
        if group % r:
            continue
        kvh = num_kv_heads * r
        util = kvh / (math.ceil(kvh / axis_size) * axis_size)
        if util > best_util + 1e-9:
            best_r, best_util = r, util
        if util >= 1.0:
            break  # smallest perfectly-divisible r
    return best_r


# ---------------------------------------------------------------------------
# attention (reference, query-chunked)
# ---------------------------------------------------------------------------


def _causal_chunk_attn(q_chunk, k, v, q_start: int, window: int, shd=None):
    """q_chunk: (B, C, H, G, hd) grouped query; k/v: (B, S, H, hd).

    Masked softmax over keys [0, S) with a causal (+ optional sliding
    window) mask relative to absolute query positions q_start..q_start+C.
    ``shd`` (``models.sharding.ShardingCtx``) places the query chunk and
    the (B, H, G, C, S) scores and probabilities, as in the reference.
    """
    B, C, H, G, hd = q_chunk.shape
    S = k.shape[1]
    if shd is not None:
        q_chunk = shd.q_rep(q_chunk)
    # fp32 operands: the reference contracts bf16 with an fp32 accumulator
    scores = torch.einsum("bchgd,bshd->bhgcs", q_chunk.float(),
                          k.float()) / math.sqrt(hd)
    qpos = q_start + torch.arange(C, device=k.device)[:, None]  # (C, 1)
    kpos = torch.arange(S, device=k.device)[None, :]  # (1, S)
    mask = kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    scores = scores.masked_fill(~mask[None, None, None], NEG_INF)
    if shd is not None:
        scores = shd.scores(scores)
    probs = torch.softmax(scores, dim=-1)
    if shd is not None:
        probs = shd.scores(probs)
    return torch.einsum("bhgcs,bshd->bchgd", probs.to(v.dtype), v)


def causal_attention(q, k, v, *, chunk: int, window: int = 0, shd=None):
    """Reference causal attention with GQA, looped over query chunks.

    q: (B, S, Hq, hd); k, v: (B, S, KVH, hd).  Returns (B, S, Hq, hd).
    Non-divisible S is zero-padded on the query side (outputs sliced off).

    When KVH does not divide the model axis (``shd``), K/V are expanded to
    MHA so the score tensors shard cleanly on the head dim, as in the
    reference.
    """
    B, S, Hq, hd = q.shape
    KVH = k.shape[2]
    if shd is not None:
        if shd.seq_shard:
            k, v = shd.kv_seq(k), shd.kv_seq(v)
        elif KVH % shd.msize != 0 and Hq % shd.msize == 0 and Hq != KVH:
            rep = Hq // KVH
            k = torch.repeat_interleave(k, rep, dim=2)
            v = torch.repeat_interleave(v, rep, dim=2)
            KVH = Hq
    if isinstance(q, DTensor):
        out = on_head_shards(lambda *t: causal_attention(
            *t, chunk=chunk, window=window), q, k, v)
        if out is not None:
            return out
    G = Hq // KVH
    chunk = min(chunk, S)
    Sp = -(-S // chunk) * chunk
    qg = reshape(q, B, S, KVH, G, hd)
    if Sp != S:
        qg = torch.nn.functional.pad(qg, (0, 0, 0, 0, 0, 0, 0, Sp - S))
    outs = [_causal_chunk_attn(qg[:, i:i + chunk], k, v, i, window, shd)
            for i in range(0, Sp, chunk)]
    out = reshape(torch.cat(outs, dim=1), B, Sp, Hq, hd)
    return out[:, :S]


def bidir_attention(q, k, v, chunk: int):
    """Non-causal full attention, query-chunked (the reference's
    ``encdec.bidir_attention``).  q: (B, Sq, H, hd); k, v: (B, Sk, H, hd),
    Sk may differ from Sq (cross-attention).  Returns (B, Sq, H, hd)."""
    if isinstance(q, DTensor):
        out = on_head_shards(lambda *t: bidir_attention(*t, chunk), q, k, v)
        if out is not None:
            return out
    B, S, H, hd = q.shape
    chunk = min(chunk, S)
    outs = []
    for i in range(0, S, chunk):
        # fp32 operands: the reference contracts with an fp32 accumulator
        s = torch.einsum("bchd,bshd->bhcs", q[:, i:i + chunk].float(),
                         k.float()) / math.sqrt(hd)
        pr = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhcs,bshd->bchd", pr.to(v.dtype), v))
    return torch.cat(outs, dim=1)


def decode_attention(q, k_cache, v_cache, kv_len, *, window: int = 0,
                     kv_chunk: int = 0):
    """One-token attention over a (dequantized) KV cache.

    q: (B, 1, Hq, hd); caches: (B, S, KVH, hd); kv_len: (B,) valid lengths.
    ``kv_chunk`` > 0 loops over KV blocks with an online softmax
    (flash-style): score tensors never grow beyond one block.
    """
    if isinstance(q, DTensor):  # on each device's rows and heads
        try:
            pl, mesh, local = head_shards(q, k_cache, v_cache)
        except NotImplementedError:
            pl = None
        if pl is not None:
            lens = local_as(kv_len, project(pl, {0: 0}), mesh)
            out = decode_attention(*local, lens, window=window,
                                   kv_chunk=kv_chunk)
            return DTensor.from_local(out, mesh, pl, run_check=False)
    B, _, Hq, hd = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    G = Hq // KVH
    qg = reshape(q, B, KVH, G, hd).float()
    kv_len = kv_len.to(q.device)
    if kv_chunk and S > kv_chunk and S % kv_chunk == 0:
        m = torch.full((B, KVH, G), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, KVH, G), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, KVH, G, hd), dtype=torch.float32,
                          device=q.device)
        for i in range(S // kv_chunk):
            kb = k_cache[:, i * kv_chunk:(i + 1) * kv_chunk]
            vb = v_cache[:, i * kv_chunk:(i + 1) * kv_chunk]
            s = torch.einsum("bhgd,bshd->bhgs", qg, kb.float()) / math.sqrt(hd)
            kpos = i * kv_chunk + torch.arange(kv_chunk, device=q.device)[None]
            mask = kpos < kv_len[:, None]
            if window:
                mask &= kpos >= torch.clamp(kv_len[:, None] - window, min=0)
            s = s.masked_fill(~mask[:, None, None], NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgs,bshd->bhgd", p.to(vb.dtype), vb).float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        return out.reshape(B, 1, Hq, hd).to(q.dtype)
    scores = torch.einsum("bhgd,bshd->bhgs", qg,
                          k_cache.float()) / math.sqrt(hd)
    kpos = torch.arange(S, device=q.device)[None, :]  # (1, S)
    mask = kpos < kv_len[:, None]
    if window:
        mask &= kpos >= torch.clamp(kv_len[:, None] - window, min=0)
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, Hq, hd)


# ---------------------------------------------------------------------------
# KV cache (dense ring buffer; int8 quantization option)
# ---------------------------------------------------------------------------


def quantize_kv(x: torch.Tensor):
    """Per-(token, head) symmetric int8.  x: (..., hd).  Returns (codes
    int8, scale fp32 (..., 1))."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_kv_cache(cfg: ModelConfig, num_layers: int, batch: int,
                  max_len: int, kv_heads: int, *,
                  dtype: torch.dtype = COMPUTE_DTYPE, device=None) -> dict:
    """Zeroed stacked cache: ``k``/``v`` (L, B, S, KVH, hd) in ``dtype``,
    or int8 codes with fp32 ``k_scale``/``v_scale`` (L, B, S, KVH, 1);
    S is ``max_len``, at most the sliding window."""
    hd = cfg.resolved_head_dim
    if cfg.sliding_window:
        max_len = min(max_len, cfg.sliding_window)
    shape = (num_layers, batch, max_len, kv_heads, hd)
    if cfg.kv_cache_dtype == "int8":
        z = torch.zeros(shape, dtype=torch.int8, device=device)
        s = torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=device)
        return {"k": z, "v": z.clone(), "k_scale": s, "v_scale": s.clone()}
    z = torch.zeros(shape, dtype=dtype, device=device)
    return {"k": z, "v": z.clone()}


def _kv_entries(cfg: ModelConfig, k_new, v_new) -> dict:
    """The cache entries of new K/V: int8 codes and scales, or K/V as they
    are (cast to the cache's dtype by the writer)."""
    if cfg.kv_cache_dtype == "int8":
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return {"k": k_new, "v": v_new}


def cache_insert(cache_layer: dict, k_new, v_new, positions,
                 cfg: ModelConfig) -> dict:
    """Insert new K/V at per-sequence positions (ring buffer for SWA) into
    a new cache dict; writes at or past the cache's end are dropped.

    cache_layer entries: (B, S, KVH, hd) [+ scales]; k_new: (B, T, KVH, hd);
    positions: (B,) absolute write position of the first new token.
    """
    S = cache_layer["k"].shape[1]
    B, T = k_new.shape[:2]
    dev = cache_layer["k"].device
    slots = positions.to(dev).long()[:, None] + torch.arange(T, device=dev)
    if cfg.sliding_window:
        slots = slots % S  # ring buffer
    # dropped writes land in one spare slot past the end, cut off after
    slots = torch.where(slots < S, slots, S)
    rows = torch.arange(B, device=dev)[:, None]
    out = dict(cache_layer)
    for name, val in _kv_entries(cfg, k_new, v_new).items():
        buf = cache_layer[name]
        ext = torch.cat([buf, buf[:, :1]], dim=1)
        ext[rows, slots] = val.to(buf.dtype)
        out[name] = ext[:, :S]
    return out


def _prefill_cache_len(cfg: ModelConfig, S: int, max_len=None) -> int:
    cache_len = max_len or S
    if cfg.sliding_window:
        cache_len = min(cache_len, max(cfg.sliding_window, 1))
        cache_len = max(cache_len, min(S, cfg.sliding_window))
    return cache_len


def finalize_prefill_cache(k, v, cfg: ModelConfig, max_len=None,
                           seq_axis: int = 1) -> dict:
    """Turn full-sequence prefill K/V into a decode cache.

    - sliding window: keep the last W tokens at ring slots pos % cache_len;
    - otherwise pad the seq axis up to ``max_len`` (decode growth budget).
    Returns a cache dict (quantized if configured), K/V in k's dtype.
    """
    S = k.shape[seq_axis]
    cache_len = _prefill_cache_len(cfg, S, max_len)
    if cfg.sliding_window and S > cache_len:
        # last cache_len tokens land at slots pos % cache_len (static perm)
        slots = torch.arange(S - cache_len, S) % cache_len
        inv = torch.argsort(slots).to(k.device)
        k = k.narrow(seq_axis, S - cache_len, cache_len).index_select(
            seq_axis, inv)
        v = v.narrow(seq_axis, S - cache_len, cache_len).index_select(
            seq_axis, inv)
    elif cache_len > S:
        pad = [0, 0] * (k.dim() - 1 - seq_axis) + [0, cache_len - S]
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    return _kv_entries(cfg, k, v)


def cache_kv_arrays(cache_layer: dict, cfg: ModelConfig,
                    compute_dtype: torch.dtype = COMPUTE_DTYPE):
    """One layer's K/V as attention reads them (int8 dequantized to
    ``compute_dtype``)."""
    if cfg.kv_cache_dtype == "int8":
        k = dequantize_kv(cache_layer["k"], cache_layer["k_scale"])
        v = dequantize_kv(cache_layer["v"], cache_layer["v_scale"])
        return k.to(compute_dtype), v.to(compute_dtype)
    return cache_layer["k"], cache_layer["v"]


# --- in-place decode-cache access (one-token writes into the stacked cache,
# never whole-layer rewrites) ---


def cache_insert_layer(cache: dict, layer_idx: int, k_new, v_new, positions,
                       cfg: ModelConfig) -> dict:
    """Write one new token into the stacked cache at (layer_idx, b, slot),
    in place; a write at or past the cache's end is dropped.

    cache entries: (L, B, S, KVH, hd) [+ scales]; k_new/v_new: (B, 1, KVH, hd);
    positions: (B,) absolute position of the new token.

    A DTensor cache is written on each device's shard, in place, with the
    new entries and positions placed as the shard's rows and heads are.
    """
    S = cache["k"].shape[2]
    for name, val in _kv_entries(cfg, k_new, v_new).items():
        buf, pos = cache[name], positions
        if isinstance(buf, DTensor):
            pl, mesh = buf.placements, buf.device_mesh
            if any(isinstance(p, Shard) and p.dim in (0, 2) for p in pl):
                raise NotImplementedError(
                    f"a cache sharded over its layers or slots ({pl})")
            val = local_as(val, project(pl, {1: 0, 3: 2, 4: 3}), mesh)
            pos = local_as(positions, project(pl, {1: 0}), mesh)
            buf = buf.to_local()
        _write_token(buf[layer_idx], val, pos, S, cfg)
    return cache


def write_state(buf, idx: tuple, val) -> None:
    """``buf[idx] = val`` in place, ``idx`` indexing leading dims (a
    recurrent state's slot).  A DTensor ``buf`` is written on each
    device's shard, ``val`` placed as ``buf``'s remaining dims are."""
    if isinstance(buf, DTensor):
        n, pl = len(idx), buf.placements
        if any(isinstance(p, Shard) and p.dim < n for p in pl):
            raise NotImplementedError(f"a state sharded over its slots ({pl})")
        val = local_as(val, project(pl, {d: d - n for d in range(n, buf.dim())}),
                       buf.device_mesh)
        buf = buf.to_local()
    buf[idx] = val


def _write_token(buf, val, positions, S: int, cfg: ModelConfig) -> None:
    """buf (B, S, ...) <- val (B, 1, ...) at slot ``positions`` (B,) (mod S
    under a window), in place; a write at or past S is dropped."""
    B = val.shape[0]
    dev = buf.device
    slots = positions.to(dev).long()
    if cfg.sliding_window:
        slots = slots % S
    keep = slots < S
    slots = torch.clamp(slots, max=S - 1)  # a dropped write rewrites itself
    rows = torch.arange(B, device=dev)
    old = buf[rows, slots]
    mask = keep.reshape((B,) + (1,) * (old.dim() - 1))
    buf[rows, slots] = torch.where(mask, val[:, 0].to(buf.dtype), old)


def cache_layer_arrays(cache: dict, layer_idx: int, cfg: ModelConfig,
                       compute_dtype: torch.dtype = COMPUTE_DTYPE):
    """Layer ``layer_idx``'s K/V (a dequantized copy for int8, else views)
    from the stacked cache."""
    return cache_kv_arrays({k: v[layer_idx] for k, v in cache.items()}, cfg,
                           compute_dtype)


# ---------------------------------------------------------------------------
# MLP pieces
# ---------------------------------------------------------------------------


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def swiglu(x, w_gate, w_up, w_down):
    h = torch.nn.functional.silu(x @ w_gate.to(x.dtype))
    h = h * (x @ w_up.to(x.dtype))
    return h @ w_down.to(x.dtype)


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    h = gelu(x @ w_in.to(x.dtype) + b_in.to(x.dtype))
    return h @ w_out.to(x.dtype) + b_out.to(x.dtype)
