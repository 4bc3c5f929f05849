"""Shared neural-net layers in PyTorch (fp32 params, bf16 compute) — the
port of ``repro.models.layers`` that the serving path needs.

The compute dtype is an explicit argument wherever it is chosen (the embed
cast, the KV pools), never read from the environment, so a caller picks
fp32 for tight comparisons without depending on import order.  Every other
function computes in the dtype of its input, as the reference does.

Where the reference contracts with ``preferred_element_type=float32``
(attention scores), the operands are up-cast to fp32 before the product so
the sum is never rounded to bf16.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

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
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    out = torch.empty(shape, dtype=torch.float32,
                      device=device if device is not None else gen.device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return out.mul_(std)


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


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Tuple[int, ...] = ()) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) integer.  Rotates split halves in
    fp32 and casts back to x's dtype."""
    if mrope_sections:
        raise NotImplementedError("M-RoPE is not part of the PyTorch port")
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, device=x.device)  # (hd/2,)
    ang = positions.float()[..., None] * inv[None, None, :]  # (B, S, hd/2)
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (reference, query-chunked)
# ---------------------------------------------------------------------------


def _causal_chunk_attn(q_chunk, k, v, q_start: int, window: int):
    """q_chunk: (B, C, H, G, hd) grouped query; k/v: (B, S, H, hd).

    Masked softmax over keys [0, S) with a causal (+ optional sliding
    window) mask relative to absolute query positions q_start..q_start+C.
    """
    B, C, H, G, hd = q_chunk.shape
    S = k.shape[1]
    # fp32 operands: the reference contracts bf16 with an fp32 accumulator
    scores = torch.einsum("bchgd,bshd->bhgcs", q_chunk.float(),
                          k.float()) / math.sqrt(hd)
    qpos = q_start + torch.arange(C, device=k.device)[:, None]  # (C, 1)
    kpos = torch.arange(S, device=k.device)[None, :]  # (1, S)
    mask = kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    scores = scores.masked_fill(~mask[None, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgcs,bshd->bchgd", probs.to(v.dtype), v)


def causal_attention(q, k, v, *, chunk: int, window: int = 0):
    """Reference causal attention with GQA, looped over query chunks.

    q: (B, S, Hq, hd); k, v: (B, S, KVH, hd).  Returns (B, S, Hq, hd).
    Non-divisible S is zero-padded on the query side (outputs sliced off).
    """
    B, S, Hq, hd = q.shape
    KVH = k.shape[2]
    G = Hq // KVH
    chunk = min(chunk, S)
    Sp = -(-S // chunk) * chunk
    qg = q.reshape(B, S, KVH, G, hd)
    if Sp != S:
        qg = torch.nn.functional.pad(qg, (0, 0, 0, 0, 0, 0, 0, Sp - S))
    outs = [_causal_chunk_attn(qg[:, i:i + chunk], k, v, i, window)
            for i in range(0, Sp, chunk)]
    out = torch.cat(outs, dim=1).reshape(B, Sp, Hq, hd)
    return out[:, :S]


# ---------------------------------------------------------------------------
# MLP pieces
# ---------------------------------------------------------------------------


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return torch.nn.functional.gelu(x, approximate="tanh")
