"""Frozen yardstick: the H100's published peaks and the operations and
bytes that the served work needs, counted from the tokens and context
lengths a window served (never from what a kernel happens to read).

Every input byte is counted as read once and every output byte as written
once, per the least work the traffic needs: a kernel that reads a weight
twice, or pads a prompt to a bucket, is slower against the same count.
Arithmetic follows ``chip_smoke.bound`` / ``peak_bound``.
"""
from __future__ import annotations

from typing import Iterable, Tuple

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12
BF16 = 2  # bytes


def least_seconds(flops: float, nbytes: float) -> float:
    """The larger of operations over peak and bytes over bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_S)


def paged_decode(d: dict, keys: int) -> Tuple[float, float]:
    """One decode token's paged attention over ``keys`` cached positions
    (its own included), all layers: QK and PV, K/V read once, q read, the
    output and the new token's K/V written."""
    H, KVH, hd, L = d["H"], d["KVH"], d["hd"], d["L"]
    flops = 4.0 * H * hd * keys * L
    nbytes = (2 * keys * KVH * hd + 2 * H * hd + 2 * KVH * hd) * BF16 * L
    return flops, nbytes


def flash_prefill(d: dict, S: int) -> Tuple[float, float]:
    """Causal attention over one prompt of ``S`` tokens, all layers: S(S+1)/2
    query-key pairs; q, k, v read once and o written once."""
    H, KVH, hd, L = d["H"], d["KVH"], d["hd"], d["L"]
    pairs = S * (S + 1) / 2
    flops = 4.0 * H * hd * pairs * L
    nbytes = (2 * S * H * hd + 2 * S * KVH * hd) * BF16 * L
    return flops, nbytes


def lora_qv(d: dict, rank: int, tokens: int, weight_reads: int
            ) -> Tuple[float, float]:
    """The LoRA app's q and v projections with their low-rank deltas
    (what the batched-LoRA kernel computes), all layers: ``tokens`` rows,
    the weights read ``weight_reads`` times (once per engine step that
    served the app)."""
    D, H, KVH, hd, L = d["D"], d["H"], d["KVH"], d["hd"], d["L"]
    flops = nbytes = 0.0
    for n in (H * hd, KVH * hd):
        flops += 2.0 * tokens * (D * n + rank * (D + n))
        nbytes += (weight_reads * (D * n + rank * (D + n))
                   + tokens * (D + n)) * BF16
    return flops * L, nbytes * L


def dense_layer_params(d: dict) -> int:
    D, H, KVH, hd, F = d["D"], d["H"], d["KVH"], d["hd"], d["F"]
    return D * (H + 2 * KVH) * hd + H * hd * D + 3 * D * F


def token_flops(d: dict, keys: int, lora_rank: int = 0,
                head: bool = True) -> float:
    """Model FLOPs of one token through the dense model: 2 x the weights
    it touches (every layer, and the head when its logits are needed; the
    embedding is a gather), attention over ``keys`` positions, and a LoRA
    app's deltas."""
    D, H, KVH, hd, L, V = (d[k] for k in ("D", "H", "KVH", "hd", "L", "V"))
    f = 2.0 * (L * dense_layer_params(d) + (D * V if head else 0))
    f += 4.0 * H * hd * keys * L
    if lora_rank:
        f += 2.0 * lora_rank * (2 * D + (H + KVH) * hd) * L
    return f


def prompt_flops(d: dict, S: int, lora_rank: int = 0) -> float:
    """Model FLOPs of a prefill of ``S`` tokens (position i attends i + 1
    keys); only the last position's logits are needed."""
    D, H, hd, L, V = (d[k] for k in ("D", "H", "hd", "L", "V"))
    per = token_flops(d, 0, lora_rank, head=False)
    return S * per + 4.0 * H * hd * L * S * (S + 1) / 2 + 2.0 * D * V


def sum_pairs(pairs: Iterable[Tuple[float, float]]) -> Tuple[float, float]:
    f = b = 0.0
    for x, y in pairs:
        f += x
        b += y
    return f, b
