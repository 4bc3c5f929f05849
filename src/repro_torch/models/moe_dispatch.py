"""Capacity-based MoE dispatch (GShard/Switch style) in PyTorch — the port
of ``repro.models.moe_dispatch``.

Instead of the dense all-experts scan (E/k times the compute), each batch
row's tokens go to per-expert capacity slots, ``C = max(1, round(S * k *
capacity_factor / E))`` (Python's ``round``), in token order (a cumulative
sum over the sequence); a token past its expert's capacity is dropped and
that expert contributes zero to it.  ``capacity_factor >= E / k`` makes
dispatch lossless.  The reference's expert-parallel ``moe_impl="ep"`` is a
sharding rule only (``models.sharding.moe_layer_specs``,
``launch.shardings.leaf_spec``): its compute stays the dense expert scan.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


def _capacity(S: int, cfg: ModelConfig) -> int:
    k, E = cfg.num_experts_per_tok, cfg.num_experts
    return max(1, int(round(S * k * cfg.capacity_factor / E)))


def _slots(combine: torch.Tensor):
    """(routed (B, S, E) bool, slot (B, S, E) int64: each routed token's
    position in its expert's queue, per batch row)."""
    gates = combine > 0
    return gates, torch.cumsum(gates.long(), dim=1) - 1


def moe_dispatch_mlp(h, combine, p, cfg: ModelConfig) -> torch.Tensor:
    """h: (B, S, D); combine: (B, S, E) router combine weights (top-k
    softmax, zero elsewhere); p: the layer's ``e_gate``/``e_up`` (E, D, F)
    and ``e_down`` (E, F, D).  Returns (B, S, D) in h's dtype."""
    C = _capacity(h.shape[1], cfg)
    gates, pos = _slots(combine)
    slot = torch.where(gates & (pos < C), pos, C)  # dropped -> overflow slot
    # (B, S, E, C); the rows of dropped tokens are all zero
    dispatch = torch.nn.functional.one_hot(slot, C + 1)[..., :C].to(h.dtype)
    xe = torch.einsum("bsd,bsec->becd", h, dispatch)  # (B, E, C, D)
    g = torch.nn.functional.silu(
        torch.einsum("becd,edf->becf", xe, p["e_gate"].to(h.dtype)))
    u = torch.einsum("becd,edf->becf", xe, p["e_up"].to(h.dtype))
    ye = torch.einsum("becf,efd->becd", g * u, p["e_down"].to(h.dtype))
    # the one-hot slots weighted by the router (exact: one nonzero factor)
    weighted = dispatch * combine.to(h.dtype)[..., None]
    return torch.einsum("becd,bsec->bsd", ye, weighted)


def dropped_fraction(combine, cfg: ModelConfig) -> torch.Tensor:
    """Diagnostic: the fraction of routed (token, expert) pairs beyond
    capacity (a 0-d fp32 tensor)."""
    gates, pos = _slots(combine)
    dropped = gates & (pos >= _capacity(combine.shape[1], cfg))
    return dropped.sum().float() / torch.clamp(gates.sum(), min=1).float()
