"""Block surrogates for speculative execution (paper §5.2, Table 4) in
PyTorch — the port of ``repro.core.surrogates``.

Structured pruning in the spirit of LLM-Pruner [23]: remove the FFN hidden
channels and attention KV-groups with the least output impact, keeping the
block's interface (d_model in/out) intact so the surrogate is a drop-in
predictor.  Fidelity = output cosine similarity on probe data; speedup
estimate = FLOP ratio.

Channel choice is the reference's exactly: importance norms in fp32, a
stable ascending argsort, reversed, the first ``keep`` taken and sorted —
so the same parameters keep the same channels in both packages, and the
surrogate's ``su-{tree_hash}`` id is the reference's.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.blocks import Block, apply_block, tree_hash


def _topk_mask_indices(scores: torch.Tensor, keep: int) -> torch.Tensor:
    """Indices of the ``keep`` largest scores, ascending; ties resolve as
    the reference's reversed stable argsort resolves them (the later index
    first)."""
    idx = torch.argsort(scores, stable=True).flip(0)[:keep]
    return torch.sort(idx).values


def build_surrogate(block: Block, prune_ratio: float = 0.5, *,
                    prune_kv: bool = True) -> Block:
    """Structured-prune a 'layer' (or 'ffn'/'attention') block.

    ``prune_kv=False`` restricts pruning to the FFN channels, leaving the
    attention projections — and therefore the block's ``kv_signature`` —
    untouched.  The serving engine's speculative decode path needs this:
    an FFN-only surrogate reads and writes the *same* paged KV pools and
    page tables as the full block, so drafts need no surrogate-side KV
    management (their pool writes are scratch the verify pass overwrites).
    Unpruned tensors are shared with the parent block, not copied.
    """
    p = dict(block.params)
    cfg = block.cfg
    new_cfg = cfg
    if "w_gate" in p:
        F = p["w_gate"].shape[1]
        keep = max(1, int(round(F * (1.0 - prune_ratio))))
        # channel importance: |gate_in| * |down_out| (LLM-Pruner style)
        imp = (torch.linalg.vector_norm(p["w_gate"].float(), dim=0)
               * torch.linalg.vector_norm(p["w_down"].float(), dim=1))
        idx = _topk_mask_indices(imp, keep)
        p["w_gate"] = p["w_gate"][:, idx]
        p["w_up"] = p["w_up"][:, idx]
        p["w_down"] = p["w_down"][idx, :]
        new_cfg = new_cfg.replace(d_ff=keep)
    if prune_kv and "wq" in p and block.kind in ("layer", "attention"):
        H = p["wq"].shape[1]
        KVH = p["wk"].shape[1]
        G = H // KVH
        keep_kv = max(1, int(round(KVH * (1.0 - prune_ratio))))
        imp = torch.linalg.vector_norm(
            p["wk"].float().reshape(p["wk"].shape[0], KVH, -1), dim=(0, 2))
        kv_idx = _topk_mask_indices(imp, keep_kv).cpu().numpy()
        q_idx = np.concatenate([np.arange(i * G, (i + 1) * G)
                                for i in kv_idx])
        dev = p["wq"].device
        kv_t = torch.as_tensor(kv_idx, device=dev)
        q_t = torch.as_tensor(q_idx, device=dev)
        p["wq"] = p["wq"][:, q_t]
        p["wk"] = p["wk"][:, kv_t]
        p["wv"] = p["wv"][:, kv_t]
        p["wo"] = p["wo"][q_t, :, :]
        new_cfg = new_cfg.replace(num_heads=len(q_idx), num_kv_heads=keep_kv,
                                  head_dim=cfg.resolved_head_dim)
    return Block(id=f"su-{tree_hash(p)}", kind=block.kind, model=block.model,
                 layer_idx=block.layer_idx, d_in=block.d_in,
                 d_out=block.d_out, params=p, cfg=new_cfg,
                 meta={"surrogate_of": block.id, "prune_ratio": prune_ratio})


def surrogate_fidelity(block: Block, surrogate: Block, probe) -> float:
    """Output cosine similarity on probe hidden states (paper Table 4),
    accumulated in float64 on the host as the reference does.  Attention
    follows ``apply_block``'s ``auto`` route: the flash kernel on the
    card, one launch per attention-bearing block."""
    with torch.no_grad():
        out_a = apply_block(block, probe)
        out_b = apply_block(surrogate, probe)
    a = out_a.float().cpu().numpy().astype(np.float64).reshape(-1)
    b = out_b.float().cpu().numpy().astype(np.float64).reshape(-1)
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)
                                 + 1e-12))


def surrogate_speedup(block: Block, surrogate: Block) -> float:
    return block.flops_per_token() / max(surrogate.flops_per_token(), 1.0)


def recover_with_lora(block: Block, surrogate: Block, probe, *,
                      rank: int = 8, steps: int = 100, lr: float = 5e-3,
                      generator: Optional[torch.Generator] = None,
                      a_init=None) -> Block:
    """Post-pruning LoRA recovery (paper §5.2): fit a low-rank correction on
    the surrogate's output to match the full block on probe data, by the
    reference's momentum descent (m = 0.9 m + 0.1 g; p = p - lr m) on
    ``torch.autograd`` gradients.

    ``A`` starts at ``a_init`` (D, rank) when given, else at 0.01 * N(0, 1)
    drawn from ``generator``, or, when neither is given, at the reference's
    draw (the first key of ``split(PRNGKey(0))``, by ``core.prng``); ``B``
    starts at zero."""
    D = block.d_in
    dev = probe.device
    if a_init is not None:
        a = torch.from_numpy(np.array(a_init, np.float32))
    elif generator is not None:
        a = 0.01 * torch.randn(D, rank, generator=generator,
                               device=generator.device)
    else:
        key = prng.split(prng.PRNGKey(0))[0]
        a = torch.from_numpy(np.float32(0.01) * prng.normal(key, (D, rank)))
    a = a.to(device=dev, dtype=torch.float32)
    b = torch.zeros(rank, D, dtype=torch.float32, device=dev)
    with torch.no_grad():
        target = apply_block(block, probe).float()
        base = apply_block(surrogate, probe).float()
    x = probe.float()
    m_a, m_b = torch.zeros_like(a), torch.zeros_like(b)
    for _ in range(steps):
        a.requires_grad_(True)
        b.requires_grad_(True)
        pred = base + (x @ a) @ b
        loss = torch.mean(torch.square(pred - target))
        g_a, g_b = torch.autograd.grad(loss, (a, b))
        with torch.no_grad():
            m_a = 0.9 * m_a + 0.1 * g_a
            m_b = 0.9 * m_b + 0.1 * g_b
            a = a - lr * m_a
            b = b - lr * m_b
    p = dict(surrogate.params)
    p["recover_a"], p["recover_b"] = a.detach(), b.detach()
    return Block(id=f"su-{tree_hash(p)}", kind=surrogate.kind,
                 model=surrogate.model, layer_idx=surrogate.layer_idx,
                 d_in=surrogate.d_in, d_out=surrogate.d_out, params=p,
                 cfg=surrogate.cfg, meta=dict(surrogate.meta, recovered=True))
