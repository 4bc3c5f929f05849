"""Stitching blocks (paper §4.3) in PyTorch — the port of
``repro.core.stitching``: a generalizable Linear(d1+1 -> d2) that routes
requests between equivalent blocks of different embedding sizes.

The +1 input dimension carries the *position value* of the stitching point
(sum of head/tail positions in the original chains), making one stitch
generalize across stitch points.  Training keeps every other block frozen
and regresses the large model's hidden state at the matched depth,
progressively moving from shallow to deep stitch points (§4.3), with the
reference's hand-written Adam on ``w`` alone (gradients from
``torch.autograd``): an offline zoo-building regression on one matrix.

The models' layers run through ``models.transformer`` with its
``attn_impl`` routes: the flash-attention kernel on the card.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.blocks import Block, tree_hash
from repro_torch.core.equivalence import vocab_probability_similarity
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def _hidden_at_layer(params, cfg, tokens, upto: int, *,
                     attn_impl: str = "auto",
                     compute_dtype: torch.dtype = L.COMPUTE_DTYPE):
    """Hidden states (B, S, D) after the first ``upto`` layers of a full
    unpadded sequence."""
    tokens = torch.as_tensor(tokens, device=params["embed"].device)
    h = T._embed_tokens(params, cfg, {"tokens": tokens}, compute_dtype)
    B, S = tokens.shape
    positions = T._positions(cfg, {}, B, S, h.device)
    for i in range(upto):
        h = T._dense_layer_fwd(h, T._layer_params(params, i, compute_dtype),
                               cfg, positions, attn_impl)
    return h


def apply_stitch(w, h, position_value: float):
    B, S, D = h.shape
    posval = torch.full((B, S, 1), position_value, dtype=h.dtype,
                        device=h.device)
    return torch.cat([h, posval], dim=-1) @ w.to(h.dtype)


def train_stitching_block(
        params_a, cfg_a: ModelConfig, params_b, cfg_b: ModelConfig,
        stitch_points: List[Tuple[int, int]], tokens, *,
        steps_per_point: int = 120, lr: float = 1e-2,
        w_init: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        attn_impl: str = "auto",
        compute_dtype: torch.dtype = L.COMPUTE_DTYPE):
    """Train W: (d_a + 1, d_b) matching model B's hidden at matched depths.

    stitch_points: (layer_in_A, layer_in_B) pairs, shallow -> deep
    (progressive schedule per §4.3).  W starts at ``w_init`` when given,
    else at the truncated-normal fan-in init drawn from ``generator``
    (seed 0 by default) on model A's device.  Returns (w, per-point
    losses: each point's last-step loss, before its update)."""
    d_a, d_b = cfg_a.d_model, cfg_b.d_model
    dev = params_a["embed"].device
    if w_init is not None:
        w = torch.as_tensor(w_init, dtype=torch.float32).to(dev).clone()
    else:
        gen = generator or torch.Generator(dev).manual_seed(0)
        w = L.dense_init(gen, (d_a + 1, d_b), device=dev)
    m = torch.zeros_like(w)
    v = torch.zeros_like(w)
    losses = []
    step_count = 0
    kw = dict(attn_impl=attn_impl, compute_dtype=compute_dtype)
    for (la, lb) in stitch_points:
        with torch.no_grad():
            h_a = _hidden_at_layer(params_a, cfg_a, tokens, la, **kw)
            h_b = _hidden_at_layer(params_b, cfg_b, tokens, lb, **kw).float()
        pos_value = float(la + lb)
        for _ in range(steps_per_point):
            step_count += 1
            w.requires_grad_(True)
            pred = apply_stitch(w, h_a, pos_value)
            loss = torch.mean(torch.square(pred.float() - h_b))
            (g,) = torch.autograd.grad(loss, (w,))
            with torch.no_grad():
                m = 0.9 * m + 0.1 * g
                v = 0.999 * v + 0.001 * torch.square(g)
                mh = m / (1 - 0.9 ** step_count)
                vh = v / (1 - 0.999 ** step_count)
                w = w - lr * mh / (torch.sqrt(vh) + 1e-8)
        losses.append(float(loss.detach()))
    return w.detach(), losses


def make_stitch_block(w, model_a: str, model_b: str, d_a: int, d_b: int,
                      position_value: float) -> Block:
    params = {"w": w}
    return Block(id=f"st-{tree_hash(params)}", kind="stitch",
                 model=f"{model_a}->{model_b}", layer_idx=None,
                 d_in=d_a, d_out=d_b, params=params, cfg=None,
                 meta={"position_value": position_value})


def stitched_head_similarity(params_a, cfg_a, params_b, cfg_b, w,
                             stitch_point: Tuple[int, int], tokens, *,
                             attn_impl: str = "auto",
                             compute_dtype: torch.dtype = L.COMPUTE_DTYPE
                             ) -> float:
    """Paper Table 3: LM-head cosine similarity of the stitched model vs the
    large model."""
    la, lb = stitch_point
    kw = dict(attn_impl=attn_impl, compute_dtype=compute_dtype)
    with torch.no_grad():
        h_a = _hidden_at_layer(params_a, cfg_a, tokens, la, **kw)
        h = apply_stitch(w, h_a, float(la + lb))
        B, S = h.shape[:2]
        positions = torch.arange(S, device=h.device)[None].expand(B, S)
        for i in range(lb, cfg_b.num_layers):
            h = T._dense_layer_fwd(
                h, T._layer_params(params_b, i, compute_dtype), cfg_b,
                positions, attn_impl)
        probs = torch.softmax(T._logits(params_b, cfg_b, h).float(), -1)
        h_ref = _hidden_at_layer(params_b, cfg_b, tokens, cfg_b.num_layers,
                                 **kw)
        ref_probs = torch.softmax(T._logits(params_b, cfg_b, h_ref).float(),
                                  -1)
    return vocab_probability_similarity(probs, ref_probs)
