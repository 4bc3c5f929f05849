"""Dense decoder-only transformer pieces (llama family) in PyTorch — the port
of the parts of ``repro.models.transformer`` the serving path needs.

Parameters are dicts of fp32 tensors in the reference's layouts:
``wq (D,H,hd)``, ``wk``/``wv (D,KVH,hd)``, ``wo (H,hd,D)``,
``w_gate``/``w_up (D,F)``, ``w_down (F,D)``, ``embed (V,D)``,
``lm_head (D,V)``; ``init_dense`` stacks the layers on a leading axis.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_dense_layer(cfg: ModelConfig, gen: torch.Generator) -> dict:
    hd = cfg.resolved_head_dim
    D, F, H, KVH = cfg.d_model, cfg.d_ff, cfg.num_heads, cfg.num_kv_heads
    dev = gen.device
    p = {
        "ln1": torch.ones((D,), dtype=torch.float32, device=dev),
        "ln2": torch.ones((D,), dtype=torch.float32, device=dev),
        "wq": L.dense_init(gen, (D, H, hd)),
        "wk": L.dense_init(gen, (D, KVH, hd)),
        "wv": L.dense_init(gen, (D, KVH, hd)),
        "wo": L.dense_init(gen, (H, hd, D), in_axis_size=H * hd),
        "w_gate": L.dense_init(gen, (D, F)),
        "w_up": L.dense_init(gen, (D, F)),
        "w_down": L.dense_init(gen, (F, D), in_axis_size=F),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, hd), dtype=torch.float32, device=dev)
        p["bk"] = torch.zeros((KVH, hd), dtype=torch.float32, device=dev)
        p["bv"] = torch.zeros((KVH, hd), dtype=torch.float32, device=dev)
    return p


def init_dense(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random fp32 parameters drawn from ``gen`` on ``gen``'s device; layers
    stacked on a leading (L, ...) axis as in the reference."""
    embed = L.dense_init(gen, (cfg.vocab_size, cfg.d_model),
                         in_axis_size=cfg.d_model)
    per_layer = [init_dense_layer(cfg, gen) for _ in range(cfg.num_layers)]
    layers = {k: torch.stack([p[k] for p in per_layer])
              for k in per_layer[0]}
    del per_layer
    return {
        "embed": embed,
        "layers": layers,
        "final_ln": torch.ones((cfg.d_model,), dtype=torch.float32,
                               device=gen.device),
        "lm_head": L.dense_init(gen, (cfg.d_model, cfg.vocab_size)),
    }


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def _mlp_layer(x: torch.Tensor, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU MLP sublayer with its residual: x + W_down(silu(W_g h) * W_u h),
    h = rms_norm(x).  Weights are cast to the activation dtype at use (a
    no-op when the caller hands in weights already cast)."""
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    g = torch.nn.functional.silu(h @ p["w_gate"].to(h.dtype))
    u = h @ p["w_up"].to(h.dtype)
    o = (g * u) @ p["w_down"].to(h.dtype)
    return x + o
