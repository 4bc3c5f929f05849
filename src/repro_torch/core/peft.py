"""Parameter-efficient fine-tuning deltas (paper Table 1 / Fig. 4) — the
port of ``repro.core.peft``.

LoRA (q,v projections), Adapter (bottleneck after FFN), BitFit (qkv bias
deltas).  Each returns per-layer adapter parameter dicts (fp32 tensors on
the generator's device) that the block zoo stores as tiny adapter blocks.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.blocks import tree_leaves
from repro_torch.models import layers as L


def create_lora(cfg: ModelConfig, gen: torch.Generator, rank: int = 8,
                scaling: float = 1.0):
    """Per-layer LoRA on wq/wv, B matrices at zero.  Returns a list of
    param dicts (len L)."""
    hd = cfg.resolved_head_dim
    dev = gen.device
    return [{
        "a_q": L.dense_init(gen, (cfg.d_model, rank)),
        "b_q": torch.zeros((rank, cfg.num_heads * hd), dtype=torch.float32,
                           device=dev),
        "a_v": L.dense_init(gen, (cfg.d_model, rank)),
        "b_v": torch.zeros((rank, cfg.num_kv_heads * hd), dtype=torch.float32,
                           device=dev),
        "scaling": torch.tensor(scaling, dtype=torch.float32, device=dev),
    } for _ in range(cfg.num_layers)]


def create_adapter(cfg: ModelConfig, gen: torch.Generator,
                   bottleneck: int = 32):
    return [{
        "down": L.dense_init(gen, (cfg.d_model, bottleneck)),
        "up": 1e-3 * L.dense_init(gen, (bottleneck, cfg.d_model),
                                  in_axis_size=bottleneck),
    } for _ in range(cfg.num_layers)]


def create_bitfit(cfg: ModelConfig, gen: torch.Generator,
                  init_scale: float = 1e-3):
    hd = cfg.resolved_head_dim

    def normal(shape):
        return init_scale * torch.randn(shape, generator=gen,
                                        dtype=torch.float32, device=gen.device)

    return [{
        "bq": normal((cfg.num_heads, hd)),
        "bk": normal((cfg.num_kv_heads, hd)),
        "bv": normal((cfg.num_kv_heads, hd)),
    } for _ in range(cfg.num_layers)]


def _size(leaf) -> int:
    return leaf.numel() if isinstance(leaf, torch.Tensor) else leaf.size


def shared_param_fraction(foundation_params, adapter_trees) -> float:
    """Paper Table 1: % of a fine-tuned model's params shared with the
    foundation (foundation / (foundation + adapters)), counted in elements
    of torch (or numpy) trees."""
    base = sum(_size(x) for x in tree_leaves(foundation_params))
    extra = sum(_size(x) for x in tree_leaves(adapter_trees))
    return base / (base + extra)
