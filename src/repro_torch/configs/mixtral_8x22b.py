"""mixtral-8x22b — MoE 8 experts top-2, sliding-window attention.

[arXiv:2401.04088; hf] 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768.
SWA makes decode KV bounded -> runs long_500k with a rolling-buffer cache.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        num_layers=56,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=16384,
        vocab_size=32768,
        num_experts=8,
        num_experts_per_tok=2,
        sliding_window=4096,
        rope_theta=1_000_000.0,
        supports_long_context=True,  # SWA: O(window) decode KV
        source="arXiv:2401.04088; hf",
    ),
    reduced=ModelConfig(
        name="mixtral-8x22b-reduced",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        num_experts=4,
        num_experts_per_tok=2,
        sliding_window=32,
        supports_long_context=True,
        attn_chunk=16,
    ),
)
