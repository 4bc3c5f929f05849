"""zamba2-2.7b — Mamba2 backbone + shared attention blocks (hybrid).

[arXiv:2411.15242; hf] 54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000,
ssm_state=64.  A single shared transformer block is re-applied every
``shared_attn_every`` mamba layers — the arch itself is a demonstration of
BlockLLM-style block reuse (DESIGN.md §4).  Decode state is O(1) -> long_500k.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        d_ff=10240,
        vocab_size=32000,
        ssm_state=64,
        ssm_head_dim=64,
        ssm_expand=2,
        shared_attn_every=6,  # 9 applications of the shared block
        sliding_window=4096,  # bounded attention KV for long-context decode
        supports_long_context=True,
        source="arXiv:2411.15242; hf",
    ),
    reduced=ModelConfig(
        name="zamba2-2.7b-reduced",
        family="hybrid",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_expand=2,
        ssm_chunk=8,
        shared_attn_every=2,
        sliding_window=32,
        supports_long_context=True,
        attn_chunk=16,
    ),
)
