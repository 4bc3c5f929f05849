"""dbrx-132b — fine-grained MoE, 16 experts top-4.

[hf:databricks/dbrx-base; unverified] 40L d_model=6144 48H (GQA kv=8)
d_ff=10752 vocab=100352.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="dbrx-132b",
        family="moe",
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=10752,
        vocab_size=100352,
        num_experts=16,
        num_experts_per_tok=4,
        rope_theta=500_000.0,
        supports_long_context=False,  # full attention -> skip long_500k
        source="hf:databricks/dbrx-base; unverified",
    ),
    reduced=ModelConfig(
        name="dbrx-132b-reduced",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=96,
        vocab_size=256,
        num_experts=4,
        num_experts_per_tok=2,
        attn_chunk=16,
    ),
)
