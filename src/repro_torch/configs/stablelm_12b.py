"""stablelm-12b — dense decoder LM.

[hf:stabilityai/stablelm-2-1_6b; hf] 40L d_model=5120 32H (GQA kv=8)
d_ff=13824 vocab=100352.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="stablelm-12b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        d_ff=13824,
        vocab_size=100352,
        supports_long_context=False,
        source="hf:stabilityai/stablelm-2-1_6b; hf",
    ),
    reduced=ModelConfig(
        name="stablelm-12b-reduced",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        attn_chunk=16,
    ),
)
