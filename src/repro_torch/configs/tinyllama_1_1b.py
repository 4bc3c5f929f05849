"""tinyllama-1.1b — llama2-arch small dense LM.

[arXiv:2401.02385; hf] 22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="tinyllama-1.1b",
        family="dense",
        num_layers=22,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        d_ff=5632,
        vocab_size=32000,
        supports_long_context=False,
        source="arXiv:2401.02385; hf",
    ),
    reduced=ModelConfig(
        name="tinyllama-1.1b-reduced",
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
