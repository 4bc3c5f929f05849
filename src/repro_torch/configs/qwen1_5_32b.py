"""qwen1.5-32b — dense decoder LM with QKV bias (MHA: kv = heads = 40).

[hf:Qwen/Qwen1.5-0.5B; hf] 64L d_model=5120 40H (GQA kv=40) d_ff=27392
vocab=152064.  MHA KV is fat: decode shapes use int8 KV cache (DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen1.5-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=40,
        d_ff=27392,
        vocab_size=152064,
        qkv_bias=True,
        kv_cache_dtype="int8",
        supports_long_context=False,
        source="hf:Qwen/Qwen1.5-0.5B; hf",
    ),
    reduced=ModelConfig(
        name="qwen1.5-32b-reduced",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        qkv_bias=True,
        kv_cache_dtype="int8",
        attn_chunk=16,
    ),
)
