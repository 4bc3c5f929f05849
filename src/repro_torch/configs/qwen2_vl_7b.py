"""qwen2-vl-7b — VLM backbone (M-RoPE, dynamic resolution frontend is a STUB).

[arXiv:2409.12191; hf] 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-vl-7b",
        family="dense",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24),  # t/h/w sections over head_dim/2 = 64
        num_visual_tokens=1024,  # stub: precomputed patch embeddings
        supports_long_context=False,  # full attention -> skip long_500k
        source="arXiv:2409.12191; hf",
    ),
    reduced=ModelConfig(
        name="qwen2-vl-7b-reduced",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        qkv_bias=True,
        mrope_sections=(4, 2, 2),
        num_visual_tokens=8,
        attn_chunk=16,
    ),
)
