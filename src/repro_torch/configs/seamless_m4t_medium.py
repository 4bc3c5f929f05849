"""seamless-m4t-medium — encoder-decoder backbone (audio frontend is a STUB).

[arXiv:2308.11596; hf] 12L d_model=1024 16H d_ff=4096 vocab=256206.
Enc-dec: 12 encoder + 12 decoder layers; speech frontend replaced by
precomputed frame embeddings via input_specs() per the assignment.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="seamless-m4t-medium",
        family="encdec",
        num_layers=24,
        encoder_layers=12,
        decoder_layers=12,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=256206,
        supports_long_context=False,
        source="arXiv:2308.11596; hf",
    ),
    reduced=ModelConfig(
        name="seamless-m4t-medium-reduced",
        family="encdec",
        num_layers=4,
        encoder_layers=2,
        decoder_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        attn_chunk=16,
    ),
)
