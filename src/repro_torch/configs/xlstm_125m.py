"""xlstm-125m — alternating sLSTM + mLSTM blocks (recurrent; no KV cache).

[arXiv:2405.04517; unverified] 12L d_model=768 4H d_ff=0 vocab=50304.
d_ff=0: blocks carry their own projection factors (mLSTM pf=2, sLSTM ffn
pf=4/3) per the xLSTM paper.  O(1) decode state -> long_500k.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="xlstm-125m",
        family="ssm",
        num_layers=12,
        d_model=768,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        supports_long_context=True,
        source="arXiv:2405.04517; unverified",
    ),
    reduced=ModelConfig(
        name="xlstm-125m-reduced",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=256,
        supports_long_context=True,
        attn_chunk=16,
    ),
)
