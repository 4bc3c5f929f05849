"""blockllm-demo — the paper's own evaluation family at laptop scale.

The paper serves LLaMA-family foundations (7B/13B) plus FPFT (Vicuna) and
PEFT (LoRA/Adapter/BitFit/Prefix) variants.  This config is the llama-style
foundation used by the serving demo, examples and benchmarks; two embedding
sizes exercise the stitching-block path (paper §4.3).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="blockllm-demo",
        family="dense",
        num_layers=4,
        d_model=256,
        num_heads=8,
        num_kv_heads=4,
        d_ff=688,
        vocab_size=512,
        attn_chunk=64,
        source="paper §7.1 (llama-family), reduced for CPU",
    ),
    reduced=ModelConfig(
        name="blockllm-demo-reduced",
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

# A second foundation with a different embedding size (paper Fig. 9/10:
# 7B vs 13B LLaMA) for equivalence-across-sizes + stitching experiments.
CONFIG_LARGE = register(
    ModelConfig(
        name="blockllm-demo-large",
        family="dense",
        num_layers=6,
        d_model=384,
        num_heads=8,
        num_kv_heads=4,
        d_ff=1024,
        vocab_size=512,
        attn_chunk=64,
        source="paper §7.1 (llama-family, larger embed), reduced for CPU",
    ),
    reduced=ModelConfig(
        name="blockllm-demo-large-reduced",
        family="dense",
        num_layers=2,
        d_model=96,
        num_heads=4,
        num_kv_heads=2,
        d_ff=192,
        vocab_size=256,
        attn_chunk=16,
    ),
)
