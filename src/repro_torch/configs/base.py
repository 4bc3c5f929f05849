"""Model architecture configs — a copy of ``repro.configs.base`` kept inside
the PyTorch port (the port imports nothing of ``repro``).

Only the fields and the registry are copied; the JAX package's shape table
and parameter counting (which builds a JAX model) are not part of the port.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_impl: str = "dense"  # "dense" (scan all experts) | "dispatch" (capacity EP)
    capacity_factor: float = 1.25

    # --- attention flavour ---
    sliding_window: int = 0  # 0 = full causal attention
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()  # M-RoPE (qwen2-vl): freq sections t/h/w

    # --- hybrid / ssm ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    shared_attn_every: int = 0  # zamba2: shared attention block period

    # --- enc-dec ---
    encoder_layers: int = 0
    decoder_layers: int = 0

    # --- vlm ---
    num_visual_tokens: int = 0  # stub frontend: precomputed patch embeds

    # --- numerics / serving ---
    norm_eps: float = 1e-5
    kv_cache_dtype: str = "bf16"  # "bf16" | "int8"
    attn_chunk: int = 512  # query-chunked reference attention
    supports_long_context: bool = False  # sub-quadratic decode state
    use_flash_kernel: bool = False  # kernel path for prefill attention

    # --- §Perf knobs (copied for field parity with the reference) ---
    serve_param_dtype: str = "fp32"
    decode_2d_params: bool = False
    moe_decode_gather: bool = False
    seq_shard_attn: bool = False
    vocab_chunk: int = 0
    decode_kv_chunk: int = 0

    # documentation
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY: dict = {}


def register(cfg: ModelConfig, reduced: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = (cfg, reduced)
    return cfg


def get_config(name: str) -> ModelConfig:
    _load_all()
    return _REGISTRY[name][0]


_LOADED = False


def _load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    import importlib

    for mod in ("tinyllama_1_1b", "blockllm_demo"):
        importlib.import_module(f"repro_torch.configs.{mod}")
    _LOADED = True
