"""Config system — a copy of ``repro.configs.base`` kept inside the PyTorch
port (the port imports nothing of ``repro``): model architecture configs
and the assigned input shapes.

Every architecture gets a ``ModelConfig`` in ``repro_torch/configs/<id>.py``
with the published numbers and a reduced CPU-test-sized variant of the
same family.  Parameters are counted by building the port's init on the
``meta`` device, which allocates nothing.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Tuple

# ---------------------------------------------------------------------------
# Input shapes (assigned; identical set for every LM-family arch).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


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

    def param_count(self) -> int:
        """Parameters of the model's init, counted from its shapes on the
        ``meta`` device (nothing is allocated)."""
        from repro_torch.models.model import build_model  # lazy: avoids a cycle

        shapes = build_model(self).param_shapes()
        return sum(math.prod(t.shape) for t in _leaves(shapes))

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts)."""
        total = self.param_count()
        if self.num_experts and self.num_experts_per_tok:
            L = self.num_layers
            expert_params = 3 * self.d_model * self.d_ff  # gate/up/down
            inactive = L * (self.num_experts - self.num_experts_per_tok) * expert_params
            return total - inactive
        return total


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


_REGISTRY: dict = {}


def register(cfg: ModelConfig, reduced: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = (cfg, reduced)
    return cfg


def get_config(name: str) -> ModelConfig:
    _load_all()
    return _REGISTRY[name][0]


def get_reduced_config(name: str) -> ModelConfig:
    _load_all()
    return _REGISTRY[name][1]


def list_configs() -> list:
    _load_all()
    return sorted(_REGISTRY)


_LOADED = False


def _load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    import importlib

    for mod in (
        "qwen2_vl_7b",
        "mixtral_8x22b",
        "dbrx_132b",
        "stablelm_12b",
        "tinyllama_1_1b",
        "qwen1_5_32b",
        "qwen2_72b",
        "zamba2_2_7b",
        "xlstm_125m",
        "seamless_m4t_medium",
        "blockllm_demo",
    ):
        importlib.import_module(f"repro_torch.configs.{mod}")
    _LOADED = True


def applicable_shapes(cfg: ModelConfig) -> list:
    """Shapes that apply to this arch (long_500k only for sub-quadratic)."""
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and not cfg.supports_long_context:
            continue  # pure full-attention: skip
        out.append(s)
    return out
