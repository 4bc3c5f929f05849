"""Unified Model API — the port of ``repro.models.model`` for the dense
family (llama/qwen, qwen2-vl's backbone).

``build_model(cfg)`` returns a ``Model`` with:
  - init(gen, device=None) -> params (fp32, drawn from a torch generator)
  - prefill(params, batch, max_len=None) -> (last_logits, cache, kv_len)
  - decode_step(params, cache, batch) -> (logits, cache), the cache
    updated in place
  - param_shapes() / batch_specs(shape) / cache_specs(shape): tensors on
    the ``meta`` device (shapes and dtypes; nothing is allocated).

Both entry points take ``attn_impl`` (``models.transformer``): on a CUDA
tensor, prefill runs the flash-attention kernel and decode the
paged-attention kernel.  The other families and training raise
``NotImplementedError`` naming the ``ROADMAP.md`` item that ports them; the
reference's sharding argument is not taken (the mesh code comes last).

``params_from_numpy`` and ``cache_from_numpy`` carry the reference's
trees (as ``jax.device_get`` returns them) across, checked against this
model's shapes.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.bridge import to_torch
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import layers as L

# family -> the ROADMAP.md section 1 item that ports it
NOT_PORTED = {
    "moe": "ROADMAP.md §1 item 1 (MoE: models/moe.py, models/moe_dispatch.py)",
    "hybrid": "ROADMAP.md §1 item 2 (hybrid: models/mamba2.py)",
    "ssm": "ROADMAP.md §1 item 3 (SSM: models/xlstm.py)",
    "encdec": "ROADMAP.md §1 item 4 (enc-dec: models/encdec.py)",
}
TRAINING_ITEM = ("ROADMAP.md §1 item 5 (training: dense_train_loss, "
                 "cross_entropy, training/, checkpoint/)")


class Model:
    def __init__(self, cfg: ModelConfig, fns: Dict[str, Callable],
                 compute_dtype: torch.dtype = L.COMPUTE_DTYPE):
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self._fns = fns

    def init(self, gen: torch.Generator, device=None) -> dict:
        return self._fns["init"](self.cfg, gen, device)

    def train_loss(self, params, batch, vocab_chunk: int = 0):
        raise NotImplementedError(f"training is not ported yet: {TRAINING_ITEM}")

    def prefill(self, params, batch, max_len=None, *, attn_impl: str = "auto"):
        return self._fns["prefill"](params, self.cfg, batch, max_len=max_len,
                                    attn_impl=attn_impl,
                                    compute_dtype=self.compute_dtype)

    def decode_step(self, params, cache, batch, *, attn_impl: str = "auto"):
        return self._fns["decode_step"](params, self.cfg, cache, batch,
                                        attn_impl=attn_impl,
                                        compute_dtype=self.compute_dtype)

    # ------------------------------------------------------------------
    # shape stand-ins on the meta device (never allocate)
    # ------------------------------------------------------------------

    def param_shapes(self) -> dict:
        return self.init(torch.Generator(), device="meta")

    def batch_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len

        def sd(shp, dtype):
            return torch.empty(shp, dtype=dtype, device="meta")

        i32 = torch.int32
        if shape.kind == "decode":  # one new token against a cache of S
            return {"tokens": sd((B, 1), i32), "kv_len": sd((B,), i32)}
        batch = {"tokens": sd((B, S), i32)}
        batch["labels" if shape.kind == "train" else "prompt_lens"] = (
            sd((B, S), i32) if shape.kind == "train" else sd((B,), i32))
        if cfg.num_visual_tokens:
            batch["visual_embeds"] = sd((B, cfg.num_visual_tokens,
                                         cfg.d_model), self.compute_dtype)
            batch["mrope_positions"] = sd((B, S, 3), i32)
        return batch

    def cache_specs(self, shape: ShapeConfig) -> dict:
        """The decode cache's tensors for this (arch, shape)."""
        return L.init_kv_cache(self.cfg, self.cfg.num_layers,
                               shape.global_batch, shape.seq_len,
                               self.cfg.num_kv_heads,
                               dtype=self.compute_dtype, device="meta")


def build_model(cfg: ModelConfig,
                compute_dtype: torch.dtype = L.COMPUTE_DTYPE) -> Model:
    if cfg.family == "dense":
        from repro_torch.models import transformer as T

        return Model(cfg, {
            "init": T.init_dense,
            "prefill": T.dense_prefill,
            "decode_step": T.dense_decode_step,
        }, compute_dtype)
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet: "
            f"{NOT_PORTED[cfg.family]}")
    raise ValueError(f"unknown family {cfg.family}")


# ---------------------------------------------------------------------------
# trees carried across from numpy
# ---------------------------------------------------------------------------


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _check(what: str, got: dict, want: dict, exact_dims: bool = True) -> None:
    g = {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(got)}
    w = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
         for k, v in _flat(want)}
    if sorted(g) != sorted(w):
        raise ValueError(f"{what}: keys {sorted(g)}, want {sorted(w)}")
    for k, (shape, dtype) in g.items():
        wshape, wdtype = w[k]
        dims = range(len(wshape)) if exact_dims else (0, 3, 4)
        if len(shape) != len(wshape) or dtype != wdtype \
                or any(shape[d] != wshape[d] for d in dims):
            raise ValueError(f"{what}{k}: {shape} {dtype}, want {wshape} "
                             f"{wdtype}")


def params_from_numpy(cfg: ModelConfig, tree: dict, device) -> dict:
    """The reference's parameter tree (numpy; bf16 as ``ml_dtypes``) as
    tensors on ``device``, after checking its keys, shapes and dtypes
    against ``build_model(cfg).param_shapes()``."""
    _check("params", tree, build_model(cfg).param_shapes())
    return to_torch(tree, device=device)


def cache_from_numpy(cfg: ModelConfig, tree: dict, device,
                     compute_dtype: torch.dtype = L.COMPUTE_DTYPE) -> dict:
    """A reference decode cache (numpy: ``k``/``v`` (L, B, S, KVH, hd) in
    the compute dtype, or int8 codes with fp32 scales) as tensors on
    ``device``, after checking its keys, dtypes, layers and heads against
    this config (B and S are the tree's own).  The tensors never alias the
    tree's arrays: decode writes them in place."""
    B, S = tree["k"].shape[1:3]
    want = L.init_kv_cache(cfg, cfg.num_layers, B, S, cfg.num_kv_heads,
                           dtype=compute_dtype, device="meta")
    _check("cache", tree, want, exact_dims=False)
    return to_torch({k: np.array(v) for k, v in tree.items()}, device=device)
