"""Unified Model API — the port of ``repro.models.model`` for every family:
dense (llama/qwen, qwen2-vl's backbone), MoE (mixtral, dbrx), hybrid
(zamba2: ``models.mamba2``), SSM (xlstm: ``models.xlstm``) and the
encoder-decoder (seamless-m4t).

``build_model(cfg)`` returns a ``Model`` with:
  - init(gen, device=None) -> params (fp32, drawn from a torch generator)
  - train_loss(params, batch, shd=None, vocab_chunk=0) -> 0-d fp32 loss,
    which autograd differentiates
  - prefill(params, batch, shd=None, max_len=None) -> (last_logits, cache,
    kv_len)
  - decode_step(params, cache, batch, shd=None) -> (logits, cache), the
    cache updated in place
  - param_shapes() / batch_specs(shape) / cache_specs(shape): tensors on
    the ``meta`` device (shapes and dtypes; nothing is allocated).

The entry points take ``attn_impl`` (``models.transformer``): on a CUDA
tensor, prefill runs the flash-attention kernel and decode the
paged-attention kernel (the SSM family has no attention and runs no
kernel).  The train loss runs the reference's plain attention on every
device and refuses a kernel route (no kernel has a backward).

``shd`` is the reference's sharding context (``models.sharding.ShardingCtx``):
on DTensor inputs (``launch.steps.build_cell``) each activation is placed
at the reference's call sites; with ``shd=None`` or plain tensors every
constraint is the identity.

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
from repro_torch.tree import _flatten_with_path, _path_str, tree_map

class Model:
    def __init__(self, cfg: ModelConfig, fns: Dict[str, Callable],
                 compute_dtype: torch.dtype = L.COMPUTE_DTYPE):
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self._fns = fns

    def init(self, gen: torch.Generator, device=None) -> dict:
        return self._fns["init"](self.cfg, gen, device)

    def train_loss(self, params, batch, shd=None, vocab_chunk: int = 0, *,
                   attn_impl: str = "auto"):
        return self._fns["train_loss"](params, self.cfg, batch,
                                       vocab_chunk=vocab_chunk,
                                       attn_impl=attn_impl,
                                       compute_dtype=self.compute_dtype,
                                       shd=shd)

    def prefill(self, params, batch, shd=None, max_len=None, *,
                attn_impl: str = "auto"):
        return self._fns["prefill"](params, self.cfg, batch, max_len=max_len,
                                    attn_impl=attn_impl,
                                    compute_dtype=self.compute_dtype, shd=shd)

    def decode_step(self, params, cache, batch, shd=None, *,
                    attn_impl: str = "auto"):
        return self._fns["decode_step"](params, self.cfg, cache, batch,
                                        attn_impl=attn_impl,
                                        compute_dtype=self.compute_dtype,
                                        shd=shd)

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
            batch = {"tokens": sd((B, 1), i32), "kv_len": sd((B,), i32)}
            if cfg.family == "encdec":
                batch["src_len"] = sd((B,), i32)
            return batch
        batch = {"tokens": sd((B, S), i32)}
        batch["labels" if shape.kind == "train" else "prompt_lens"] = (
            sd((B, S), i32) if shape.kind == "train" else sd((B,), i32))
        if cfg.num_visual_tokens:
            batch["visual_embeds"] = sd((B, cfg.num_visual_tokens,
                                         cfg.d_model), self.compute_dtype)
            batch["mrope_positions"] = sd((B, S, 3), i32)
        if cfg.family == "encdec":  # source frames as long as the target
            batch["frames"] = sd((B, S, cfg.d_model), self.compute_dtype)
        return batch

    def cache_specs(self, shape: ShapeConfig) -> dict:
        """The decode cache's tensors for this (arch, shape)."""
        return cache_struct(self.cfg, shape.global_batch, shape.seq_len,
                            self.compute_dtype)


def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _zamba_cache_struct(cfg: ModelConfig, B: int, S: int,
                        dtype: torch.dtype) -> dict:
    from repro_torch.models.mamba2 import mamba_dims

    _, H, N, conv_ch, _ = mamba_dims(cfg)
    n_super, every = (cfg.num_layers // cfg.shared_attn_every,
                      cfg.shared_attn_every)
    W = min(S, cfg.sliding_window) if cfg.sliding_window else S
    kv = (n_super, B, W, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {
        "attn": {"k": _meta(kv, dtype), "v": _meta(kv, dtype)},
        "conv": _meta((n_super, every, B, cfg.ssm_conv_width - 1, conv_ch),
                      dtype),
        "ssm": _meta((n_super, every, B, H, cfg.ssm_head_dim, N)),
    }


def _xlstm_state_struct(cfg: ModelConfig, B: int) -> tuple:
    from repro_torch.models.xlstm import _dims

    _, _, H, dk, dh, _ = _dims(cfg)
    return tuple(
        (_meta((B, H, dk, dk)), _meta((B, H, dk)), _meta((B, H)))
        if i % 2 == 0 else tuple(_meta((B, H, dh)) for _ in range(4))
        for i in range(cfg.num_layers))


def cache_struct(cfg: ModelConfig, B: int, S: int,
                 dtype: torch.dtype = L.COMPUTE_DTYPE):
    """The decode cache's tensors on the ``meta`` device: the stacked KV
    cache of ``layers.init_kv_cache`` (dense, moe); the hybrid's shared-block
    ``attn`` K/V (n_super, B, W, KVH, hd) with the mamba ``conv`` (n_super,
    every, B, W_conv - 1, C) and fp32 ``ssm`` (n_super, every, B, H, P, N)
    states; the SSM family's per-block fp32 state tuples; or the
    encoder-decoder's ``k``/``v`` (Ld, B, S, H, hd) with the
    cross-attention ``xk``/``xv`` (Ld, B, S, H, hd) (a source as long as
    the target, as in the reference's specs)."""
    if cfg.family == "hybrid":
        return _zamba_cache_struct(cfg, B, S, dtype)
    if cfg.family == "ssm":
        return _xlstm_state_struct(cfg, B)
    if cfg.family != "encdec":
        return L.init_kv_cache(cfg, cfg.num_layers, B, S, cfg.num_kv_heads,
                               dtype=dtype, device="meta")
    hd, H, Ld = cfg.resolved_head_dim, cfg.num_heads, cfg.decoder_layers
    cache = L.init_kv_cache(cfg, Ld, B, S, H, dtype=dtype, device="meta")
    for name in ("xk", "xv"):
        cache[name] = torch.empty((Ld, B, S, H, hd), dtype=dtype,
                                  device="meta")
    return cache


def build_model(cfg: ModelConfig,
                compute_dtype: torch.dtype = L.COMPUTE_DTYPE) -> Model:
    if cfg.family == "dense":
        from repro_torch.models import transformer as T

        return Model(cfg, {
            "init": T.init_dense,
            "train_loss": T.dense_train_loss,
            "prefill": T.dense_prefill,
            "decode_step": T.dense_decode_step,
        }, compute_dtype)
    if cfg.family == "moe":
        from repro_torch.models import moe as M

        return Model(cfg, {
            "init": M.init_moe,
            "train_loss": M.moe_train_loss,
            "prefill": M.moe_prefill,
            "decode_step": M.moe_decode_step,
        }, compute_dtype)
    if cfg.family == "hybrid":
        from repro_torch.models import mamba2 as Z

        return Model(cfg, {
            "init": Z.init_zamba,
            "train_loss": Z.zamba_train_loss,
            "prefill": Z.zamba_prefill,
            "decode_step": Z.zamba_decode_step,
        }, compute_dtype)
    if cfg.family == "ssm":
        from repro_torch.models import xlstm as X

        return Model(cfg, {
            "init": X.init_xlstm,
            "train_loss": X.xlstm_train_loss,
            "prefill": X.xlstm_prefill,
            "decode_step": X.xlstm_decode_step,
        }, compute_dtype)
    if cfg.family == "encdec":
        from repro_torch.models import encdec as E

        return Model(cfg, {
            "init": E.init_encdec,
            "train_loss": E.encdec_train_loss,
            "prefill": E.encdec_prefill,
            "decode_step": E.encdec_decode_step,
        }, compute_dtype)
    raise ValueError(f"unknown family {cfg.family}")


# ---------------------------------------------------------------------------
# trees carried across from numpy
# ---------------------------------------------------------------------------


def _check(what: str, got: dict, want: dict, exact_dims: bool = True) -> None:
    g = {_path_str(k): (tuple(v.shape), str(v.dtype))
         for k, v in _flatten_with_path(got)}
    w = {_path_str(k): (tuple(v.shape), str(v.dtype).replace("torch.", ""))
         for k, v in _flatten_with_path(want)}
    if sorted(g) != sorted(w):
        raise ValueError(f"{what}: keys {sorted(g)}, want {sorted(w)}")
    for k, (shape, dtype) in g.items():
        wshape, wdtype = w[k]
        dims = range(len(wshape)) if exact_dims else (0, 3, 4)
        if len(shape) != len(wshape) or dtype != wdtype \
                or any(shape[d] != wshape[d] for d in dims):
            raise ValueError(f"{what} {k}: {shape} {dtype}, want {wshape} "
                             f"{wdtype}")


def params_from_numpy(cfg: ModelConfig, tree: dict, device) -> dict:
    """The reference's parameter tree (numpy; bf16 as ``ml_dtypes``) as
    tensors on ``device``, after checking its keys, shapes and dtypes
    against ``build_model(cfg).param_shapes()``."""
    _check("params", tree, build_model(cfg).param_shapes())
    return to_torch(tree, device=device)


def cache_from_numpy(cfg: ModelConfig, tree, device,
                     compute_dtype: torch.dtype = L.COMPUTE_DTYPE):
    """A reference decode cache (numpy: ``k``/``v`` (L, B, S, KVH, hd) in
    the compute dtype, or int8 codes with fp32 scales; the encoder-decoder's
    also ``xk``/``xv``; the hybrid's ``{attn: {k, v}, conv, ssm}``; the SSM
    family's tuple of per-block state tuples) as tensors on ``device``,
    after checking its keys, dtypes and shapes against this config (B and
    the lengths are the tree's own; the KV caches' layers and heads are
    checked, the hybrid's and SSM's every dim).  The tensors never alias
    the tree's arrays: decode writes them in place."""
    if cfg.family == "ssm":
        B, S = tree[0][0].shape[0], 0
    else:
        B, S = (tree["attn"] if cfg.family == "hybrid" else tree)[
            "k"].shape[1:3]
    want = cache_struct(cfg, B, S, compute_dtype)
    _check("cache", tree, want,
           exact_dims=cfg.family in ("hybrid", "ssm"))
    return to_torch(tree_map(np.array, tree), device=device)
