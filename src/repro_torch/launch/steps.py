"""Build the step function + placements for one (arch, shape, mesh) cell —
the port of ``repro.launch.steps``.  Used by the dry-run (traced on the
``meta`` device under the ``fake`` process group) and by real runs on a
local mesh (the card's (1, 1)).

A step takes and returns DTensors: ``place`` puts a tree of full tensors
(or of ``meta`` stand-ins) on the mesh by a placement tree.  The step runs
eagerly under ``implicit_replication`` (a plain tensor it makes, such as
the positions, counts as replicated), places every activation at the
reference's call sites (``models.sharding.ShardingCtx``) and redistributes
its outputs to the out placements, as jit's ``out_shardings`` do.  The
donated arguments are updated in place (the decode cache), which is what
donation does in the reference; nothing is compiled.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import shardings as SH
from repro_torch.models import layers as L
from repro_torch.models.model import build_model
from repro_torch.models.sharding import P, ShardingCtx, mesh_shape
from repro_torch.training.optimizer import (
    AdamWConfig,
    adamw_init,
    adamw_update,
)
from repro_torch.training.train_loop import value_and_grad


def _ctx(mesh, mode: str, cfg: ModelConfig, B: int) -> ShardingCtx:
    ctx = ShardingCtx(mesh, mode, cfg)
    ctx.dp = SH._dp(mesh, B)
    return ctx


def place(tree, placement_tree, mesh):
    """Each tensor of ``tree`` (the full value, the same on every rank, or
    a ``meta`` stand-in) as a DTensor of its placements: every rank keeps
    its own shard, nothing is sent (``src_data_rank=None``)."""
    return SH.zip_map(
        lambda t, pl: distribute_tensor(t, mesh, pl, src_data_rank=None),
        tree, placement_tree)


def _redistribute(tree, placement_tree):
    def one(t, pl):
        if isinstance(t, DTensor) and tuple(t.placements) != tuple(pl):
            return t.redistribute(t.device_mesh, pl)
        return t

    return SH.zip_map(one, tree, placement_tree)


def serve_params(cfg: ModelConfig, params):
    """The serve cells' parameters: fp32 leaves cast to bf16 when
    ``cfg.serve_param_dtype == "bf16"`` (``meta`` stand-ins too)."""
    if cfg.serve_param_dtype != "bf16":
        return params
    return SH.map_with_path(
        lambda _, t: t.to(torch.bfloat16) if t.dtype == torch.float32 else t,
        params)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               vocab_chunk: int = 0, remat: bool = True, *,
               compute_dtype: torch.dtype = L.COMPUTE_DTYPE):
    """Returns (fn, arg_structs, in_placements, out_placements,
    donate_argnums), as the reference: ``arg_structs`` are ``meta``
    tensors of the global shapes, the placement trees mirror them.  Every
    train layer is checkpointed, as in the reference, whatever ``remat``
    says.  ``compute_dtype`` is the Model API's (the reference reads its
    from the environment)."""
    model = build_model(cfg, compute_dtype)
    B = shape.global_batch
    batch_struct = model.batch_specs(shape)
    batch_pl = SH.named_tree(mesh, SH.batch_specs(batch_struct, cfg, mesh,
                                                  shape))
    scalar = SH.named_tree(mesh, P())

    if shape.kind == "train":
        shd = _ctx(mesh, "train", cfg, B)
        params_struct = model.param_shapes()
        opt_struct = adamw_init(params_struct)
        p_pl = SH.named_tree(mesh, SH.param_specs(params_struct, cfg, mesh,
                                                  "train"))
        opt_pl = {"step": scalar, "m": p_pl, "v": p_pl}
        opt_cfg = AdamWConfig()

        def train_step(params, opt_state, batch):
            with implicit_replication():
                loss, grads = value_and_grad(model, params, batch,
                                             vocab_chunk, shd=shd)
                params, opt_state, _ = adamw_update(grads, opt_state, params,
                                                    opt_cfg)
                return _redistribute((params, opt_state, loss),
                                     (p_pl, opt_pl, scalar))

        in_pl = (p_pl, opt_pl, batch_pl)
        out_pl = (p_pl, opt_pl, scalar)
        return (train_step, (params_struct, opt_struct, batch_struct), in_pl,
                out_pl, (0, 1))

    db = SH._dp(mesh, B)
    v_ax = "model" if cfg.vocab_size % mesh_shape(mesh)["model"] == 0 \
        else None
    logits_pl = SH.named_tree(mesh, P(db, v_ax))
    params_struct = serve_params(cfg, model.param_shapes())
    # the prefill's cache has the decode cache's structure at S
    cache_struct = model.cache_specs(shape)
    cache_pl = SH.named_tree(mesh, SH.cache_specs_tree(cache_struct, cfg,
                                                       mesh, shape))

    if shape.kind == "prefill":
        shd = _ctx(mesh, "prefill", cfg, B)
        p_pl = SH.named_tree(mesh, SH.param_specs(params_struct, cfg, mesh,
                                                  "prefill"))
        out_pl = (logits_pl, cache_pl, SH.named_tree(mesh, P(db)))

        def prefill(params, batch):
            with implicit_replication():
                return _redistribute(model.prefill(params, batch, shd=shd),
                                     out_pl)

        return prefill, (params_struct, batch_struct), (p_pl, batch_pl), \
            out_pl, ()

    # decode
    shd = _ctx(mesh, "decode", cfg, B)
    p_pl = SH.named_tree(mesh, SH.param_specs(params_struct, cfg, mesh,
                                              "decode"))
    out_pl = (logits_pl, cache_pl)

    def decode_step(params, cache, batch):
        with implicit_replication():
            return _redistribute(
                model.decode_step(params, cache, batch, shd=shd), out_pl)

    return (decode_step, (params_struct, cache_struct, batch_struct),
            (p_pl, cache_pl, batch_pl), out_pl, (1,))
