"""Training loop in PyTorch — the port of ``repro.training.train_loop``:
gradient accumulation over microbatches, optional compression of the
gradient payload, checkpoint/restart and per-step wall times.

A step is eager: ``value_and_grad`` differentiates the Model API's
``train_loss`` with ``torch.autograd.grad`` (the caller's parameters are
never marked as requiring gradients: the loss reads detached aliases of
them), then ``adamw_update`` returns new parameters and state.  Training
runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import layers as L
from repro_torch.models.model import Model, build_model
from repro_torch.training.optimizer import (
    AdamWConfig,
    adamw_init,
    adamw_update,
)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclass
class TrainConfig:
    steps: int = 100
    microbatches: int = 1           # grad accumulation
    grad_compress: str = "none"     # none | bf16 | int8 (the DP payload)
    vocab_chunk: int = 0
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    opt: AdamWConfig = field(default_factory=AdamWConfig)


def _compress(g, how: str):
    """Quantize the gradient payload as the cross-replica reduction would
    carry it: ``bf16`` rounds each leaf to bf16 and back; ``int8`` to
    per-leaf absmax / 127 codes (round half to even, as ``jnp.round``)
    and back."""
    if how == "bf16":
        return tree_map(lambda x: x.to(torch.bfloat16).to(x.dtype), g)
    if how == "int8":
        def q(x):
            scale = (x.abs().max() + 1e-12) / 127.0
            return (torch.round(x / scale).clamp(-127, 127) * scale).to(
                x.dtype)

        return tree_map(q, g)
    if how != "none":
        raise ValueError(f"grad_compress {how!r}; one of none, bf16, int8")
    return g


def value_and_grad(model: Model, params, batch: dict,
                   vocab_chunk: int = 0, shd=None):
    """(the train loss, its gradient with respect to every leaf of
    ``params``, a tree of ``params``' structure); ``shd`` as the Model
    API takes it."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = model.train_loss(tree_unflatten(params, leaves), batch, shd=shd,
                            vocab_chunk=vocab_chunk)
    # a leaf the loss does not read gets a zero gradient, as in JAX
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), tree_unflatten(params, list(grads))


def make_train_step(model: Model, tc: TrainConfig):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    Microbatching splits the batch on axis 0 and accumulates the
    (compressed) gradients, each divided by the count, in fp32."""

    def train_step(params, opt_state, batch):
        if tc.microbatches <= 1:
            loss, grads = value_and_grad(model, params, batch,
                                         tc.vocab_chunk)
            grads = _compress(grads, tc.grad_compress)
        else:
            n = tc.microbatches
            mbs = [{k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))[i]
                    for k, v in batch.items()} for i in range(n)]
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for mb in mbs:
                lv, g = value_and_grad(model, params, mb, tc.vocab_chunk)
                g = _compress(g, tc.grad_compress)
                loss = loss + lv / n
                grads = tree_map(lambda a, b: a + b / n, grads, g)
                del g
        params, opt_state, gnorm = adamw_update(grads, opt_state, params,
                                                tc.opt)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def train(cfg: ModelConfig, tc: TrainConfig, data: DataConfig, *,
          gen: Optional[torch.Generator] = None, device=None,
          resume: bool = True, params=None,
          compute_dtype: torch.dtype = L.COMPUTE_DTYPE) -> Dict[str, Any]:
    """Train ``cfg`` for ``tc.steps`` steps on ``data``'s batches with
    checkpoint/restart: resumes from the latest checkpoint in
    ``tc.ckpt_dir`` (when ``resume``), saves every ``tc.ckpt_every`` steps
    and, blocking, at the end.  Parameters come from ``params`` if given
    (a tree of tensors, e.g. carried over from the reference), else from
    ``Model.init(gen)`` (seed 0 by default).  Returns ``params``,
    ``opt_state``, ``losses`` and ``step_times`` (seconds, each step's
    wall with the loss read back)."""
    device = torch.device(device if device is not None else "cuda")
    model = build_model(cfg, compute_dtype)
    if params is None:
        gen = gen if gen is not None else torch.Generator(device).manual_seed(0)
        params = model.init(gen, device)
    params = tree_map(lambda p: p.to(device), params)
    opt_state = adamw_init(params)
    start_step = 0
    ckpt = Checkpointer(tc.ckpt_dir) if tc.ckpt_dir else None
    if ckpt and resume and ckpt.latest_step() is not None:
        state = ckpt.restore({"params": params, "opt": opt_state},
                             device=device)
        params, opt_state = state["params"], state["opt"]
        start_step = int(opt_state["step"])
    step_fn = make_train_step(model, tc)
    pipe = TokenPipeline(data)
    losses, step_times = [], []
    for step in range(start_step, tc.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in pipe.batch_at(step).items()}
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])  # the step's end on the device
        step_times.append(time.perf_counter() - t0)
        losses.append(loss)
        if ckpt and (step + 1) % tc.ckpt_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt_state})
    if ckpt:
        ckpt.save(tc.steps, {"params": params, "opt": opt_state},
                  blocking=True)
        ckpt.wait()
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "step_times": step_times}
