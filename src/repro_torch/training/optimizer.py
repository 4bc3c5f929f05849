"""AdamW in PyTorch, functional as the reference's (no ``torch.optim``) —
the port of ``repro.training.optimizer``.

The optimizer state mirrors the parameter tree: fp32 moments ``m`` and
``v`` and an int32 ``step``.  ``adamw_update`` clips the gradients by
their global norm, corrects the moments' bias in fp32 from the step, and
returns new parameters and state (the old ones are not written), with the
reference's arithmetic leaf by leaf.  Leaves are visited in JAX's flatten
order (``repro_torch.tree``), so the global norm sums them in the
reference's order.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params) -> dict:
    """``{"step": 0 (int32), "m": zeros, "v": zeros}``, the moments fp32 on
    each parameter's device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = tree_leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in fp32, the leaves
    summed in JAX's flatten order."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, opt_state: dict, params, cfg: AdamWConfig):
    """One AdamW step.  Returns (new params, new state, the gradients'
    global norm before clipping)."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    t = step.float()
    c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                    device=t.device), t)
    c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                    device=t.device), t)

    def upd(g, m, v, p):
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mhat = m / c1
        vhat = v / c2
        p32 = p.float()
        p_new = p32 - cfg.lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                                + cfg.weight_decay * p32)
        return p_new.to(p.dtype), m, v

    out = [upd(g, m, v, p) for g, m, v, p in zip(
        tree_leaves(grads), tree_leaves(opt_state["m"]),
        tree_leaves(opt_state["v"]), tree_leaves(params))]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    return new_p, {"step": step, "m": new_m, "v": new_v}, gnorm
