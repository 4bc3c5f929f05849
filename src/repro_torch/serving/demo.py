"""Demo zoo for the port: one foundation, one FPFT variant (a divergent
layer with an adaptive-equivalence edge) and PEFT variants over the
foundation — the port of ``repro.serving.demo``.

``build_demo_zoo`` draws random parameters from seeded torch generators on
the chosen device (any registered config: ``blockllm-demo`` for CPU-sized
runs, ``tinyllama-1.1b`` at full width on the card).  ``zoo_from_params``
registers given parameter trees — numpy (bridged bit-exact) or torch — as
they are, so a zoo built from the JAX reference's parameters has the JAX
zoo's block ids.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.bridge import to_torch
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import peft
from repro_torch.core.zoo import BlockZoo
from repro_torch.models.transformer import init_dense

PEFT_MAKERS = {"lora": peft.create_lora, "adapter": peft.create_adapter,
               "bitfit": peft.create_bitfit}


def build_demo_zoo(seed: int = 0, *, config: str = "blockllm-demo",
                   peft_kinds=("lora",), device="cuda"):
    """Returns (cfg, params, zoo) with apps: base, vicuna, app-<peft>..."""
    cfg = get_config(config)
    device = torch.device(device)
    params = init_dense(cfg, torch.Generator(device).manual_seed(seed))
    # FPFT variant: perturb one layer enough to stay its own block but keep
    # an adaptive-serving equivalence edge (cos ~ 1 - sigma^2/2)
    noise = torch.Generator(device).manual_seed(seed + 1)
    layer1 = {}
    for k, full in params["layers"].items():
        x = full[1]
        eps = torch.randn(x.shape, generator=noise, dtype=x.dtype,
                          device=device)
        layer1[k] = x + 0.15 * x.std(correction=0) * eps
    ft = dict(params)
    # per-layer list in place of the stacked tensors: only layer 1 differs,
    # and the zoo indexes layers the same way in both forms
    ft["layers"] = {k: [layer1[k] if i == 1 else full[i]
                        for i in range(cfg.num_layers)]
                    for k, full in params["layers"].items()}
    peft_trees = {
        kind: PEFT_MAKERS[kind](
            cfg, torch.Generator(device).manual_seed(seed + 2 + i))
        for i, kind in enumerate(peft_kinds)}
    return cfg, params, zoo_from_params(cfg, params, ft, peft_trees, device)


def _on_device(tree, device):
    if isinstance(tree, dict):
        return {k: _on_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_on_device(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return to_torch(np.asarray(tree), device)


def zoo_from_params(cfg: ModelConfig, base: dict, ft: dict,
                    peft_trees: Dict[str, List[dict]], device="cuda"
                    ) -> BlockZoo:
    """Register ``base`` as app ``base``, ``ft`` as the FPFT app ``vicuna``
    and each ``peft_trees[kind]`` (one dict per layer) as ``app-<kind>``.
    Leaves may be numpy arrays or torch tensors; they land on ``device``."""
    zoo = BlockZoo()
    zoo.register_foundation("base", cfg, _on_device(base, device))
    zoo.register_fpft("vicuna", cfg, _on_device(ft, device), "base")
    for kind, trees in peft_trees.items():
        zoo.register_peft(f"app-{kind}", cfg, "base", kind,
                          _on_device(list(trees), device))
    return zoo
