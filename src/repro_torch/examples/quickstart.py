"""Quickstart: build a block zoo from fine-tuned variants, inspect sharing,
run a chain-of-blocks forward pass — the port of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart               # on the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

The chain's attention runs through the port's flash-attention kernel on
the card, and through the reference's plain code on the CPU.
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core import peft
from repro_torch.core.blocks import run_chain
from repro_torch.core.zoo import BlockZoo
from repro_torch.models.model import build_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    def gen(seed):
        return torch.Generator(dev).manual_seed(seed)

    cfg = get_config("blockllm-demo")
    model = build_model(cfg)
    params = model.init(gen(0))

    zoo = BlockZoo()
    zoo.register_foundation("llama-demo", cfg, params)

    # a full-parameter fine-tune whose layer 1 diverged during training
    ft = dict(params)
    noise = gen(1)
    ft["layers"] = {}
    for k, full in params["layers"].items():
        x = full[1]
        eps = torch.randn(x.shape, generator=noise, device=dev)
        ft["layers"][k] = full.clone()
        ft["layers"][k][1] = x + 0.15 * x.std(correction=0) * eps
    zoo.register_fpft("vicuna-demo", cfg, ft, "llama-demo")

    # three PEFT applications sharing the foundation
    zoo.register_peft("chatbot", cfg, "llama-demo", "lora",
                      peft.create_lora(cfg, gen(2)))
    zoo.register_peft("summarizer", cfg, "llama-demo", "adapter",
                      peft.create_adapter(cfg, gen(3)))
    zoo.register_peft("classifier", cfg, "llama-demo", "bitfit",
                      peft.create_bitfit(cfg, gen(4)))

    print(f"models registered : {len(zoo.chains)}")
    print(f"blocks in zoo     : {len(zoo.blocks)}")
    print(f"zoo storage       : {zoo.zoo_bytes() / 1e6:.1f} MB")
    print(f"per-model storage : {zoo.per_model_bytes() / 1e6:.1f} MB")
    print(f"redundancy removed: {zoo.redundancy_fraction() * 100:.1f}%  "
          f"(paper Fig. 5: up to 92.1%)")
    for (a, b), s in list(zoo.equivalences.items())[:2]:
        print(f"equivalence edge  : {a} <-> {b}  cos={s:.4f}")

    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen(5),
                           device=dev, dtype=torch.int32)
    with torch.no_grad():
        logits = run_chain(zoo, zoo.chains["chatbot"], tokens)
    print(f"chain forward     : logits {tuple(logits.shape)}, "
          f"finite={bool(torch.isfinite(logits.float()).all())}")


if __name__ == "__main__":
    main()
