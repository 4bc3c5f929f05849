"""Train a small LM (checkpointed), then LoRA-fine-tune it and register
both into the block zoo — the offline half of BlockLLM's lifecycle; the
port of ``examples/train_and_partition.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_and_partition [--steps 200]
    PYTHONPATH=src python -m repro_torch.examples.train_and_partition --device cpu

Checkpoints go to ``--ckpt``, by default a temporary directory removed at
the end.
"""
import argparse
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.core import peft
from repro_torch.core.zoo import BlockZoo
from repro_torch.data.pipeline import DataConfig
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import TrainConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config("blockllm-demo")
    print(f"training {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"(~{cfg.param_count() / 1e6:.1f}M params) for {args.steps} steps")
    with tempfile.TemporaryDirectory() as tmp:
        out = train(
            cfg,
            TrainConfig(steps=args.steps, ckpt_dir=args.ckpt or tmp,
                        ckpt_every=50, microbatches=2, grad_compress="bf16",
                        opt=AdamWConfig(lr=1e-3, weight_decay=0.01)),
            DataConfig(vocab_size=cfg.vocab_size, global_batch=8,
                       seq_len=64),
            device=args.device,
        )
    print(f"loss: {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f} "
          f"({len(out['losses'])} steps, "
          f"{1e3 * sum(out['step_times']) / len(out['step_times']):.0f} ms/step)")

    zoo = BlockZoo()
    zoo.register_foundation("trained-base", cfg, out["params"])
    zoo.register_peft("trained-lora", cfg, "trained-base", "lora",
                      peft.create_lora(cfg, torch.Generator(
                          args.device).manual_seed(9)))
    print(f"zoo: {len(zoo.blocks)} blocks, "
          f"{zoo.redundancy_fraction() * 100:.1f}% redundancy removed, "
          f"profiling block 1 ...")
    rec = zoo.profile_block(zoo.chains["trained-base"].steps[1].block_id,
                            batch_sizes=(1, 8), seq_len=32)
    for bs, t in rec.compute_time_per_token.items():
        print(f"  batch={bs}: {t * 1e6:.1f} us/token")
    return out, zoo, rec


if __name__ == "__main__":
    main()
