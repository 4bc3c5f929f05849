"""Training launcher — the port of ``repro.launch.train``.

    # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b --reduced --steps 50
    # on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b --reduced --steps 50 --device cpu

The production meshes' cells are traced by ``repro_torch.launch.dryrun``
(the reference's ``repro.launch.dryrun``), and run for real on a local
mesh through ``repro_torch.launch.steps.build_cell``.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="blockllm-demo")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.training.train_loop import TrainConfig, train

    cfg = (get_reduced_config if args.reduced else get_config)(args.arch)
    out = train(
        cfg,
        TrainConfig(steps=args.steps, microbatches=args.microbatches,
                    grad_compress=args.grad_compress,
                    ckpt_dir=args.ckpt or None),
        DataConfig(vocab_size=cfg.vocab_size, global_batch=args.batch,
                   seq_len=args.seq),
        device=args.device,
    )
    print(f"{cfg.name}: loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}"
          f" over {len(out['losses'])} steps")
    return out


if __name__ == "__main__":
    main()
