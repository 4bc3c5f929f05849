"""Synthetic token pipeline: deterministic, shardable, restartable — a copy
of ``repro.data.pipeline`` kept inside the PyTorch port (the port imports
nothing of ``repro``).  It is numpy only: ``batch_at(step)`` is bitwise
the reference's.

Each host feeds its slice of the global batch; restart is exact via the
step-seeded PRNG, so resuming from a checkpoint replays the same batch
sequence.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    # structured synthetic language: a mixture of repeated n-grams and
    # noise, so the loss is learnable
    ngram: int = 4
    noise: float = 0.1


class TokenPipeline:
    def __init__(self, cfg: DataConfig, host_index: int = 0,
                 host_count: int = 1):
        assert cfg.global_batch % host_count == 0
        self.cfg = cfg
        self.host_index = host_index
        self.host_count = host_count
        self.local_batch = cfg.global_batch // host_count

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for ``step`` (restart-exact): ``tokens`` and
        ``labels`` (local_batch, seq_len) int32, labels shifted by one."""
        cfg = self.cfg
        rng = np.random.RandomState(
            (cfg.seed * 1_000_003 + step) % (2 ** 31) + self.host_index)
        base = rng.randint(0, cfg.vocab_size,
                           size=(self.local_batch, cfg.ngram))
        reps = int(np.ceil(cfg.seq_len / cfg.ngram)) + 1
        seq = np.tile(base, (1, reps))[:, : cfg.seq_len + 1]
        noise_mask = rng.rand(*seq.shape) < cfg.noise
        seq = np.where(noise_mask,
                       rng.randint(0, cfg.vocab_size, size=seq.shape), seq)
        return {
            "tokens": seq[:, :-1].astype(np.int32),
            "labels": seq[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
