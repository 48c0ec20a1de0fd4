"""Synthetic data pipelines: deterministic token streams and image batches.

A copy of the reference's ``data/synthetic.py`` (pure numpy; the port
imports nothing of the JAX package), so a batch is byte-equal to the
reference's for every ``(seed, shard, step)``.

The LM stream generates structured (learnable) sequences, a noisy k-gram
process, so short training runs show real loss reduction, not memorized
noise.  Host-side generation is seeded per (shard, step): every
data-parallel host can produce exactly its shard without coordination, and
a restarted job regenerates identical batches (checkpoint/restart
determinism).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class LMStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    order: int = 2          # k-gram order of the synthetic process
    noise: float = 0.05


class SyntheticLMStream:
    """Deterministic, shardable synthetic token stream."""

    def __init__(self, cfg: LMStreamConfig, *, shard: int = 0,
                 n_shards: int = 1):
        assert cfg.global_batch % n_shards == 0
        self.cfg = cfg
        self.shard = shard
        self.n_shards = n_shards
        self.local_batch = cfg.global_batch // n_shards
        # a fixed random transition table defines the k-gram process
        rng = np.random.default_rng(cfg.seed)
        self._trans = rng.integers(
            0, cfg.vocab_size, size=(cfg.vocab_size, cfg.order),
            dtype=np.int64)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, self.shard, step, 0xC0FFEE))
        B, S = self.local_batch, cfg.seq_len
        toks = np.empty((B, S + 1), np.int64)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, B)
        phase = rng.integers(0, cfg.order, B)
        for t in range(1, S + 1):
            nxt = self._trans[toks[:, t - 1], (phase + t) % cfg.order]
            flip = rng.uniform(size=B) < cfg.noise
            rand = rng.integers(0, cfg.vocab_size, B)
            toks[:, t] = np.where(flip, rand, nxt)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def synthetic_images(key_seed: int, n: int, shape: Tuple[int, int, int],
                     n_classes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Class-conditional Gaussian blobs — learnable image toy data."""
    rng = np.random.default_rng(key_seed)
    labels = rng.integers(0, n_classes, n)
    protos = rng.normal(size=(n_classes,) + shape).astype(np.float32)
    x = protos[labels] + 0.5 * rng.normal(size=(n,) + shape).astype(np.float32)
    return x.astype(np.float32), labels.astype(np.int32)
