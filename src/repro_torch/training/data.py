"""Synthetic token pipeline: deterministic, seekable, infinite (a copy of
``repro.training.data``, numpy only, so batches equal the reference's bit
for bit).

Generates structured pseudo-language (Zipf unigrams + Markov bigram mixing)
so models have real signal to fit, with deterministic per-step batches
(checkpoint-resumable by step index).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    zipf_a: float = 1.2


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.unigram = 1.0 / ranks**cfg.zipf_a
        self.unigram /= self.unigram.sum()
        # sparse bigram: each token prefers a few successors
        self.succ = rng.integers(0, v, size=(v, 4))

    def batch(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        """(tokens, labels) ``[batch, seq]`` int32 for this step,
        deterministic in (seed, step)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s = cfg.batch_size, cfg.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.choice(cfg.vocab_size, size=b, p=self.unigram)
        follow = rng.random((b, s)) < 0.7
        uni = rng.choice(cfg.vocab_size, size=(b, s), p=self.unigram)
        pick = rng.integers(0, self.succ.shape[1], size=(b, s))
        for t in range(s):
            nxt = self.succ[toks[:, t], pick[:, t]]
            toks[:, t + 1] = np.where(follow[:, t], nxt, uni[:, t])
        return toks[:, :-1], toks[:, 1:]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
