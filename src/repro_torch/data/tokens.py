"""Synthetic LM data pipeline — deterministic, seeded by step index.

Streams (tokens, labels) batches with enough structure for a small model's
loss to fall well below the unigram entropy (bigram-chain generator with
Zipf marginals + repeated motifs), so end-to-end training examples show real
learning on CPU.  Determinism-by-step is what makes checkpoint-restart
replay exact (see train.elastic).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass
class TokenPipelineConfig:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    motif_len: int = 8
    motif_prob: float = 0.3


class TokenPipeline:
    def __init__(self, cfg: TokenPipelineConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        # sparse bigram transition structure: each token has ~8 likely successors
        self.succ = rng.integers(0, v, size=(v, 8))
        self.motifs = rng.integers(0, v, size=(16, cfg.motif_len))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, t = cfg.batch, cfg.seq_len
        seq = np.empty((b, t + 1), dtype=np.int32)
        seq[:, 0] = rng.integers(0, cfg.vocab, size=b)
        choice = rng.integers(0, 8, size=(b, t))
        explore = rng.random((b, t)) < 0.1
        randtok = rng.integers(0, cfg.vocab, size=(b, t))
        for i in range(t):
            nxt = self.succ[seq[:, i], choice[:, i]]
            seq[:, i + 1] = np.where(explore[:, i], randtok[:, i], nxt)
        # splice motifs (copy patterns)
        n_motifs = int(b * cfg.motif_prob)
        if n_motifs:
            rows = rng.integers(0, b, size=n_motifs)
            offs = rng.integers(0, max(t - cfg.motif_len, 1), size=n_motifs)
            which = rng.integers(0, len(self.motifs), size=n_motifs)
            for r, o, w in zip(rows, offs, which):
                seq[r, o:o + cfg.motif_len] = self.motifs[w]
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
