"""Deterministic, restartable synthetic LM data pipeline (a copy of
``repro.data.pipeline``, numpy only).

The stream is a pure function of (seed, step): restart-from-checkpoint lands
on byte-identical batches with zero replay state — the property that makes
preemption recovery and elastic rescale exact (the batch for global step s is
the same no matter which host, how many hosts, or after how many restarts).

Host sharding: ``shard_index/shard_count`` slice the global batch so every
data-parallel host materializes only its slice (what a 1000-node deployment
does).

The token generator is a skew-controlled Zipf-ish mixture with short Markov
repeats — enough structure that a ~100M model visibly learns (loss drops well
below uniform entropy) without shipping a corpus.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    zipf_a: float = 1.2
    repeat_p: float = 0.35  # probability of short-range copy (learnable signal)


class SyntheticLMStream:
    def __init__(self, cfg: DataConfig, shard_index: int = 0, shard_count: int = 1):
        assert cfg.global_batch % shard_count == 0
        self.cfg = cfg
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.local_batch = cfg.global_batch // shard_count
        # precompute the zipf CDF once
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        w = ranks ** (-cfg.zipf_a)
        self._cdf = np.cumsum(w / w.sum())

    def batch_at(self, step: int) -> dict:
        """Batch for global step ``step`` — pure function of (seed, step)."""
        cfg = self.cfg
        rows = []
        base = step * cfg.global_batch + self.shard_index * self.local_batch
        for r in range(self.local_batch):
            rng = np.random.default_rng((cfg.seed, base + r))
            u = rng.random(cfg.seq_len + 1)
            toks = np.searchsorted(self._cdf, u).astype(np.int32)
            # short-range copies: tok[i] = tok[i-d] with prob repeat_p
            copy = rng.random(cfg.seq_len + 1) < cfg.repeat_p
            d = rng.integers(1, 8, size=cfg.seq_len + 1)
            for i in range(1, cfg.seq_len + 1):
                if copy[i] and i - d[i] >= 0:
                    toks[i] = toks[i - d[i]]
            rows.append(toks)
        arr = np.stack(rows)
        return {
            "tokens": arr[:, :-1].astype(np.int32),
            "labels": arr[:, 1:].astype(np.int32),
        }

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
