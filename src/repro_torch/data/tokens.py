"""Deterministic synthetic LM token pipeline.

Every (step, shard) batch is a pure function of (seed, step, shard_id):
after a preemption or an elastic resize, any host can regenerate exactly its
slice of the global batch with zero coordination -- the data-side half of
the fault-tolerance story.  A numpy copy of the JAX package's module, so
both packages draw the same batches.

The stream is Zipf-distributed token ids with short-range repetition
structure so cross-entropy decreases measurably during the example training
runs (pure uniform noise would pin the loss at log V).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    repeat_p: float = 0.3  # P(copy a recent token) -> learnable structure


def _batch_rng(cfg: DataConfig, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard])
    )


def make_batch(cfg: DataConfig, step: int, shard: int = 0, num_shards: int = 1):
    """Return {'tokens','labels'} for this shard of the global batch."""
    assert cfg.global_batch % num_shards == 0
    b = cfg.global_batch // num_shards
    rng = _batch_rng(cfg, step, shard)
    raw = rng.zipf(cfg.zipf_a, size=(b, cfg.seq_len + 1))
    toks = (raw - 1) % cfg.vocab_size
    # Inject copy structure: with prob repeat_p, token t = token t-k (k<=8).
    mask = rng.random((b, cfg.seq_len + 1)) < cfg.repeat_p
    lags = rng.integers(1, 9, size=(b, cfg.seq_len + 1))
    idx = np.maximum(np.arange(cfg.seq_len + 1)[None, :] - lags, 0)
    toks = np.where(mask, np.take_along_axis(toks, idx, axis=1), toks)
    toks = toks.astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class TokenStream:
    """Stateless iterator facade used by the training driver."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1,
                 start_step: int = 0):
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.step = start_step

    def __next__(self):
        batch = make_batch(self.cfg, self.step, self.shard, self.num_shards)
        self.step += 1
        return batch

    def __iter__(self):
        return self
