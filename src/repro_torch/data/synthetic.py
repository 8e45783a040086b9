"""Counter-based deterministic token stream (torch counterpart of
``src/repro/data/synthetic.py``).

Each batch is drawn from numpy's counter-based ``Philox`` generator
keyed on (seed, step, shard_id), so ``batch_at(step)`` is O(1) and the
same in every run.  The draws cannot equal the reference's
``jax.random`` (threefry) draws; the fields, modes, shapes, dtypes and
contract are the reference's, and the structured chain is its
``t' = (31 t + 17) mod V`` with 10% of tokens replaced by noise.
Batches are numpy int32 arrays, as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from ..models.config import ModelConfig


def _rng(seed: int, step: int, shard_id: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(
        np.random.SeedSequence([int(seed), int(step), int(shard_id)])))


@dataclasses.dataclass
class SyntheticTextDataset:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_shards: int = 1
    shard_id: int = 0
    #: 'random' = iid tokens (load testing); 'structured' = noisy affine
    #: bigram chain t_{i+1} = (a*t_i + c) mod V with 10% noise — learnable,
    #: so e2e training loss visibly falls.
    mode: str = "random"

    def __post_init__(self):
        if self.global_batch % self.num_shards:
            raise ValueError("global_batch must divide evenly across shards")
        self.shard_batch = self.global_batch // self.num_shards

    def batch_at(self, step: int) -> np.ndarray:
        """Tokens [shard_batch, seq_len] for this shard at ``step`` — O(1)."""
        rng = _rng(self.seed, step, self.shard_id)
        shape = (self.shard_batch, self.seq_len)
        if self.mode == "random":
            return rng.integers(0, self.vocab, shape, dtype=np.int32)
        start = rng.integers(0, self.vocab, self.shard_batch, dtype=np.int64)
        a, c = 31, 17
        toks = np.empty(shape, dtype=np.int64)
        toks[:, 0] = start
        for i in range(1, self.seq_len):
            toks[:, i] = (a * toks[:, i - 1] + c) % self.vocab
        noise_mask = rng.random(shape) < 0.1
        noise = rng.integers(0, self.vocab, shape, dtype=np.int64)
        return np.where(noise_mask, noise, toks).astype(np.int32)

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def batch_for_shape(cfg: ModelConfig, batch: int, seq: int, step: int = 0,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """Concrete batch dict matching the model family's input contract."""
    ds = SyntheticTextDataset(cfg.vocab, seq, batch, seed=seed)
    out: Dict[str, np.ndarray] = {"tokens": ds.batch_at(step)}
    rng = np.random.default_rng(seed + step)
    if cfg.family == "vlm":
        out = {"embeds": rng.standard_normal(
            (batch, seq, cfg.d_model), dtype=np.float32),
            "labels": ds.batch_at(step)}
    elif cfg.family == "encdec":
        out["audio_embeds"] = rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
    return out
