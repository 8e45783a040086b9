"""Deterministic synthetic data pipeline (torch counterpart of
``src/repro/data/``).

Production properties the loop relies on:
  * fully deterministic as a function of (seed, step, shard) — restart at
    step k reproduces exactly the batches a crashed run would have seen
    (checkpoint/restore never replays or skips data);
  * O(1) skip-to-step (no iterator fast-forwarding);
  * shard-aware: each data-parallel shard draws only its slice.
"""
from .synthetic import SyntheticTextDataset, batch_for_shape

__all__ = ["SyntheticTextDataset", "batch_for_shape"]
