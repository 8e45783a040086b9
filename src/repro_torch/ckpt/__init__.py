"""Fault-tolerant checkpointing: the LM stack's ``CheckpointManager``
and the atomic, checksummed JSON records of campaign checkpoints
(torch counterpart of ``src/repro/ckpt/``; ``restore_resharded``, which
places a checkpoint under a new mesh, comes with the LM mesh)."""
from .manager import (CheckpointManager, atomic_write_json,
                      atomic_write_text, canonical_json, payload_checksum,
                      read_json)

__all__ = ["CheckpointManager", "atomic_write_json", "atomic_write_text",
           "canonical_json", "payload_checksum", "read_json"]
