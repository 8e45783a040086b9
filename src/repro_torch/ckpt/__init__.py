"""Fault-tolerant checkpointing: the LM stack's ``CheckpointManager``,
``restore_resharded`` (a checkpoint placed under the shardings of a new
mesh) and the atomic, checksummed JSON records of campaign checkpoints
(torch counterpart of ``src/repro/ckpt/``)."""
from .manager import (CheckpointManager, atomic_write_json,
                      atomic_write_text, canonical_json, payload_checksum,
                      read_json, restore_resharded)

__all__ = ["CheckpointManager", "restore_resharded", "atomic_write_json",
           "atomic_write_text", "canonical_json", "payload_checksum",
           "read_json"]
