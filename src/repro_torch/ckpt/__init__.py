"""Atomic, checksummed JSON records for campaign checkpoints.

Only the reference's small-record JSON helpers
(``repro/ckpt/manager.py``); its ``CheckpointManager`` and
``restore_resharded`` belong to the LM stack (ROADMAP P12) and are not
ported yet.
"""
from .manager import (atomic_write_json, atomic_write_text, canonical_json,
                      payload_checksum, read_json)

__all__ = ["atomic_write_json", "atomic_write_text", "canonical_json",
           "payload_checksum", "read_json"]
