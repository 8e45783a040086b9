# Copy of the JSON helpers of src/repro/ckpt/manager.py (lines 25-70); that
# module imports jax, so its helpers are copied and the rest is left out.
"""Atomic small-record JSON I/O (shared with the campaign shard stores)."""
from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Optional


def canonical_json(obj: Any) -> str:
    """Canonical (sorted-key, minimal-separator) JSON — the checksum and
    content-comparison form.  ``repr``-round-trip floats, so a payload
    survives write -> read -> re-checksum bit-exactly."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      allow_nan=True)


def payload_checksum(obj: Any) -> str:
    """sha256 over the canonical JSON form of ``obj``."""
    return hashlib.sha256(canonical_json(obj).encode()).hexdigest()


def atomic_write_text(path: str, text: str) -> str:
    """Write ``text`` via tmp-file + fsync + rename.

    Same publish discipline as checkpoint directories: a reader never
    observes a half-written file, and a writer killed mid-write leaves
    only a ``.tmp`` turd the next writer overwrites.
    """
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)          # atomic publish
    return path


def atomic_write_json(path: str, obj: Any, *,
                      indent: Optional[int] = 1) -> str:
    """Write ``obj`` as JSON with :func:`atomic_write_text` discipline.

    Encodes to a string first (``json.dump``-to-file pins the
    pure-Python incremental encoder; ``dumps`` takes the C path when it
    can), then publishes atomically.
    """
    return atomic_write_text(path, json.dumps(obj, indent=indent))


def read_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)
