# Verbatim copy of src/repro/launch/shapes.py (jax-free).
"""Assigned input shapes x architectures = the 40-cell dry-run matrix."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..configs import ARCH_IDS, get_config
from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def cell_skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """The assignment's skip rules (recorded, not silently dropped)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("pure full attention: no sub-quadratic path for a 524k-token "
                "cache (DESIGN.md §Arch-applicability)")
    return None


def all_cells() -> List[Tuple[str, ShapeSpec, Optional[str]]]:
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            cells.append((arch, shape, cell_skip_reason(cfg, shape)))
    return cells
