# Verbatim copy of src/repro/energy/hlo.py (jax-free).
"""HLO text analysis: collective operand accounting.

``cost_analysis()`` has no collective-byte entry, so we parse the compiled
SPMD module: every ``all-reduce / all-gather / reduce-scatter / all-to-all /
collective-permute`` result shape is sized in bytes (per-device, since the
module is the per-device program).

Wire-byte convention (documented in EXPERIMENTS.md §Roofline): all-reduce
counts 2x its payload (reduce-scatter + all-gather phases of a ring);
everything else counts 1x its result bytes.  Ops inside `while` bodies would
be counted once — the cost-extraction path therefore parses only *unrolled*
modules (no while in the hot path; see DESIGN.md §6).
"""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# matches e.g.:  %all-gather.3 = bf16[16,512,320]{2,1,0} all-gather(...)
#           or:  ROOT %r = (f32[8,4]{...}, f32[8,4]{...}) all-reduce(...)
_RE = re.compile(
    r"=\s*(\(?[a-z0-9_]+\[[0-9,]*\][^)\s]*\)?[^=]*?)\s*"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(")

_SHAPE_RE = re.compile(r"([a-z0-9_]+)\[([0-9,]*)\]")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        nb = _DTYPE_BYTES.get(dtype)
        if nb is None:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * nb
    return total


def parse_collectives(hlo_text: str) -> Dict[str, int]:
    """Per-op-type result bytes (per device), '-start' forms deduped."""
    out: Dict[str, int] = defaultdict(int)
    seen_start = set()
    for m in re.finditer(
            r"%?([\w.\-]*)\s*=\s*([^=]+?)\s+"
            r"(all-reduce|all-gather|reduce-scatter|all-to-all|"
            r"collective-permute)(-start|-done)?\(", hlo_text):
        name, shape_str, op, phase = m.groups()
        if phase == "-done":
            continue               # counted at -start
        if phase == "-start":
            seen_start.add(name)
        out[op] += _shape_bytes(shape_str)
    return dict(out)


def collective_bytes(hlo_text: str) -> Tuple[float, Dict[str, int]]:
    """Weighted per-device wire bytes + raw per-op breakdown."""
    per_op = parse_collectives(hlo_text)
    weighted = 0.0
    for op, b in per_op.items():
        weighted += (2.0 if op == "all-reduce" else 1.0) * b
    return weighted, per_op
