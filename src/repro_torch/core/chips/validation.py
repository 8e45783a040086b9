# Verbatim copy of src/repro/core/chips/validation.py (jax-free model layer).
"""Validation harness (Sec. 5): estimate vs reported across the nine chips."""
from __future__ import annotations

import math
from typing import Dict, List

from ..energy import estimate_energy
from .registry import CHIP_REGISTRY


def mape(estimates: List[float], reported: List[float]) -> float:
    return sum(abs(e - r) / r for e, r in zip(estimates, reported)) / len(reported)


def pearson(xs: List[float], ys: List[float]) -> float:
    n = len(xs)
    mx = sum(xs) / n
    my = sum(ys) / n
    cov = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
    vx = sum((x - mx) ** 2 for x in xs)
    vy = sum((y - my) ** 2 for y in ys)
    return cov / math.sqrt(vx * vy)


def validate_all(verbose: bool = False) -> Dict:
    """Run every chip, return per-chip estimates + aggregate MAPE/Pearson."""
    rows = []
    for cid, builder in CHIP_REGISTRY.items():
        hw, stages, mapping, meta = builder()
        rep = estimate_energy(hw, stages, mapping, strict=False)
        est = rep.energy_per_pixel(meta["pixels"]) * 1e12  # pJ/pixel
        rows.append(dict(chip=cid, estimated_pj=est,
                         reported_pj=meta["reported_pj_per_pixel"],
                         error=abs(est - meta["reported_pj_per_pixel"])
                         / meta["reported_pj_per_pixel"],
                         breakdown={k: v * 1e12 for k, v in
                                    rep.by_category().items()},
                         approx=meta["approx"], source=meta["source"]))
        if verbose:
            print(f"{cid:10s} est={est:10.1f} pJ/px  "
                  f"reported={meta['reported_pj_per_pixel']:10.1f}  "
                  f"err={rows[-1]['error']*100:6.1f}%")
    ests = [r["estimated_pj"] for r in rows]
    reps = [r["reported_pj"] for r in rows]
    return dict(rows=rows, mape=mape(ests, reps), pearson=pearson(ests, reps))
