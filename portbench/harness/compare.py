"""The numbers that decide ``correct``: the program's outputs against
the reference's, each a gap that the cell's file bounds by a limit.

Training (each of the first steps, driven through the window's own
call): ``loss_gap``, the worst step's |loss - reference| / reference;
``grad_norm_gap``, the first gradient's global norm before the clip,
the same way; ``grad_leaf_gap``, each leaf's norm of the first clipped
gradient (the program's read from AdamW's first moment after one step)
against the reference's, the worst leaf, over the larger of that leaf's
reference norm and the median leaf's; ``update_leaf_gap``, the same of
each leaf's change after the compared steps, leaving out leaves whose
reference gradient is under a thousandth of the median leaf's (they
move by round-off alone); ``unmoved_leaves``, how many of those leaves
the program left exactly where they started while the reference moved
them (a run that does is no sound run).

Prefill: ``kv_gap``, the worst (layer, row, position) relative error of
the K or V the call wrote into its cache; ``logit_gap``, the worst row's
relative error of the last position's logits.
"""
from __future__ import annotations

import statistics
from typing import Dict, List

import torch

SILENT_LEAF = 1e-3


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else (0.0 if a == b else float("inf"))


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
                keys: List[str]) -> float:
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys)


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    if len(prog["loss"]) != len(ref["loss"]) or \
            set(prog["first_grad"]) != set(ref["first_grad"]):
        raise ValueError("program and reference readings do not match")
    med = statistics.median(ref["first_grad"].values())
    moving = [k for k, g in ref["first_grad"].items()
              if g >= SILENT_LEAF * med]
    return {
        "loss_gap": max(_rel(p, r) for p, r in zip(prog["loss"],
                                                    ref["loss"])),
        "grad_norm_gap": _rel(prog["grad_norm"], ref["grad_norm"]),
        "grad_leaf_gap": _worst_leaf(prog["first_grad"], ref["first_grad"],
                                     sorted(ref["first_grad"])),
        "update_leaf_gap": _worst_leaf(prog["update"], ref["update"],
                                       moving),
        "unmoved_leaves": float(sum(
            prog["update"][k] == 0.0 < ref["update"][k] for k in moving)),
    }


def worst_leaves(prog: Dict, ref: Dict) -> Dict[str, str]:
    """Which leaf sets each worst-leaf number, and the unmoved leaves (for
    the record of a calibration)."""
    out = {}
    for key in ("first_grad", "update"):
        med = statistics.median(ref[key].values())
        out[key] = max(ref[key], key=lambda k: abs(prog[key][k] - ref[key][k])
                       / max(ref[key][k], med))
    out["unmoved"] = ",".join(k for k in sorted(ref["update"])
                              if prog["update"][k] == 0.0 < ref["update"][k])
    return out


def kv_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Worst row-and-position relative error, [B, S, F] each."""
    err = torch.linalg.vector_norm(prog.float() - ref, dim=-1)
    return float((err / torch.linalg.vector_norm(ref, dim=-1)
                  .clamp(min=1e-30)).max())


def logit_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Worst row's relative error, [B, V] last-position logits."""
    rel = torch.linalg.vector_norm(prog.float() - ref, dim=-1) \
        / torch.linalg.vector_norm(ref, dim=-1).clamp(min=1e-30)
    return float(rel.max())


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, rows): every limited number at or under its limit, with
    something limited; rows are (name, value, limit)."""
    rows = [(k, numbers.get(k, float("nan")), float(v))
            for k, v in sorted(limits.items())]
    ok = bool(rows) and all(val <= lim for _, val, lim in rows)
    return ok, rows
