"""The reference's first training steps and what they read.

:func:`follow` starts from the benchmark's weights (upcast to float32),
takes ``steps`` AdamW steps on the given batches and returns what the
comparison reads of a training run: each step's loss, the first
gradient's global norm before the clip, each leaf's norm of the first
gradient after the clip (what the optimizer takes), and each leaf's
norm of the change of the parameters after the last step.

``fault`` plants one of the faults the comparison must catch, so that
they can be read at the cell's own size: ``"half_batch"`` takes the
mean over the first half of each batch's rows only; ``"unchanged"``
leaves the parameters and moments as they were at every step.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import lm
from .adamw import AdamW, lr_at


def follow(weights: Dict[str, torch.Tensor], batches: List[torch.Tensor],
           arch: Dict, hyper: Dict, steps: int, cast=lm.identity,
           fault: Optional[str] = None) -> Dict:
    params = {k: w.detach().float().clone().requires_grad_(True)
              for k, w in weights.items()}
    start = {k: w.detach().float() for k, w in weights.items()}
    opt = AdamW(params, hyper["adamw"])
    losses: List[float] = []
    grad_norm = None
    first: Dict[str, float] = {}
    for s in range(steps):
        tokens = batches[s]
        if fault == "half_batch":
            tokens = tokens[: tokens.shape[0] // 2]
        elif fault not in (None, "unchanged"):
            raise ValueError(f"unknown fault {fault!r}")
        loss = lm.loss(params, tokens, arch, cast)
        grads = torch.autograd.grad(loss, list(params.values()))
        grads = dict(zip(params, grads))
        losses.append(float(loss.detach()))
        clipped, norm = AdamW.clip(grads, hyper["adamw"]["max_grad_norm"])
        del grads
        if s == 0:
            grad_norm = float(norm)
            first = {k: float(torch.linalg.vector_norm(g))
                     for k, g in clipped.items()}
        if fault != "unchanged":
            opt.step(clipped, lr_at(s, hyper["base_lr"],
                                    hyper["warmup_steps"],
                                    hyper["total_steps"]))
        del clipped, loss
    update = {k: float(torch.linalg.vector_norm(p.detach() - start[k]))
              for k, p in params.items()}
    return {"loss": losses, "grad_norm": grad_norm, "first_grad": first,
            "update": update}
