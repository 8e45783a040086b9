"""AdamW (Loshchilov and Hutter, arXiv:1711.05101) with a global-norm
clip, and a linear-warmup cosine schedule, in float32.

The update: the gradients are scaled by ``min(1, max_norm / (norm +
1e-9))`` where ``norm`` is their global L2 norm; ``m`` and ``v`` are
the biased moments; ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``
with the decay on matrices only (leaves of two or more axes).
"""
from __future__ import annotations

import math
from typing import Dict

import torch


def lr_at(step: int, base_lr: float, warmup: int, total: int,
          min_ratio: float = 0.1) -> float:
    if step < warmup:
        return base_lr * min(step / max(warmup, 1), 1.0)
    frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return base_lr * (min_ratio + (1 - min_ratio)
                      * 0.5 * (1 + math.cos(math.pi * frac)))


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor], hyper: Dict):
        self.params = params
        self.h = hyper
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    @staticmethod
    def clip(grads: Dict[str, torch.Tensor], max_norm: float):
        """The clipped gradients and the norm before the clip."""
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
        return {k: g * scale for k, g in grads.items()}, norm

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        h = self.h
        b1, b2 = h["b1"], h["b2"]
        self.count += 1
        bc1 = 1 - b1 ** self.count
        bc2 = 1 - b2 ** self.count
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2)
                                       + h["eps"])
            if p.ndim >= 2:
                upd = upd + h["weight_decay"] * p
            p.sub_(lr * upd)
