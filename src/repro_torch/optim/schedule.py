"""Learning-rate schedules (torch counterpart of
``src/repro/optim/schedule.py``): pure functions of the step.

The step is an int or a 0-d integer tensor; the rate is a 0-d f32
tensor on the step's device (the CPU for an int), computed in f32 on
that device as the reference computes it under ``jit`` on a traced
int32 step.  Nothing is read back to the host.  XLA fuses and folds
these few ops, so the two agree to a few ulp (rel < 1e-6), not bit for
bit.
"""
from __future__ import annotations

import math

import torch


def _step_tensor(step, device=None) -> torch.Tensor:
    """``step`` as a 0-d int32 tensor (a fill on ``device``, not a host
    copy, for an int: a blocking copy would sync the device)."""
    if isinstance(step, torch.Tensor):
        return step.to(torch.int32)
    return torch.full((), int(step), dtype=torch.int32, device=device)


def cosine_schedule(step, base_lr: float, total_steps: int,
                    min_ratio: float = 0.1, device=None) -> torch.Tensor:
    step = _step_tensor(step, device)
    frac = torch.clamp(step / max(total_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return base_lr * (min_ratio + (1 - min_ratio) * cos)


def linear_warmup_cosine(step, base_lr: float, warmup_steps: int,
                         total_steps: int, min_ratio: float = 0.1,
                         device=None) -> torch.Tensor:
    step = _step_tensor(step, device)
    warm = base_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
    decay = cosine_schedule(torch.clamp(step - warmup_steps, min=0),
                            base_lr, max(total_steps - warmup_steps, 1),
                            min_ratio)
    return torch.where(step < warmup_steps, warm, decay)
