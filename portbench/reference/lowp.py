"""The control: the reference computed one precision below the
configuration's.

The configurations state bfloat16, so the control rounds both operands
of every product to float8 e4m3, each tensor scaled by its own absolute
maximum (the usual per-tensor recipe of fp8 training and serving), and
computes in float32 from the rounded values.  The gradient passes the
rounding unchanged (straight through), as fp8 training recipes do.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - x.detach())


CASTS = {"fp8": fp8}
