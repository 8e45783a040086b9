"""Sweep-backend selection for the fused streaming sweep.

Mirrors ``repro.kernels.runtime.resolve_backend`` / ``explicit_backend``
with the port's two execution backends:

* ``"cuda"``  — the hand-written CUDA megakernel
  (``repro_torch/csrc/fused_sweep.cu``), CUDA tensors only;
* ``"torch"`` — its plain-torch twin
  (``repro_torch.kernels.fused_sweep.fused_sweep_block_torch``), any
  device.

``"auto"`` resolves by device: ``"cuda"`` on a CUDA device, ``"torch"``
on the CPU.  The ``REPRO_TORCH_SWEEP_BACKEND`` environment variable
overrides the auto policy; an explicit ``backend=`` argument always wins
over the environment.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

_BACKEND_ENV_VAR = "REPRO_TORCH_SWEEP_BACKEND"
#: valid sweep backends: "auto" resolves by device (cuda on a CUDA
#: device, torch on the CPU); explicit values force the lane
SWEEP_BACKENDS = ("auto", "cuda", "torch")


def _check(value: str, source: str) -> str:
    if value not in SWEEP_BACKENDS:
        raise ValueError(f"invalid {source}={value!r}; valid values: "
                         f"{list(SWEEP_BACKENDS)}")
    return value


def _backend_env_override() -> Optional[str]:
    raw = os.environ.get(_BACKEND_ENV_VAR)
    if raw is None:
        return None
    value = raw.strip().lower()
    if value in ("", "auto"):
        return None
    return _check(value, _BACKEND_ENV_VAR)


def explicit_backend(backend: Optional[str] = None) -> Optional[str]:
    """The explicitly REQUESTED backend, or None under the auto policy.

    An explicit ``backend=`` argument wins over
    ``REPRO_TORCH_SWEEP_BACKEND``; ``None``/``"auto"`` with no env
    override returns None (the device default applies).
    """
    if backend is not None and backend != "auto":
        return _check(backend, "backend")
    return _backend_env_override()


def resolve_backend(backend: Optional[str] = None,
                    device="cuda") -> str:
    """Resolve the fused-sweep backend to ``"cuda"`` or ``"torch"``.

    ``None``/``"auto"`` consults ``REPRO_TORCH_SWEEP_BACKEND`` and then
    the device default; ``"cuda"`` on a CPU device raises instead of
    quietly running the twin.
    """
    device = torch.device(device)
    requested = explicit_backend(backend)
    if requested is None:
        requested = "cuda" if device.type == "cuda" else "torch"
    if requested == "cuda" and device.type != "cuda":
        raise ValueError(f"backend='cuda' runs the CUDA kernel and needs a "
                         f"CUDA device, got device={str(device)!r}; use "
                         f"backend='torch' (or 'auto') on the CPU")
    return requested


def resolve_device(device="cuda") -> torch.device:
    """The sweep device; a CUDA request without a usable GPU raises.

    Entry points never fall back to the CPU on their own: a caller that
    wants the CPU passes ``device="cpu"``.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available()"
            f" is False; pass device='cpu' to run the plain-torch twin on "
            f"the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}; valid: "
                         f"'cuda[:N]' or 'cpu'")
    return device
