"""Carry weights and caches between numpy trees and the port's tensors.

The reference's parameters and caches, as ``jax.tree.map(np.asarray,
tree)`` gives them, are nested dicts of numpy arrays with the port's own
layout (:mod:`repro_torch.models.model` keeps the reference's paths,
shapes and dtypes), so carrying them across is a dtype-preserving copy.

A bf16 array from the reference has the ``ml_dtypes`` dtype named
``"bfloat16"``, which ``torch.from_numpy`` refuses; it is recognised by
that name (nothing of ``ml_dtypes`` or jax is imported) and carried
through an int16 view of its bits, so the port's bf16 tensor holds the
same bits.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..kernels.runtime import resolve_device


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a.view(np.int16), copy=True))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree: Dict[str, Any], device="cuda") -> Dict:
    """A nested dict of numpy arrays -> the same dict of tensors on
    ``device`` (default ``cuda``; without a GPU that raises), dtype for
    dtype and bit for bit."""
    device = resolve_device(device)
    return _map(lambda a: _tensor(a, device), tree)


def cache_from_numpy(tree: Dict[str, Any], device="cuda") -> Dict:
    """The same for a cache (``pos`` stays a 0-d int32 tensor)."""
    return params_from_numpy(tree, device)


def to_numpy(tree) -> Any:
    """Tensors (nested in dicts) -> numpy copies on the host (never a
    view: ``decode_step`` later writes the cache in place).  bf16 widens
    to f32, which is exact; every other dtype is kept."""
    def one(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return np.array(t.numpy(), copy=True)
    return _map(one, tree)
