"""Per-category energy accumulation ``[B, U] @ [U, C] -> [B, C]`` and its
torch twin.

Port of the reference's K4 (``repro/kernels/category_reduce.py::
_reduce_kernel``): the per-plan evaluator's ``[B, U]`` matrix of
per-unit energies folds into per-category totals (plus the total and
on-sensor columns) against a ``[U, C]`` weight matrix.

* :func:`category_reduce` — the wrapper around the hand-written CUDA
  kernel ``repro_torch/csrc/category_reduce.cu``: a block of 256 rows
  copies its contiguous ``[256, U]`` slice of the energies into shared
  memory with coalesced 16-byte loads, each thread sums its row's C
  columns in registers, and the ``[256, C]`` results leave as one
  coalesced span.  It is bound by the bytes it moves, ``4 (U + C)`` a
  row.  For a CUDA tensor it launches the kernel or raises; for a CPU
  tensor it runs the twin.
* :func:`category_reduce_torch` — the plain-torch twin: accumulates
  ``out[:, c] += e[:, u] * w[u, c]`` over ``u = 0 .. U-1`` in order, the
  kernel's order, so the two agree bit for bit on the card.

:data:`COUNTS` counts kernel launches and twin calls.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .cuda_build import check_operands, launch, load_library

#: launches of the CUDA kernel / calls of the torch twin since the last
#: :func:`reset_counts`
COUNTS: Dict[str, int] = {"kernel_launches": 0, "twin_calls": 0}

_LIB = {}


def reset_counts() -> None:
    """Zero the launch / twin-call counters."""
    for key in COUNTS:
        COUNTS[key] = 0


def _check_shapes(unit_energy: torch.Tensor, weights: torch.Tensor):
    if unit_energy.dim() != 2 or weights.dim() != 2 \
            or unit_energy.shape[1] != weights.shape[0]:
        raise ValueError(f"category_reduce takes [B, U] @ [U, C], got "
                         f"{tuple(unit_energy.shape)} @ "
                         f"{tuple(weights.shape)}")


def category_reduce_torch(unit_energy: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """``[B, U] @ [U, C] -> [B, C]`` in f32, summed over units in order."""
    COUNTS["twin_calls"] += 1
    _check_shapes(unit_energy, weights)
    e = unit_energy.to(torch.float32)
    w = weights.to(device=e.device, dtype=torch.float32)
    out = torch.zeros((e.shape[0], w.shape[1]), dtype=torch.float32,
                      device=e.device)
    for u in range(e.shape[1]):
        out = out + e[:, u:u + 1] * w[u][None, :]
    return out


def load_kernel_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    lib = _LIB.get("lib")
    if lib is not None:
        return lib
    lib = load_library("category_reduce")
    lib.repro_category_reduce_max_cols.restype = ctypes.c_int
    lib.repro_category_reduce.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.repro_category_reduce.restype = ctypes.c_int
    _LIB["lib"] = lib
    return lib


def category_reduce(unit_energy: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """``[B, U] @ [U, C] -> [B, C]`` segment sum over hardware units.

    On a CUDA tensor it launches the hand-written kernel on the current
    stream (no synchronisation) or raises; on a CPU tensor it runs the
    twin.  Both operands are f32; the kernel takes them contiguous.
    """
    dev = unit_energy.device
    if dev.type == "cpu":
        return category_reduce_torch(unit_energy, weights)
    if dev.type != "cuda":
        raise ValueError(f"category_reduce runs on CUDA or CPU tensors, "
                         f"got {dev}")
    _check_shapes(unit_energy, weights)
    check_operands("category_reduce", dev, (torch.float32,),
                   unit_energy=unit_energy, weights=weights)
    b, u = unit_energy.shape
    c = weights.shape[1]
    lib = load_kernel_library()
    if c > lib.repro_category_reduce_max_cols():
        raise ValueError(f"{c} weight columns exceed the kernel's cap of "
                         f"{lib.repro_category_reduce_max_cols()}")
    out = torch.empty((b, c), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    launch("category_reduce", lib.repro_category_reduce, dev,
           unit_energy.data_ptr(), weights.data_ptr(), b, u, c,
           out.data_ptr())
    COUNTS["kernel_launches"] += 1
    return out
