"""On-device cartesian-grid decode of flat stream indices and its torch
twin.

Port of the reference's K2 (``repro/kernels/grid_decode.py::
_decode_kernel``).  Flat stream indices ``[start, start + chunk)`` —
variant-major, C order within a variant, exactly
:class:`repro_torch.core.grid.ChunkedGrid` semantics — decode into the
``(n_axes, chunk)`` f32 axis-value matrix and the ``(chunk,)`` int32
variant ids; tail indices clamp to ``total - 1`` (callers mask them).

The axis values come from the ``(n_axes, V * lmax)`` f32 table the port
already keeps on the device for the fused engine
(:func:`repro_torch.core.grid.fused_table2`): row ``a`` holds variant
``v``'s values at columns ``v * lmax ...``.  (The reference takes the
``(V, n_axes, Lmax)`` stack and transposes it per call.)

* :func:`grid_decode` — the wrapper around the hand-written CUDA kernel
  ``repro_torch/csrc/grid_decode.cu``, whose index arithmetic is the
  fused megakernel's (``csrc/grid_decode.cuh``).  For a CUDA tensor it
  launches the kernel or raises; for a CPU tensor it runs the twin.
* :func:`grid_decode_torch` — the plain-torch twin.

:data:`COUNTS` counts kernel launches and twin calls.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .cuda_build import launch, load_library

#: launches of the CUDA kernel / calls of the torch twin since the last
#: :func:`reset_counts`
COUNTS: Dict[str, int] = {"kernel_launches": 0, "twin_calls": 0}

_LIB = {}


def reset_counts() -> None:
    """Zero the launch / twin-call counters."""
    for key in COUNTS:
        COUNTS[key] = 0


def grid_strides(shape) -> Tuple[int, ...]:
    """C-order strides of a grid shape (last axis fastest)."""
    strides = [1] * len(shape)
    for a in range(len(shape) - 2, -1, -1):
        strides[a] = strides[a + 1] * shape[a + 1]
    return tuple(strides)


def _check(table2: torch.Tensor, shape, n_var: int, total: int, chunk: int,
           lmax: int, idx_dtype) -> None:
    n_axes, cols = table2.shape
    if n_axes != len(shape) or cols % lmax:
        raise ValueError(f"table2 {tuple(table2.shape)} does not match "
                         f"shape={tuple(shape)} and lmax={lmax}")
    if total > (cols // lmax) * n_var:
        raise ValueError(f"total={total} exceeds {cols // lmax} variants "
                         f"of {n_var} points")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if idx_dtype not in (torch.int32, torch.int64):
        raise ValueError(f"idx_dtype must be torch.int32 or torch.int64, "
                         f"got {idx_dtype}")


def grid_decode_torch(table2: torch.Tensor, start, *, shape, n_var: int,
                      total: int, chunk: int, lmax: int,
                      idx_dtype=torch.int32):
    """Decode flat indices ``[start, start + chunk)``; returns ``(vals,
    vid)``: the ``(n_axes, chunk)`` f32 axis values and the ``(chunk,)``
    int32 variant ids."""
    COUNTS["twin_calls"] += 1
    _check(table2, shape, n_var, total, chunk, lmax, idx_dtype)
    off = torch.arange(chunk, dtype=idx_dtype, device=table2.device) + start
    off = torch.clamp_max(off, total - 1)          # clamp tail; caller masks
    vid = torch.div(off, n_var, rounding_mode="floor")
    local = off - vid * n_var
    vals = torch.empty((len(shape), chunk), dtype=torch.float32,
                       device=table2.device)
    for a, (size, stride) in enumerate(zip(shape, grid_strides(shape))):
        idx_a = torch.remainder(
            torch.div(local, stride, rounding_mode="floor"), size)
        vals[a] = table2[a].index_select(0, (vid * lmax + idx_a).long())
    return vals, vid.to(torch.int32)


def load_kernel_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    lib = _LIB.get("lib")
    if lib is not None:
        return lib
    lib = load_library("grid_decode")
    lib.repro_grid_decode_max_axes.restype = ctypes.c_int
    lib.repro_grid_decode.argtypes = [
        ctypes.c_void_p, *([ctypes.c_longlong] * 4),
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
        *([ctypes.c_int] * 4), ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.repro_grid_decode.restype = ctypes.c_int
    _LIB["lib"] = lib
    return lib


def grid_decode(table2: torch.Tensor, start, *, shape, n_var: int,
                total: int, chunk: int, lmax: int, idx_dtype=torch.int32):
    """Same signature and return contract as :func:`grid_decode_torch`.

    On a CUDA tensor it launches the hand-written kernel on the current
    stream (no synchronisation) or raises; on a CPU tensor it runs the
    twin.  int32 indices need ``total + chunk < 2**31``.
    """
    dev = table2.device
    if dev.type == "cpu":
        return grid_decode_torch(table2, start, shape=shape, n_var=n_var,
                                 total=total, chunk=chunk, lmax=lmax,
                                 idx_dtype=idx_dtype)
    if dev.type != "cuda":
        raise ValueError(f"grid_decode runs on CUDA or CPU tensors, got "
                         f"{dev}")
    _check(table2, shape, n_var, total, chunk, lmax, idx_dtype)
    if table2.dtype != torch.float32 or not table2.is_contiguous():
        raise ValueError(f"table2 must be contiguous float32, got "
                         f"{table2.dtype} (contiguous="
                         f"{table2.is_contiguous()})")
    if idx_dtype == torch.int32 and total + chunk >= 2 ** 31:
        raise ValueError(f"total + chunk = {total + chunk} needs int64 "
                         f"indices")
    lib = load_kernel_library()
    n_axes = len(shape)
    if n_axes > lib.repro_grid_decode_max_axes():
        raise ValueError(f"{n_axes} axes exceed the kernel's cap of "
                         f"{lib.repro_grid_decode_max_axes()}")
    shape_c = (ctypes.c_longlong * n_axes)(*(int(s) for s in shape))
    stride_c = (ctypes.c_longlong * n_axes)(*grid_strides(shape))
    vals = torch.empty((n_axes, chunk), dtype=torch.float32, device=dev)
    vid = torch.empty((chunk,), dtype=torch.int32, device=dev)
    launch("grid_decode", lib.repro_grid_decode, dev, table2.data_ptr(),
           int(start), int(total), int(n_var), int(chunk), shape_c,
           stride_c, n_axes, int(lmax), int(table2.shape[1]),
           int(idx_dtype == torch.int64), vals.data_ptr(), vid.data_ptr())
    COUNTS["kernel_launches"] += 1
    return vals, vid
