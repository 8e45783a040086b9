"""Pixel binning (factor x factor average pooling, stride factor) and its
torch twin.

Port of the reference's K5 (``repro/kernels/binning.py::
_binning_kernel``), the CIS "binned readout" stage of the functional
simulator (Fig. 5, Ed-Gaze S1).  Odd edges are cropped first, as the
reference crops them; the window mean accumulates in f32 and is written
in the input's dtype.

* :func:`binning` — the wrapper around the hand-written CUDA kernels
  ``repro_torch/csrc/binning.cu``.  It takes a 2-D f32, f16 or bf16
  frame, as the Pallas kernel does.  :func:`plan` picks the kernel from
  the shape, dtype and alignment before the launch: ``"vec2"`` (factor 2,
  2 adjacent f32 outputs or 4 f16/bf16 ones a thread, from one 16-byte
  load of each input row) where the frame's base is 16-byte aligned and
  its rows are whole 16-byte vectors; ``"scalar"`` (one thread per output
  pixel) otherwise.  For a CUDA tensor it launches the kernel or raises;
  for a CPU tensor it runs the twin.
* :func:`binning_torch` — the plain-torch twin, also over leading batch
  dims (``repro.kernels.ref.binning_ref``'s contract): each window summed
  from 0 row by row (``di`` outer, ``dj`` inner), then multiplied by
  ``f32(1 / factor**2)``.  That is the reference kernel's result bit for
  bit, and the CUDA kernel's order.

What bounds the kernel on the card: the bytes, ``(factor**2 + 1)``
elements per output pixel (1.28 MB for a 400 x 640 f32 frame at factor
2, 0.38 us at 3.35 TB/s).

:data:`COUNTS` counts kernel launches, in all and by route, and twin
calls.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import numpy as np
import torch

from .cuda_build import check_operands, launch, load_library

#: launches of the CUDA kernels (in all, and by route) / calls of the torch
#: twin since the last :func:`reset_counts`
COUNTS: Dict[str, int] = {"kernel_launches": 0, "vec2_launches": 0,
                          "scalar_launches": 0, "twin_calls": 0}

#: dtypes the kernel takes, with their codes in the C interface
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_DTYPE_LIST = tuple(_DTYPES)

_LIB = {}


def reset_counts() -> None:
    """Zero the launch / twin-call counters."""
    for key in COUNTS:
        COUNTS[key] = 0


@functools.lru_cache(maxsize=None)
def _reciprocal(factor: int) -> float:
    """``f32(1 / factor**2)``, the window mean's multiplier."""
    return float(np.float32(1.0 / (factor * factor)))


@functools.lru_cache(maxsize=None)
def plan(w: int, factor: int, dtype: torch.dtype, aligned: bool) -> str:
    """The kernel that bins a frame of ``w`` columns of ``dtype`` by
    ``factor`` on the card: ``"vec2"`` for factor 2 where the frame's base
    is 16-byte ``aligned`` and its rows of ``w`` are whole 16-byte vectors
    (each thread reads 16 bytes of each of its two rows and writes 8, 2
    f32 or 4 f16/bf16 outputs); ``"scalar"`` otherwise."""
    if factor == 2 and aligned and (w * dtype.itemsize) % 16 == 0:
        return "vec2"
    return "scalar"


def _check_factor(factor) -> None:
    if not isinstance(factor, int) or factor < 1:
        raise ValueError(f"binning factor must be a positive int, got "
                         f"{factor!r}")


def binning_torch(image: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """``[..., H, W] -> [..., H // factor, W // factor]`` window means."""
    COUNTS["twin_calls"] += 1
    _check_factor(factor)
    h, w = image.shape[-2:]
    hh, ww = h // factor, w // factor
    acc_dtype = torch.promote_types(image.dtype, torch.float32)
    x = image[..., : hh * factor, : ww * factor].to(acc_dtype)
    acc = torch.zeros(x.shape[:-2] + (hh, ww), dtype=acc_dtype,
                      device=x.device)
    for di in range(factor):
        for dj in range(factor):
            acc = acc + x[..., di::factor, dj::factor]
    return (acc * _reciprocal(factor)).to(image.dtype)


def load_kernel_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    lib = _LIB.get("lib")
    if lib is not None:
        return lib
    lib = load_library("binning")
    lib.repro_binning.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p]
    lib.repro_binning.restype = ctypes.c_int
    lib.repro_binning_noop.argtypes = []
    lib.repro_binning_noop.restype = ctypes.c_int
    lib.repro_binning_launch_us.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.repro_binning_launch_us.restype = ctypes.c_double
    _LIB["lib"] = lib
    return lib


def binning(image: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """factor x factor average pool with stride factor over a 2-D frame.

    On a CUDA tensor it launches the kernel of :func:`plan` on the
    current stream (no synchronisation) or raises; on a CPU tensor it runs
    the twin.  The frame is f32, f16 or bf16; the kernel takes it
    contiguous.
    """
    _check_factor(factor)
    if image.dim() != 2 or image.dtype not in _DTYPES:
        raise ValueError(f"binning takes a 2-D float32, float16 or "
                         f"bfloat16 frame, got {tuple(image.shape)} "
                         f"{image.dtype}")
    if not image.is_cuda:
        if image.device.type == "cpu":
            return binning_torch(image, factor)
        raise ValueError(f"binning runs on CUDA or CPU tensors, got "
                         f"{image.device}")
    # the dtype is checked above and the frame lies on its own device:
    # only its layout is left (check_operands raises with the reason)
    if not image.is_contiguous():
        check_operands("binning", image.device, _DTYPE_LIST, image=image)
    h, w = image.shape
    oh, ow = h // factor, w // factor
    out = image.new_empty((oh, ow))
    if out.numel() == 0:
        return out
    ptr = image.data_ptr()
    route = plan(w, factor, image.dtype, ptr % 16 == 0)
    lib = load_kernel_library()
    launch("binning", lib.repro_binning, image.device, ptr, out.data_ptr(),
           _DTYPES[image.dtype], w, oh, ow, factor, _reciprocal(factor),
           route == "vec2")
    COUNTS[f"{route}_launches"] += 1
    COUNTS["kernel_launches"] += 1
    return out
