"""Frame differencing + threshold (the Ed-Gaze event map) and its torch
twin.

Port of the reference's K7 (``repro/kernels/frame_event.py::
_event_kernel``): ``(|f32(cur) - f32(prev)| >= threshold)`` written in
``cur.dtype``, 1 for an event, 0 otherwise (a NaN difference gives 0).
The threshold is compared in float32, as the reference compares it: the
wrapper hands it to the kernel as a C ``float`` and the twin rounds it to
f32 first (``cur = f32(0.7)``, ``prev = 0``, ``threshold = 0.7`` is an
event in f32 and none in f64).

* :func:`frame_event` — the wrapper around the hand-written CUDA kernel
  ``repro_torch/csrc/frame_event.cu`` (one thread per element, float4
  loads where aligned).  It takes two 2-D frames of one shape and one
  dtype, f32 or f16.  For a CUDA tensor it launches the kernel or
  raises; for a CPU tensor it runs the twin.
* :func:`frame_event_torch` — the plain-torch twin
  (``repro.kernels.ref.frame_event_ref``); kernel and twin agree bit for
  bit.

What bounds the kernel on the card: the bytes, two reads and one write
per element (0.77 MB for the 200 x 320 f32 frames of Ed-Gaze, 0.23 us at
3.35 TB/s).

:data:`COUNTS` counts kernel launches and twin calls.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from .cuda_build import check_operands, launch, load_library

#: launches of the CUDA kernel / calls of the torch twin since the last
#: :func:`reset_counts`
COUNTS: Dict[str, int] = {"kernel_launches": 0, "twin_calls": 0}

#: dtypes the kernel takes, with their codes in the C interface
_DTYPES = {torch.float32: 0, torch.float16: 1}

_LIB = {}


def reset_counts() -> None:
    """Zero the launch / twin-call counters."""
    for key in COUNTS:
        COUNTS[key] = 0


def _check_shapes(cur: torch.Tensor, prev: torch.Tensor) -> None:
    if cur.shape != prev.shape:
        raise ValueError(f"frame_event takes two frames of one shape, got "
                         f"{tuple(cur.shape)} and {tuple(prev.shape)}")


def frame_event_torch(cur: torch.Tensor, prev: torch.Tensor,
                      threshold: float = 0.1) -> torch.Tensor:
    """The event map ``|cur - prev| >= threshold`` in ``cur.dtype``."""
    COUNTS["twin_calls"] += 1
    _check_shapes(cur, prev)
    diff = (cur.to(torch.float32)
            - prev.to(device=cur.device, dtype=torch.float32)).abs()
    return (diff >= float(np.float32(threshold))).to(cur.dtype)


def load_kernel_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    lib = _LIB.get("lib")
    if lib is not None:
        return lib
    lib = load_library("frame_event")
    lib.repro_frame_event.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
    lib.repro_frame_event.restype = ctypes.c_int
    _LIB["lib"] = lib
    return lib


def frame_event(cur: torch.Tensor, prev: torch.Tensor,
                threshold: float = 0.1) -> torch.Tensor:
    """``|cur - prev| >= threshold`` over two 2-D frames, in ``cur.dtype``.

    On a CUDA tensor it launches the hand-written kernel on the current
    stream (no synchronisation) or raises; on a CPU tensor it runs the
    twin.  Both frames are f32 or f16, of one dtype; the kernel takes them
    contiguous.
    """
    _check_shapes(cur, prev)
    if cur.dim() != 2 or cur.dtype not in _DTYPES or prev.dtype != cur.dtype:
        raise ValueError(f"frame_event takes two 2-D frames of one dtype, "
                         f"float32 or float16, got {tuple(cur.shape)} "
                         f"{cur.dtype} and {prev.dtype}")
    dev = cur.device
    if dev.type == "cpu" and prev.device.type == "cpu":
        return frame_event_torch(cur, prev, threshold)
    if dev.type != "cuda":
        raise ValueError(f"frame_event runs on CUDA or CPU tensors, got "
                         f"{dev} and {prev.device}")
    check_operands("frame_event", dev, tuple(_DTYPES), cur=cur, prev=prev)
    out = torch.empty_like(cur)
    if out.numel() == 0:
        return out
    lib = load_kernel_library()
    launch("frame_event", lib.repro_frame_event, dev, cur.data_ptr(),
           prev.data_ptr(), out.data_ptr(), _DTYPES[cur.dtype], cur.numel(),
           float(threshold))
    COUNTS["kernel_launches"] += 1
    return out
