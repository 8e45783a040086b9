"""Frame differencing + threshold (the Ed-Gaze event map) and its torch
twin.

Port of the reference's K7 (``repro/kernels/frame_event.py::
_event_kernel``): ``(|f32(cur) - f32(prev)| >= threshold)`` written in
``cur.dtype``, 1 for an event, 0 otherwise (a NaN difference gives 0).
The threshold is compared in float32, as the reference compares it: the
wrapper hands it to the kernel as a C ``float`` and the twin rounds it to
f32 first (``cur = f32(0.7)``, ``prev = 0``, ``threshold = 0.7`` is an
event in f32 and none in f64).

* :func:`frame_event` — the wrapper around the hand-written CUDA kernels
  ``repro_torch/csrc/frame_event.cu``.  It takes two 2-D frames of one
  shape and one dtype, f32, f16 or bf16.  :func:`plan` picks the route
  before the launch: ``"vec4"`` (f32) or ``"vec8"``
  (f16/bf16), one 16-byte load of each frame and one 16-byte store a
  thread, where the element count is a whole number of 16-byte vectors
  and both frames' bases are 16-byte aligned; ``"scalar"`` (one element
  a thread) otherwise.  For a CUDA tensor it launches the kernel or
  raises; for a CPU tensor it runs the twin.
* :func:`frame_event_torch` — the plain-torch twin
  (``repro.kernels.ref.frame_event_ref``); kernel and twin agree bit for
  bit.

What bounds the kernel on the card: the bytes, two reads and one write
per element (0.77 MB for the 200 x 320 f32 frames of Ed-Gaze, 0.23 us at
3.35 TB/s).  At that size the launch itself is most of a call's device
time: ``chip_smoke.py`` measures that floor on a frame of one vector.

:data:`COUNTS` counts kernel launches, in all and by route, and twin
calls.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from .cuda_build import check_operands, launch, load_library

#: launches of the CUDA kernels (in all, and by route) / calls of the torch
#: twin since the last :func:`reset_counts`
COUNTS: Dict[str, int] = {"kernel_launches": 0, "vec4_launches": 0,
                          "vec8_launches": 0, "scalar_launches": 0,
                          "twin_calls": 0}

#: dtypes the kernel takes, with their codes in the C interface
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

_LIB = {}


def reset_counts() -> None:
    """Zero the launch / twin-call counters."""
    for key in COUNTS:
        COUNTS[key] = 0


def plan(n: int, dtype: torch.dtype, aligned: bool) -> str:
    """The route for frames of ``n`` elements of ``dtype``: ``"vec4"``
    (f32) or ``"vec8"`` (f16/bf16), 16 bytes of each frame a thread, where
    ``n`` is a whole number of 16-byte vectors and the frames are 16-byte
    ``aligned``; ``"scalar"`` (one element a thread) otherwise."""
    vec = 16 // dtype.itemsize
    return f"vec{vec}" if aligned and n % vec == 0 else "scalar"


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
        ctypes.c_longlong, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.repro_frame_event.restype = ctypes.c_int
    _LIB["lib"] = lib
    return lib


def frame_event(cur: torch.Tensor, prev: torch.Tensor,
                threshold: float = 0.1) -> torch.Tensor:
    """``|cur - prev| >= threshold`` over two 2-D frames, in ``cur.dtype``.

    On a CUDA tensor it launches the kernel of :func:`plan` on the
    current stream (no synchronisation) or raises; on a CPU tensor it runs
    the twin.  Both frames are f32, f16 or bf16, of one dtype; the kernel
    takes them contiguous (an unaligned view takes the scalar route).
    """
    _check_shapes(cur, prev)
    if cur.dim() != 2 or cur.dtype not in _DTYPES or prev.dtype != cur.dtype:
        raise ValueError(f"frame_event takes two 2-D frames of one dtype, "
                         f"float32, float16 or bfloat16, got "
                         f"{tuple(cur.shape)} {cur.dtype} and {prev.dtype}")
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
    route = plan(cur.numel(), cur.dtype,
                 (cur.data_ptr() | prev.data_ptr() | out.data_ptr()) % 16 == 0)
    launch("frame_event", load_kernel_library().repro_frame_event, dev,
           cur.data_ptr(), prev.data_ptr(), out.data_ptr(),
           _DTYPES[cur.dtype], cur.numel(), float(threshold),
           route != "scalar")
    COUNTS[f"{route}_launches"] += 1
    COUNTS["kernel_launches"] += 1
    return out
