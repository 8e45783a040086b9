"""Stencil convolution ('valid' 2-D correlation) and its torch twin.

Port of the reference's K6 (``repro/kernels/stencil_conv.py::
_stencil_kernel``), the functional simulator's edge detector (Fig. 5, the
Rhythmic compare & sample proxy): ``image [H, W]`` against a ``kh x kw``
stencil gives ``[H - kh + 1, W - kw + 1]`` in the image's dtype.

* :func:`stencil_conv` — the wrapper around the hand-written CUDA kernel
  ``repro_torch/csrc/stencil_conv.cu`` (a 32 x 32 output tile per block,
  its inputs and the taps staged in shared memory as f32).  It takes a
  2-D frame and a 2-D stencil, each f32, f16 or bf16, of any size whose
  staged tile fits in shared memory, and sums in f32 as the reference's
  Pallas kernel does.  For a CUDA tensor it launches the kernel or
  raises; for a CPU tensor it runs the twin at f32 accumulation.
* :func:`stencil_conv_torch` — the plain-torch twin: the taps summed from
  0 in ``di``-outer, ``dj``-inner order, one multiply and one add each,
  in ``acc_dtype`` (by default the promoted dtype of image and stencil,
  as ``repro.kernels.ref.stencil_conv_ref`` sums), then cast to the
  image's dtype.  It equals ``stencil_conv_ref`` bit for bit, and the
  kernel (built with ``--fmad=false``) equals it at ``acc_dtype=
  torch.float32``; the reference's Pallas kernel differs from both by up
  to ~1e-7 of the output's magnitude, and by one rounding of a half
  dtype.

What bounds the kernel on the card: the bytes, one read of the frame and
one write of the output (7.36 MB for a 720 x 1280 f32 frame and a 3 x 3
stencil, 2.2 us at 3.35 TB/s; half that in f16 or bf16).

:data:`COUNTS` counts kernel launches and twin calls.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from .cuda_build import check_operands, launch, load_library

#: launches of the CUDA kernel / calls of the torch twin since the last
#: :func:`reset_counts`
COUNTS: Dict[str, int] = {"kernel_launches": 0, "twin_calls": 0}

#: frame dtypes the kernel takes, with their codes in the C interface
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

_LIB = {}


def reset_counts() -> None:
    """Zero the launch / twin-call counters."""
    for key in COUNTS:
        COUNTS[key] = 0


def _out_shape(image: torch.Tensor, kernel: torch.Tensor):
    if image.dim() != 2 or kernel.dim() != 2:
        raise ValueError(f"stencil_conv takes a 2-D image and a 2-D "
                         f"stencil, got {tuple(image.shape)} and "
                         f"{tuple(kernel.shape)}")
    (h, w), (kh, kw) = image.shape, kernel.shape
    if not (1 <= kh <= h and 1 <= kw <= w):
        raise ValueError(f"a {kh} x {kw} stencil has no 'valid' output on "
                         f"a {h} x {w} image")
    return h - kh + 1, w - kw + 1


def stencil_conv_torch(image: torch.Tensor, kernel: torch.Tensor,
                       acc_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """'valid' correlation ``[H, W] * [kh, kw] -> [H-kh+1, W-kw+1]``,
    summed in ``acc_dtype`` (default: the promoted dtype of image and
    stencil) and returned in the image's dtype."""
    COUNTS["twin_calls"] += 1
    oh, ow = _out_shape(image, kernel)
    kh, kw = kernel.shape
    if acc_dtype is None:
        acc_dtype = torch.promote_types(image.dtype, kernel.dtype)
    x = image.to(acc_dtype)
    k = kernel.to(device=image.device, dtype=acc_dtype)
    out = torch.zeros((oh, ow), dtype=acc_dtype, device=image.device)
    for di in range(kh):
        for dj in range(kw):
            out = out + k[di, dj] * x[di:di + oh, dj:dj + ow]
    return out.to(image.dtype)


def load_kernel_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    lib = _LIB.get("lib")
    if lib is not None:
        return lib
    lib = load_library("stencil_conv")
    lib.repro_stencil_conv.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.repro_stencil_conv.restype = ctypes.c_int
    lib.repro_stencil_conv_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.repro_stencil_conv_smem_bytes.restype = ctypes.c_longlong
    lib.repro_stencil_conv_max_smem.restype = ctypes.c_longlong
    _LIB["lib"] = lib
    return lib


def stencil_conv(image: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """'valid' 2-D correlation of a frame with a stencil, f32 accumulation,
    in the frame's dtype.

    On a CUDA tensor it launches the hand-written kernel on the current
    stream (no synchronisation) or raises; on a CPU tensor it runs the
    twin at f32 accumulation.  Frame and stencil are f32, f16 or bf16; the
    kernel takes them contiguous, on one device (the stencil is handed to
    it as f32, an exact conversion).
    """
    oh, ow = _out_shape(image, kernel)
    if image.dtype not in _DTYPES or kernel.dtype not in _DTYPES:
        raise ValueError(f"stencil_conv takes a float32, float16 or "
                         f"bfloat16 image and stencil, got {image.dtype} "
                         f"and {kernel.dtype}")
    dev = image.device
    if dev.type == "cpu" and kernel.device.type == "cpu":
        return stencil_conv_torch(image, kernel, acc_dtype=torch.float32)
    if dev.type != "cuda":
        raise ValueError(f"stencil_conv runs on CUDA or CPU tensors, got "
                         f"{dev} and {kernel.device}")
    check_operands("stencil_conv", dev, tuple(_DTYPES), image=image,
                   kernel=kernel)
    if kernel.dtype != torch.float32:
        kernel = kernel.float()
    lib = load_kernel_library()
    kh, kw = kernel.shape
    smem = lib.repro_stencil_conv_smem_bytes(kh, kw)
    if smem > lib.repro_stencil_conv_max_smem():
        raise ValueError(f"a {kh} x {kw} stencil stages {smem} bytes, above "
                         f"the kernel's shared-memory cap of "
                         f"{lib.repro_stencil_conv_max_smem()}")
    out = torch.empty((oh, ow), dtype=image.dtype, device=dev)
    h, w = image.shape
    launch("stencil_conv", lib.repro_stencil_conv, dev, image.data_ptr(),
           kernel.data_ptr(), out.data_ptr(), _DTYPES[image.dtype], h, w, kh,
           kw)
    COUNTS["kernel_launches"] += 1
    return out
