"""Stencil convolution ('valid' 2-D correlation) and its torch twin.

Port of the reference's K6 (``repro/kernels/stencil_conv.py::
_stencil_kernel``), the functional simulator's edge detector (Fig. 5, the
Rhythmic compare & sample proxy): ``image [H, W]`` against a ``kh x kw``
stencil gives ``[H - kh + 1, W - kw + 1]`` in the image's dtype.

* :func:`stencil_conv` — the wrapper around the hand-written CUDA kernels
  ``repro_torch/csrc/stencil_conv.cu``.  It takes a 2-D frame and a 2-D
  stencil, each f32, f16 or bf16, of any size whose staged tile fits in
  shared memory, and sums in f32 as the reference's Pallas kernel does.
  :func:`plan` picks the route and the output tile from the shape, dtype,
  alignment and SM count before the launch: ``"k3x3"`` (a 3 x 3 stencil,
  the taps in registers, a window of three rows sliding down each
  thread's strip of outputs), ``"generic"`` (any other stencil) and
  ``"scalar"`` (a frame whose base or row pitch is not 16-byte aligned:
  no 16-byte copies).  For a CUDA tensor it launches the kernel or
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

:data:`COUNTS` counts kernel launches, in all and by route, and twin
calls.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional

import torch

from .cuda_build import check_operands, launch, load_library, sm_count

#: launches of the CUDA kernels (in all, and by route) / calls of the torch
#: twin since the last :func:`reset_counts`
COUNTS: Dict[str, int] = {"kernel_launches": 0, "k3x3_launches": 0,
                          "generic_launches": 0, "scalar_launches": 0,
                          "twin_calls": 0}

#: frame dtypes the kernel takes, with their codes in the C interface
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_DTYPE_LIST = tuple(_DTYPES)
#: the routes, with their codes in the C interface
ROUTES = {"k3x3": 0, "generic": 1, "scalar": 2}
#: threads of a block, and across its columns, by route (the .cu source's
#: kFixedX and kGenericX)
_THREADS = 128
_THREADS_X = {"k3x3": 16, "generic": 32, "scalar": 32}
#: output rows a thread, tried largest first
ROW_CHOICES = (8, 4, 2, 1)
#: a plan takes the most rows a thread whose blocks number at least this
#: many an SM.  Measured on an H100 (chip_smoke.py's stencil_probe, k3x3,
#: device ms by rows 8 / 4 / 2 / 1): 720 x 1280 f32 0.0045 / 0.0036 /
#: 0.0035 / 0.0038 (240 / 460 / 900 / 1800 blocks); 360 x 640 0.0040 /
#: 0.0027 / 0.0022 / 0.0021 (60 / 120 / 230 / 450); 720 x 1280 bf16
#: 0.0046 / 0.0036 / 0.0034 / 0.0032 (120 / 230 / 450 / 900).  With one
#: or two blocks an SM the copies of a block wait with nothing to hide
#: them; past three the gain is within the run-to-run spread.
_BLOCKS_PER_SM = 3
#: the shared memory a block may stage (227 KB, the opt-in ceiling)
MAX_SMEM = 232448

_LIB = {}


class Plan(NamedTuple):
    """How one call runs: its route, the output rows a thread (``rows``),
    the output tile of a block (``tile_h`` x ``tile_w``) and the bytes it
    stages in shared memory."""
    route: str
    rows: int
    tile_h: int
    tile_w: int
    smem: int


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
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.repro_stencil_conv.restype = ctypes.c_int
    _LIB["lib"] = lib
    return lib


def _smem_bytes(route: str, kh: int, kw: int, rows: int, tile_w: int,
                size: int) -> int:
    """Shared-memory bytes of one block (``smem_bytes`` in the .cu
    source): ``rows * threads_y + kh - 1`` staged rows of the tile's
    ``tile_w + kw - 1`` columns, rounded up to whole 16-byte vectors (the
    k3x3 route stages one vector more: each thread reads two)."""
    vec = 16 // size
    sh = rows * (_THREADS // _THREADS_X[route]) + kh - 1
    if route == "k3x3":
        sw = tile_w + vec
    else:
        sw = -(-(tile_w + kw - 1) // vec) * vec
    return sh * sw * size


@functools.lru_cache(maxsize=None)
def plan(h: int, w: int, kh: int, kw: int, dtype: torch.dtype,
         aligned: bool, n_sm: int) -> Plan:
    """The :class:`Plan` of a 'valid' ``kh x kw`` stencil over an ``[h, w]``
    frame of ``dtype`` on a card with ``n_sm`` SMs.

    The route: ``"scalar"`` unless the frame's base is 16-byte ``aligned``
    and its row pitch is a whole number of 16-byte vectors; else
    ``"k3x3"`` for a 3 x 3 stencil and ``"generic"`` for any other.  The
    tile is the first, of those that fit in shared memory, whose blocks
    number at least three an SM, trying ``tile_w`` widest first and, for
    each width, ``rows`` (output rows a thread) 8, 4, 2, 1.  The k3x3
    route has one width, 64 f32 or 128 f16/bf16 columns; the generic and
    scalar routes also try narrower ones, in steps of 32.  So a frame
    small for its tile still fills the card; one too small for three
    blocks an SM at any tile takes the last that fits: the narrowest, one
    row a thread.  A tall stencil whose wide tile does not fit also takes
    a narrower one.  Raises ``ValueError`` when no tile of the stencil
    fits in shared memory."""
    oh, ow = h - kh + 1, w - kw + 1
    size = dtype.itemsize
    vec = 16 // size
    if not aligned or (w * size) % 16:
        route = "scalar"
    elif (kh, kw) == (3, 3):
        route = "k3x3"
    else:
        route = "generic"
    threads_x = _THREADS_X[route]
    threads_y = _THREADS // threads_x
    if route == "k3x3":
        widths = (threads_x * vec,)
    else:                       # nv columns a thread, 32 apart
        widths = tuple(threads_x * nv for nv in range(vec // 2, 0, -1))
    fits = [(tile_w, rows) for tile_w in widths for rows in ROW_CHOICES
            if _smem_bytes(route, kh, kw, rows, tile_w, size) <= MAX_SMEM]
    if not fits:
        raise ValueError(
            f"a {kh} x {kw} stencil stages "
            f"{_smem_bytes(route, kh, kw, 1, threads_x, size)} bytes, above "
            f"the kernel's shared-memory cap of {MAX_SMEM}")
    for tile_w, rows in fits:
        if -(-oh // (threads_y * rows)) * -(-ow // tile_w) \
                >= _BLOCKS_PER_SM * n_sm:
            break
    return Plan(route, rows, threads_y * rows, tile_w,
                _smem_bytes(route, kh, kw, rows, tile_w, size))


def stencil_conv(image: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """'valid' 2-D correlation of a frame with a stencil, f32 accumulation,
    in the frame's dtype.

    On a CUDA tensor it launches the kernel of :func:`plan` on the current
    stream (no synchronisation) or raises; on a CPU tensor it runs the
    twin at f32 accumulation.  Frame and stencil are f32, f16 or bf16; the
    kernel takes them contiguous, on one device (the stencil is handed to
    it as f32, an exact conversion).
    """
    _out_shape(image, kernel)
    if image.dtype not in _DTYPES or kernel.dtype not in _DTYPES:
        raise ValueError(f"stencil_conv takes a float32, float16 or "
                         f"bfloat16 image and stencil, got {image.dtype} "
                         f"and {kernel.dtype}")
    dev = image.device
    if not image.is_cuda:
        if dev.type == "cpu" and kernel.device.type == "cpu":
            return stencil_conv_torch(image, kernel, acc_dtype=torch.float32)
        raise ValueError(f"stencil_conv runs on CUDA or CPU tensors, got "
                         f"{dev} and {kernel.device}")
    # the dtypes are checked above and the frame lies on its own device:
    # the layouts and the stencil's device are left (check_operands raises
    # with the reason)
    if not (image.is_contiguous() and kernel.is_contiguous()
            and kernel.device == dev):
        check_operands("stencil_conv", dev, _DTYPE_LIST, image=image,
                       kernel=kernel)
    (h, w), (kh, kw) = image.shape, kernel.shape
    p = plan(h, w, kh, kw, image.dtype, image.data_ptr() % 16 == 0,
             sm_count(dev))
    return _launch(image, kernel, p, dev, h, w, kh, kw)


def run(image: torch.Tensor, kernel: torch.Tensor, p: Plan) -> torch.Tensor:
    """Launch plan ``p`` for CUDA operands that :func:`stencil_conv` has
    checked; returns the output."""
    (h, w), (kh, kw) = image.shape, kernel.shape
    return _launch(image, kernel, p, image.device, h, w, kh, kw)


def _launch(image, kernel, p: Plan, dev, h, w, kh, kw) -> torch.Tensor:
    if kernel.dtype != torch.float32:
        kernel = kernel.float()
    out = image.new_empty((h - kh + 1, w - kw + 1))
    launch("stencil_conv", load_kernel_library().repro_stencil_conv, dev,
           image.data_ptr(), kernel.data_ptr(), out.data_ptr(),
           _DTYPES[image.dtype], h, w, kh, kw, ROUTES[p.route], p.rows,
           p.tile_w // _THREADS_X[p.route])
    COUNTS[f"{p.route}_launches"] += 1
    COUNTS["kernel_launches"] += 1
    return out
