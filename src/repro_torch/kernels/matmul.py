"""Matrix product with an f32 accumulator and its torch twin.

Port of the reference's K8 (``repro/kernels/matmul.py::_matmul_kernel``),
the functional simulator's DNN stage (Ed-Gaze S3, ``simple_dnn``):
``a [M, K] @ b [K, N] -> [M, N]`` in ``a.dtype``.

* :func:`matmul` — the wrapper around the hand-written CUDA kernels of
  ``repro_torch/csrc/matmul.cu``, FP32 on CUDA cores with explicit
  ``fmaf``: 64 x 64 shared-memory tiles for ``M > 8``, a skinny kernel
  (128 columns of ``b`` per block, 8 warps over K) for ``M <= 8``.  When
  the output tiles are fewer than the card's SMs, K is split across
  blocks into an ``[S, M, N]`` f32 scratch whose partials a second launch
  adds in slice order (no atomics: the same result on every run).  It
  takes f32 operands of any M, N, K; ragged edges are masked in the
  kernel, not padded in memory.  For a CUDA tensor it launches the kernel
  or raises; for a CPU tensor it runs the twin.  It takes no block sizes:
  ``bm``/``bn``/``bk`` were the TPU's tile knobs.
* :func:`matmul_torch` — the plain-torch twin (``repro.kernels.ref.
  matmul_ref``): f32 products summed over K in slices of broadcast
  multiplies and reductions, no library GEMM.

Kernel, twin and reference sum in different orders, so they agree within
``1e-5 * (|a| @ |b|)`` elementwise, not bit for bit.

What bounds the kernel on the card: for the DNN's ``[1, 64000] @
[64000, 900]`` the bytes (230.4 MB, 69 us at 3.35 TB/s); for a
1024^3 product the operations (2.15 GFLOP, 32 us at 67 TFLOP/s FP32).

:data:`COUNTS` counts wrapper launches (one per product, whether it takes
one device kernel or, split, two) and twin calls.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .cuda_build import check_operands, launch, load_library

#: launches of the CUDA kernel / calls of the torch twin since the last
#: :func:`reset_counts`
COUNTS: Dict[str, int] = {"kernel_launches": 0, "twin_calls": 0}

#: K depth of one slice of the tile kernel (the split unit)
_BK = 16
#: a K slice is at least this deep, so a split pays for its partials
_MIN_SLICE = 256
#: blocks to aim for per SM when splitting K
_TILE_BLOCKS_PER_SM = 2
_SKINNY_BLOCKS_PER_SM = 4
#: the twin's broadcast products hold at most this many elements at once
_TWIN_ELEMS = 1 << 24
_INT_MAX = 2 ** 31 - 1

_LIB = {}
_SMS: Dict[int, int] = {}


def reset_counts() -> None:
    """Zero the launch / twin-call counters."""
    for key in COUNTS:
        COUNTS[key] = 0


def _check_shapes(a: torch.Tensor, b: torch.Tensor) -> Tuple[int, int, int]:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul takes [M, K] @ [K, N], got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    return int(a.shape[0]), int(b.shape[1]), int(a.shape[1])


def matmul_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an f32 accumulator, in ``a.dtype``."""
    COUNTS["twin_calls"] += 1
    m, n, k = _check_shapes(a, b)
    a32 = a.to(torch.float32)
    b32 = b.to(device=a.device, dtype=torch.float32)
    out = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    step = max(1, _TWIN_ELEMS // max(m * n, 1))
    for k0 in range(0, k, step):
        out = out + (a32[:, k0:k0 + step, None]
                     * b32[None, k0:k0 + step, :]).sum(dim=1)
    return out.to(a.dtype)


def load_kernel_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    lib = _LIB.get("lib")
    if lib is not None:
        return lib
    lib = load_library("matmul")
    lib.repro_matmul_skinny_max_m.restype = ctypes.c_int
    lib.repro_matmul.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.repro_matmul.restype = ctypes.c_int
    _LIB["lib"] = lib
    return lib


def split_plan(m: int, n: int, k: int, sms: int,
               skinny_max_m: int = 8) -> Tuple[bool, int, int]:
    """``(skinny, splits, slice_depth)`` of one product on a card with
    ``sms`` SMs: K is split only while the output tiles leave SMs idle,
    and no slice is shallower than 256 rows of K (or K itself)."""
    skinny = m <= skinny_max_m
    if skinny:
        tiles, target = -(-n // 128), _SKINNY_BLOCKS_PER_SM * sms
    else:
        tiles = -(-n // 64) * -(-m // 64)
        target = _TILE_BLOCKS_PER_SM * sms
    splits = 1
    if tiles < sms:
        splits = max(1, min(-(-target // tiles), k // _MIN_SLICE, 65535))
    depth = -(-max(k, 1) // splits)
    depth = -(-depth // _BK) * _BK
    return skinny, max(1, -(-k // depth)), depth


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ b [K, N]`` with an f32 accumulator, in ``a.dtype``.

    On a CUDA tensor it launches the hand-written kernel on the current
    stream (no synchronisation) or raises; on a CPU tensor it runs the
    twin.  Both operands are f32; the kernel takes them contiguous, on one
    device.
    """
    m, n, k = _check_shapes(a, b)
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"matmul takes float32 operands, got {a.dtype} @ "
                         f"{b.dtype}")
    dev = a.device
    if dev.type == "cpu" and b.device.type == "cpu":
        return matmul_torch(a, b)
    if dev.type != "cuda":
        raise ValueError(f"matmul runs on CUDA or CPU tensors, got {dev} "
                         f"and {b.device}")
    check_operands("matmul", dev, (torch.float32,), a=a, b=b)
    if max(m, n, k) > _INT_MAX // 2:
        raise ValueError(f"matmul dimensions {(m, k, n)} exceed the "
                         f"kernel's int32 indexing")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = load_kernel_library()
    skinny, splits, depth = split_plan(m, n, k, _sm_count(dev),
                                       lib.repro_matmul_skinny_max_m())
    part = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    launch("matmul", lib.repro_matmul, dev, a.data_ptr(), b.data_ptr(),
           out.data_ptr(), None if part is None else part.data_ptr(), m, n,
           k, splits, depth, int(skinny))
    COUNTS["kernel_launches"] += 1
    return out
