"""Matrix product with an f32 accumulator and its torch twin.

Port of the reference's K8 (``repro/kernels/matmul.py::_matmul_kernel``),
the functional simulator's DNN stage (Ed-Gaze S3, ``simple_dnn``):
``f32(a [M, K]) @ f32(b [K, N]) -> [M, N]`` in ``a.dtype``, each operand
f32, f16 or bf16.

* :func:`matmul` — the wrapper around the hand-written CUDA kernels of
  ``repro_torch/csrc/matmul.cu``.  :func:`plan` picks one of three routes
  from the shapes, dtypes and alignment alone, before the launch:

  - ``"wgmma"``: ``a`` and ``b`` of one half dtype (f16 or bf16),
    ``M > 8``, ``K`` and ``N`` multiples of 8 and both bases 16-byte
    aligned (TMA's conditions).  Hopper's tensor cores: 128-row tiles of
    two consumer warpgroups, 64-deep A and B tiles fed by TMA into an
    mbarrier ring, and each tile's products promoted into the f32 sums
    with an IEEE add (the tensor cores' own accumulation truncates);
  - ``"tile"``: every other ``M > 8`` product (f32, mixed dtypes,
    unaligned operands), FP32 on the CUDA cores with explicit ``fmaf``:
    128-row register tiles, 8 x 8 outputs a thread, shared tiles double
    buffered with ``cp.async``;
  - ``"skinny"``: ``M <= 8`` (the DNN's GEMV), 128 columns of ``b`` per
    block, 8 warps over K.

  The wgmma and tile routes take 128 output columns a block, or 64 when
  128-wide tiles would leave SMs idle.  When the blocks still leave SMs
  idle (wgmma: half of them), K is split across blocks into an ``[S, M, N]``
  f32 scratch whose partials a second launch adds in slice order (no
  atomics: the same result on every run); a product of fewer than 2^20
  multiply-adds is never split, so it takes one launch and no scratch.
  For a CUDA tensor it launches or raises (a launch that fails is never
  retried on another route); for a CPU tensor it runs the twin.  It
  takes no block sizes: ``bm``/``bn``/``bk`` were the TPU's tile knobs.
* :func:`matmul_torch` — the plain-torch twin (``repro.kernels.ref.
  matmul_ref``): f32 products summed over K in slices of broadcast
  multiplies and reductions, no library GEMM.

Kernel, twin and reference sum in different orders, so they agree within
``1e-5 * (|a| @ |b|)`` elementwise in f32, not bit for bit; an f16 or
bf16 output rounds each side once more, so there they agree within that
plus one unit in the last place of the output dtype.

What bounds the kernels on the card: for the DNN's ``[1, 64000] @
[64000, 900]`` the bytes (230.4 MB, 69 us at 3.35 TB/s); for a 1024^3
product the operations (2.15 GFLOP, 32 us at 67 TFLOP/s FP32, 2.2 us at
the tensor cores' 989 TFLOP/s for half operands).

:data:`COUNTS` counts wrapper launches (one per product, whether it takes
one device kernel or, split, two), in all and by route, and twin calls.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from .cuda_build import check_operands, launch, load_library

#: launches of the CUDA kernels (in all, and by route) / calls of the
#: torch twin since the last :func:`reset_counts`
COUNTS: Dict[str, int] = {"kernel_launches": 0, "wgmma_launches": 0,
                          "tile_launches": 0, "skinny_launches": 0,
                          "twin_calls": 0}

#: operand dtypes the kernels take, with their codes in the C interface
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_HALF = (torch.float16, torch.bfloat16)

#: the skinny kernel takes M up to this (kSkinnyMaxM in the .cu source,
#: whose entry point refuses more)
SKINNY_MAX_M = 8
#: K depth a slice of each route is a multiple of
_SLICE_UNIT = {"wgmma": 64, "tile": 16, "skinny": 16}
#: a K slice is at least this deep, so a split pays for its partials
_MIN_SLICE = 256
#: blocks to aim for per SM when splitting K
_BLOCKS_PER_SM = {"wgmma": 1, "tile": 2, "skinny": 4}
#: K is split while the blocks number fewer than this share of the SMs.
#: Measured at 1024^3 on an H100: the tile route's 128 blocks (64 wide)
#: take 0.082 ms unsplit and 0.066 ms in 3 slices; the wgmma route's 128
#: blocks take 0.0085 ms unsplit, more than any split of them.
_SPLIT_BELOW = {"wgmma": 0.5, "tile": 1.0, "skinny": 1.0}
#: a product of fewer multiply-adds takes one launch: no split, no scratch
_ONE_LAUNCH_MACS = 1 << 20
#: the twin's broadcast products hold at most this many elements at once
_TWIN_ELEMS = 1 << 24
_INT_MAX = 2 ** 31 - 1

_LIB = {}
_SMS: Dict[int, int] = {}


class Plan(NamedTuple):
    """How one product runs: its route, the output columns a block
    (``tile_n``), and K cut into ``splits`` slices of ``depth`` rows."""
    route: str
    tile_n: int
    splits: int
    depth: int


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
    lib.repro_matmul.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.repro_matmul.restype = ctypes.c_int
    lib.repro_matmul_wgmma.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.repro_matmul_wgmma.restype = ctypes.c_int
    lib.repro_matmul_encode_us.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.repro_matmul_encode_us.restype = ctypes.c_double
    _LIB["lib"] = lib
    return lib


def route(m: int, n: int, k: int, a_dtype, b_dtype, aligned: bool) -> str:
    """The kernel a CUDA product of these shapes and dtypes runs:
    ``"skinny"`` for ``M <= 8``; ``"wgmma"`` for two operands of one half
    dtype with ``K`` and ``N`` multiples of 8 (``K > 0``) and both bases
    16-byte ``aligned`` (TMA's conditions on global strides and
    addresses); ``"tile"`` otherwise."""
    if m <= SKINNY_MAX_M:
        return "skinny"
    if a_dtype == b_dtype and a_dtype in _HALF and k > 0 and k % 8 == 0 \
            and n % 8 == 0 and aligned:
        return "wgmma"
    return "tile"


def plan(m: int, n: int, k: int, a_dtype, b_dtype, aligned: bool,
         sms: int) -> Plan:
    """The :class:`Plan` of one product on a card with ``sms`` SMs.

    Blocks take 128 output columns, or 64 where 128-wide tiles would be
    fewer than the SMs (the skinny kernel always 128).  K is split only
    while the blocks number fewer than the SMs (wgmma: half of them), into
    slices of at least 256 rows of K, and never for a product of fewer
    than 2^20 multiply-adds (one launch, no scratch)."""
    r = route(m, n, k, a_dtype, b_dtype, aligned)
    rows = 1 if r == "skinny" else -(-m // 128)
    tile_n = 128
    if r != "skinny" and rows * -(-n // 128) < sms:
        tile_n = 64
    tiles = rows * -(-n // tile_n)
    splits = 1
    if tiles < _SPLIT_BELOW[r] * sms and m * n * k >= _ONE_LAUNCH_MACS:
        target = _BLOCKS_PER_SM[r] * sms
        splits = max(1, min(-(-target // tiles), k // _MIN_SLICE, 65535))
    unit = _SLICE_UNIT[r]
    depth = -(-max(k, 1) // splits)
    depth = -(-depth // unit) * unit
    return Plan(r, tile_n, max(1, -(-k // depth)), depth)


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ b [K, N]`` with an f32 accumulator, in ``a.dtype``.

    On a CUDA tensor it launches the kernel of :func:`plan` on the current
    stream (no synchronisation) or raises; on a CPU tensor it runs the
    twin.  Each operand is f32, f16 or bf16; the kernels take them
    contiguous, on one device.
    """
    m, n, k = _check_shapes(a, b)
    if a.dtype not in _DTYPES or b.dtype not in _DTYPES:
        raise ValueError(f"matmul takes float32, float16 or bfloat16 "
                         f"operands, got {a.dtype} @ {b.dtype}")
    dev = a.device
    if dev.type == "cpu" and b.device.type == "cpu":
        return matmul_torch(a, b)
    if dev.type != "cuda":
        raise ValueError(f"matmul runs on CUDA or CPU tensors, got {dev} "
                         f"and {b.device}")
    check_operands("matmul", dev, tuple(_DTYPES), a=a, b=b)
    if max(m, n, k) > _INT_MAX // 2:
        raise ValueError(f"matmul dimensions {(m, k, n)} exceed the "
                         f"kernel's int32 indexing")
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    return run(a, b, plan(m, n, k, a.dtype, b.dtype, aligned,
                          _sm_count(dev)))


def run(a: torch.Tensor, b: torch.Tensor, p: Plan,
        part: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernels of plan ``p`` for CUDA operands that
    :func:`matmul` has checked; returns ``out``.  A split plan writes its
    f32 partial sums to ``part`` (``[splits, M, N]``, allocated here
    unless the caller passes one to read them back)."""
    m, n, k = _check_shapes(a, b)
    dev = a.device
    out = torch.empty((m, n), dtype=a.dtype, device=dev)
    if out.numel() == 0:
        return out
    lib = load_kernel_library()
    if p.splits > 1 and part is None:
        part = torch.empty((p.splits, m, n), dtype=torch.float32, device=dev)
    part_ptr = part.data_ptr() if p.splits > 1 else None
    if p.route == "wgmma":
        launch("matmul", lib.repro_matmul_wgmma, dev, a.data_ptr(),
               b.data_ptr(), out.data_ptr(), part_ptr, _DTYPES[a.dtype], m,
               n, k, p.splits, p.depth, p.tile_n)
    else:
        launch("matmul", lib.repro_matmul, dev, a.data_ptr(), b.data_ptr(),
               out.data_ptr(), part_ptr, _DTYPES[a.dtype], _DTYPES[b.dtype],
               m, n, k, p.splits, p.depth, int(p.route == "skinny"),
               p.tile_n)
    COUNTS[f"{p.route}_launches"] += 1
    COUNTS["kernel_launches"] += 1
    return out
