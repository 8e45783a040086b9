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

* :func:`grid_decode` — the wrapper around the hand-written CUDA kernels
  ``repro_torch/csrc/grid_decode.cu``.  :func:`plan` picks the route and
  the grid before the launch: ``"vec4"`` (four consecutive positions of
  one output row a thread, stepped by an odometer from one division-free
  decode, one 16-byte store) where the chunk is a multiple of 4 and the
  outputs 16-byte aligned, ``"scalar"`` (one position a thread)
  otherwise.  For a CUDA tensor it launches the kernel or raises; for a
  CPU tensor it runs the twin.
* :func:`grid_decode_torch` — the plain-torch twin.
* :func:`magic` — the exact magic multipliers by which K2 and K1
  (``fused_sweep``) divide (``fdiv`` of ``csrc/grid_decode.cuh``).

What bounds the kernel on the card: the bytes written, ``4 * (n_axes +
1)`` a position (11.5 MB for a 2^18-point chunk of the registry's 10
axes, 3.4 us at 3.35 TB/s).

:data:`COUNTS` counts kernel launches, in all and by route, and twin
calls.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch

from .cuda_build import launch, load_library

#: launches of the CUDA kernels (in all, and by route) / calls of the torch
#: twin since the last :func:`reset_counts`
COUNTS: Dict[str, int] = {"kernel_launches": 0, "vec4_launches": 0,
                          "scalar_launches": 0, "twin_calls": 0}

#: the kernel's constants: the most axes, positions a thread on the vec4
#: route, threads a block (checked against the library's own at load)
MAX_AXES = 16
POINTS = 4
THREADS = 256
ROUTES = {"scalar": 0, "vec4": 1}

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


def magic(d: int, bits: int) -> Tuple[int, int]:
    """The exact magic multiplier and shift of divisor ``d`` for
    ``bits``-bit unsigned dividends below ``2 ** (bits - 1)``:
    ``n // d == (mulhi(n, m) + n) >> s`` with ``mulhi(n, m) = (n * m) >>
    bits`` (Granlund and Montgomery, PLDI'94, Fig. 4.1).  0 when ``d`` is
    not below ``2 ** (bits - 1)``."""
    if d < 1:
        raise ValueError(f"divisor must be >= 1, got {d}")
    if d >= 1 << (bits - 1):
        return 0, 0
    s = (d - 1).bit_length()                 # ceil(log2 d)
    return ((1 << bits) * ((1 << s) - d)) // d + 1, s


def index_bits(n_var: int, idx_dtype) -> int:
    """The width of the kernel's first decode: 64 on int64 indices and
    where ``n_var`` (and so an axis size) reaches 2^31, since 32-bit magic
    multipliers divide by ``d < 2**31`` only; 32 otherwise."""
    return 64 if idx_dtype == torch.int64 or n_var >= 2 ** 31 else 32


class Plan(NamedTuple):
    """How one K2 launch runs: its route, and ``blocks`` blocks of
    :data:`THREADS` threads for each output row (the axes, then the
    variant ids)."""
    route: str
    blocks: int


def plan(chunk: int, aligned: bool) -> Plan:
    """The :class:`Plan` that decodes ``chunk`` positions: ``"vec4"`` (4
    positions of one row a thread) where ``chunk`` is a multiple of 4 and
    the outputs are 16-byte ``aligned``, else ``"scalar"`` (one position a
    thread).  A 2^18 chunk takes 256 blocks a row (2,816 in all at the
    registry's 10 axes); a chunk of 4,099, 17 a row."""
    route = "vec4" if aligned and chunk % POINTS == 0 else "scalar"
    units = chunk // POINTS if route == "vec4" else chunk
    return Plan(route, -(-units // THREADS))


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


class _Params(ctypes.Structure):
    """ctypes mirror of the .cu's ``DecodeParams``, field for field."""
    _fields_ = [
        *[(n, ctypes.c_longlong) for n in ("start", "last", "n_var",
                                           "chunk")],
        ("mul64_var", ctypes.c_ulonglong),
        ("mul64_stride", ctypes.c_ulonglong * MAX_AXES),
        ("mul64_size", ctypes.c_ulonglong * MAX_AXES),
        ("stride", ctypes.c_ulonglong * MAX_AXES),
        ("mul32_var", ctypes.c_uint),
        ("mul32_stride", ctypes.c_uint * MAX_AXES),
        ("mul32_size", ctypes.c_uint * MAX_AXES),
        ("shift_var", ctypes.c_int),
        ("shift_stride", ctypes.c_int * MAX_AXES),
        ("shift_size", ctypes.c_int * MAX_AXES),
        ("size", ctypes.c_int * MAX_AXES),
        ("run", ctypes.c_int * MAX_AXES),
        *[(n, ctypes.c_int) for n in ("n_axes", "lmax", "table_cols",
                                      "var_run")],
    ]


def decode_strides(shape, n_var: int) -> Tuple[int, ...]:
    """The strides the kernel decodes each axis's digit by: the C-order
    stride, but ``n_var`` for an axis of one value, whose digit is 0
    whatever the stride, so that it changes only with the variant."""
    return tuple(n_var if size == 1 else stride
                 for size, stride in zip(shape, grid_strides(shape)))


@functools.lru_cache(maxsize=32)
def _static_params(shape: Tuple[int, ...], n_var: int, total: int,
                   chunk: int, lmax: int, table_cols: int) -> bytes:
    """The launch parameters that stay fixed across a sweep's chunks, as
    the raw bytes of a :class:`_Params`."""
    cap = 1 << 30
    p = _Params()
    p.last, p.n_var, p.chunk = total - 1, n_var, chunk
    p.mul64_var, p.shift_var = magic(n_var, 64)
    p.mul32_var = magic(n_var, 32)[0]
    for a, (size, stride) in enumerate(zip(shape,
                                           decode_strides(shape, n_var))):
        p.size[a], p.stride[a], p.run[a] = size, stride, min(stride, cap)
        p.mul64_stride[a], p.shift_stride[a] = magic(stride, 64)
        p.mul32_stride[a] = magic(stride, 32)[0]
        p.mul64_size[a], p.shift_size[a] = magic(size, 64)
        p.mul32_size[a] = magic(size, 32)[0]
    p.n_axes, p.lmax, p.table_cols = len(shape), lmax, table_cols
    p.var_run = min(n_var, cap)
    return bytes(p)


def load_kernel_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library; checks its ABI
    against :class:`_Params` and this module's caps."""
    lib = _LIB.get("lib")
    if lib is not None:
        return lib
    lib = load_library("grid_decode")
    lib.repro_grid_decode_abi.argtypes = [ctypes.c_int]
    lib.repro_grid_decode_abi.restype = ctypes.c_int
    want = (ctypes.sizeof(_Params), MAX_AXES, POINTS, THREADS)
    got = tuple(lib.repro_grid_decode_abi(i) for i in range(len(want)))
    if got != want:
        raise RuntimeError(f"grid_decode.cu ABI mismatch: library reports "
                           f"{got}, the wrapper expects {want}")
    lib.repro_grid_decode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_Params), *([ctypes.c_int] * 3),
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.repro_grid_decode.restype = ctypes.c_int
    _LIB["lib"] = lib
    return lib


def grid_decode(table2: torch.Tensor, start, *, shape, n_var: int,
                total: int, chunk: int, lmax: int, idx_dtype=torch.int32):
    """Same signature and return contract as :func:`grid_decode_torch`.

    On a CUDA tensor it launches the kernel of :func:`plan` on the
    current stream (no synchronisation) or raises; on a CPU tensor it
    runs the twin.  int32 indices need ``total + chunk < 2**31``.
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
    n_axes = len(shape)
    if n_axes > MAX_AXES:
        raise ValueError(f"{n_axes} axes exceed the kernel's cap of "
                         f"{MAX_AXES}")
    lib = load_kernel_library()
    params = _Params.from_buffer_copy(_static_params(
        tuple(int(s) for s in shape), int(n_var), int(total), int(chunk),
        int(lmax), int(table2.shape[1])))
    params.start = int(start)
    vals = torch.empty((n_axes, chunk), dtype=torch.float32, device=dev)
    vid = torch.empty((chunk,), dtype=torch.int32, device=dev)
    p = plan(int(chunk), (vals.data_ptr() | vid.data_ptr()) % 16 == 0)
    launch("grid_decode", lib.repro_grid_decode, dev, table2.data_ptr(),
           ctypes.byref(params), int(index_bits(n_var, idx_dtype) == 64),
           ROUTES[p.route], p.blocks, vals.data_ptr(), vid.data_ptr())
    COUNTS[f"{p.route}_launches"] += 1
    COUNTS["kernel_launches"] += 1
    return vals, vid
