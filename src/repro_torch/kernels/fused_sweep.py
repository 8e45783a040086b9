"""Fused decode -> evaluate -> reduce sweep megakernel and its torch twin.

Port of the reference's K1 (``repro/kernels/fused_sweep.py::_fused_kernel``
and its pure-``jnp`` twin ``repro/kernels/fused_sweep_xla.py``).  Per
block of ``block_points`` flat stream indices ``[start, start + chunk)``:

1. **decode** — flat index -> variant slot ``off // n_var`` and per-axis
   grid index ``(local // stride_a) % size_a`` (variant-major, C order),
   looked up in the ``(n_axes, V * Lmax)`` f32 axis table;
2. **evaluate** — the chunk's fused ``(W,)`` coefficient row through the
   coefficient-form Eq. 1-17 physics (``repro_torch.core.batch``);
3. **reduce** — the block's ``kk`` smallest masked metric values with
   their block-local positions (ascending, ties to the lowest position,
   +inf padded), the masked metric sum and the feasible count.

A point counts iff ``low <= flat < limit`` and it lies inside this call's
``chunk`` span; tail indices clamp to ``total - 1`` before decoding.

Two implementations share that contract:

* :func:`fused_sweep_block` — the wrapper around the hand-written CUDA
  kernel ``repro_torch/csrc/fused_sweep.cu`` (built with nvcc at first
  use, loaded with ctypes).  For a CUDA tensor it launches the kernel or
  raises; for a CPU tensor it runs the twin.
* :func:`fused_sweep_block_torch` — the plain-torch twin: what the CPU
  tests hold against the reference, and what ``chip_smoke.py`` holds the
  kernel against on the card.

:data:`COUNTS` counts kernel launches and twin calls; each is bumped at
the one place the kernel is launched or the twin runs.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..core.axes import AXES, LN2_F32
from ..core.batch import _F32, INV_LN10_F32, OUT_KEYS, interp_tables
from ..core.energy import CATEGORIES
from ..core.plan_bank import (BankDims, LAYOUT_FIELDS, bank_layout,
                              layout_offsets)
from .cuda_build import load_library
from .grid_decode import grid_strides

#: launches of the CUDA kernel / calls of the torch twin since the last
#: :func:`reset_counts`
COUNTS: Dict[str, int] = {"kernel_launches": 0, "twin_calls": 0}

#: the kernel's other metrics, in its ``Out`` enum order; the library
#: reports each one's code at ABI probes 8..15, checked at load time
_OTHER_METRICS = ("total_j", "on_sensor_j", "t_d_s", "t_a_s", "feasible",
                  "area_mm2", "power_mw", "density_mw_mm2")
#: metric codes of the kernel: category sums first
KERNEL_OUTPUTS: Tuple[str, ...] = tuple(
    f"cat_{c}_j" for c in CATEGORIES) + _OTHER_METRICS
assert set(KERNEL_OUTPUTS) == set(OUT_KEYS), (KERNEL_OUTPUTS, OUT_KEYS)

THREADS = 256                  # threads per block (the .cu's kThreads)
_MAX_AXES, _MAX_SLOTS, _MAX_LIST, _MAX_KNOTS = 16, 16, 32, 32
_MAX_SMEM = 232_448            # bytes of shared memory one H100 block may use


def reset_counts() -> None:
    """Zero the launch / twin-call counters."""
    for key in COUNTS:
        COUNTS[key] = 0


def _blocks(block_points: int, chunk: int) -> Tuple[int, int]:
    bp = max(min(block_points, chunk), 1)
    return bp, -(-chunk // bp)


# ---------------------------------------------------------------------------
# plain-torch twin
# ---------------------------------------------------------------------------
def fused_sweep_block_torch(table2: torch.Tensor, row: torch.Tensor, start,
                            low, limit, *, compute, metric: str, axis_names,
                            shape, n_var: int, total: int, chunk: int,
                            lmax: int, block_points: int = 4096,
                            kk: int = 16, idx_dtype=torch.int32):
    """Decode + evaluate + reduce flat indices ``[start, start + chunk)``.

    ``table2`` is the ``(n_axes, V * lmax)`` f32 axis table, ``row`` the
    chunk's ``(W,)`` (or ``(1, W)``) fused coefficient row and ``compute``
    the evaluator from :func:`repro_torch.core.batch.build_coeff_compute`.
    Returns ``(cand_v, cand_l, sums, counts)``: per-block ascending
    candidate metric values ``(G, kk)`` (+inf padded), their block-LOCAL
    int32 positions ``(G, kk)`` (global flat index = ``start + g *
    block_points + cand_l``), and the masked per-block metric sums and
    valid counts ``(G,)``.
    """
    COUNTS["twin_calls"] += 1
    n_axes, vl = table2.shape
    assert n_axes == len(shape) == len(axis_names), (table2.shape, shape)
    assert vl % lmax == 0, (table2.shape, lmax)
    bp, nb = _blocks(block_points, chunk)
    dev = table2.device
    strides = grid_strides(shape)

    pos = torch.arange(nb * bp, dtype=idx_dtype, device=dev)
    off = pos + start
    valid = (off >= low) & (off < limit) & (pos < chunk)
    offc = torch.clamp_max(off, total - 1)        # clamp tail; mask decides
    vid = torch.div(offc, n_var, rounding_mode="floor")
    local = offc - vid * n_var
    vals = []
    for a in range(n_axes):
        idx_a = torch.remainder(
            torch.div(local, strides[a], rounding_mode="floor"), shape[a])
        vals.append(table2[a].index_select(0, (vid * lmax + idx_a).long()))
    out = compute(row.reshape(-1), dict(zip(axis_names, vals)))
    ok = out["feasible"] & valid
    mv = out[metric].to(torch.float32)

    masked = torch.where(ok, mv, torch.inf).reshape(nb, bp)
    # stable sort: equal values keep the lower position, like the
    # reference's lax.top_k and the kernel's (value, position) argmin
    cand_v, cand_l = torch.sort(masked, dim=1, stable=True)
    cand_v, cand_l = cand_v[:, :kk], cand_l[:, :kk].to(torch.int32)
    if kk > bp:                 # pad contract: (G, kk) even for tiny blocks
        pad = kk - bp
        cand_v = torch.nn.functional.pad(cand_v, (0, pad), value=torch.inf)
        cand_l = torch.nn.functional.pad(cand_l, (0, pad), value=0)
    sums = torch.where(ok, mv, 0.0).reshape(nb, bp).sum(dim=1)
    counts = ok.reshape(nb, bp).to(torch.float32).sum(dim=1)
    return cand_v, cand_l, sums, counts


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------
class _Params(ctypes.Structure):
    """ctypes mirror of the .cu's ``SweepParams``, field for field."""
    _fields_ = [
        *[(n, ctypes.c_longlong) for n in
          ("start", "low", "limit", "total", "n_var", "chunk")],
        ("shape", ctypes.c_longlong * _MAX_AXES),
        ("stride", ctypes.c_longlong * _MAX_AXES),
        *[(n, ctypes.c_int) for n in
          ("bp", "kk", "list_len", "lmax", "table_cols", "width", "n_axes",
           "metric", "A", "L", "F", "D", "M", "n_units")],
        ("off", ctypes.c_int * len(LAYOUT_FIELDS)),
        ("n_knots", ctypes.c_int * 4),
        *[(n, (ctypes.c_float * _MAX_KNOTS) * 4)
          for n in ("xs", "ys", "dx", "dy")],
        *[(n, ctypes.c_float) for n in
          ("c_sram_access", "c_stt_read", "c_stt_write", "c_stt_leak",
           "c_utsv", "c_mipi", "c_ln2", "c_inv_ln10")],
    ]


_LIB = {}


def load_kernel_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library; checks its ABI
    against :class:`_Params` and this module's caps."""
    lib = _LIB.get("lib")
    if lib is not None:
        return lib
    lib = load_library("fused_sweep")
    lib.repro_fused_sweep_abi.argtypes = [ctypes.c_int]
    lib.repro_fused_sweep_abi.restype = ctypes.c_int
    want = (ctypes.sizeof(_Params), len(LAYOUT_FIELDS), _MAX_AXES,
            _MAX_SLOTS, _MAX_LIST, _MAX_KNOTS, len(CATEGORIES), len(AXES)) \
        + tuple(KERNEL_OUTPUTS.index(m) for m in _OTHER_METRICS)
    got = tuple(lib.repro_fused_sweep_abi(i) for i in range(len(want)))
    if got != want:
        raise RuntimeError(f"fused_sweep.cu ABI mismatch: library reports "
                           f"{got}, the wrapper expects {want}")
    lib.repro_fused_sweep.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(_Params),
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.repro_fused_sweep.restype = ctypes.c_int
    _LIB["lib"] = lib
    return lib


def _interp_params(p: _Params) -> None:
    for t, (xs, ys) in enumerate(interp_tables()):
        n = len(xs)
        if n > _MAX_KNOTS:
            raise ValueError(f"interp table {t} has {n} knots; the kernel "
                             f"takes at most {_MAX_KNOTS}")
        p.n_knots[t] = n
        for i in range(n):
            p.xs[t][i] = float(xs[i])
            p.ys[t][i] = float(ys[i])
        for i in range(n - 1):
            p.dx[t][i] = float(np.float32(xs[i + 1] - xs[i]))
            p.dy[t][i] = float(np.float32(ys[i + 1] - ys[i]))


@functools.lru_cache(maxsize=32)
def _static_params(dims: BankDims, metric: str, shape: Tuple[int, ...],
                   n_var: int, total: int, chunk: int, lmax: int,
                   table_cols: int, bp: int, kk: int) -> bytes:
    """The launch parameters that stay fixed across a sweep's chunks, as
    the raw bytes of a :class:`_Params` (built once per sweep shape: the
    knot tables alone take ~0.5 ms of Python to fill); raises
    ``ValueError`` on what the kernel's compile-time caps do not take."""
    for name, val in zip(("A", "L", "F", "D", "M"), tuple(dims)[1:]):
        if val > _MAX_SLOTS:
            raise ValueError(f"bank dim {name}={val} exceeds the CUDA "
                             f"kernel's cap of {_MAX_SLOTS} slots")
    if len(shape) > _MAX_AXES:
        raise ValueError(f"{len(shape)} axes exceed the kernel's cap of "
                         f"{_MAX_AXES}")
    list_len = min(kk, -(-bp // THREADS))
    if list_len > _MAX_LIST:
        raise ValueError(f"kk={kk} at block_points={bp} needs a "
                         f"{list_len}-entry per-thread list; the kernel "
                         f"keeps at most {_MAX_LIST}")
    if metric not in KERNEL_OUTPUTS:
        raise KeyError(f"unknown metric {metric!r}; valid: "
                       f"{sorted(KERNEL_OUTPUTS)}")
    p = _Params()
    p.total, p.n_var, p.chunk = int(total), int(n_var), int(chunk)
    for a, (s, st) in enumerate(zip(shape, grid_strides(shape))):
        p.shape[a], p.stride[a] = int(s), int(st)
    p.bp, p.kk, p.list_len, p.lmax = bp, int(kk), list_len, int(lmax)
    p.table_cols = int(table_cols)
    p.width = bank_layout(dims)["__width__"][0]
    p.n_axes = len(shape)
    p.metric = KERNEL_OUTPUTS.index(metric)
    p.A, p.L, p.F, p.D, p.M = tuple(dims)[1:]
    p.n_units = dims.n_units
    for i, o in enumerate(layout_offsets(dims)):
        p.off[i] = int(o)
    _interp_params(p)
    p.c_sram_access = _F32["sram_access"]
    p.c_stt_read = _F32["stt_read"]
    p.c_stt_write = _F32["stt_write"]
    p.c_stt_leak = _F32["stt_leak"]
    p.c_utsv = _F32["utsv"]
    p.c_mipi = _F32["mipi"]
    p.c_ln2 = LN2_F32
    p.c_inv_ln10 = INV_LN10_F32
    return bytes(p)


def kernel_params(dims, *, metric: str, shape: Sequence[int], n_var: int,
                  total: int, chunk: int, lmax: int, table_cols: int,
                  bp: int, kk: int, start: int, low: int,
                  limit: int) -> _Params:
    """The kernel's launch parameters for one chunk."""
    p = _Params.from_buffer_copy(_static_params(
        BankDims(*(int(d) for d in dims)), metric,
        tuple(int(s) for s in shape), int(n_var), int(total), int(chunk),
        int(lmax), int(table_cols), int(bp), int(kk)))
    p.start, p.low, p.limit = int(start), int(low), int(limit)
    return p


def fused_sweep_block(table2: torch.Tensor, row: torch.Tensor, start, low,
                      limit, *, compute, metric: str, axis_names, shape,
                      n_var: int, total: int, chunk: int, lmax: int,
                      block_points: int = 4096, kk: int = 16,
                      idx_dtype=torch.int32):
    """Same signature and return contract as :func:`fused_sweep_block_torch`.

    On a CUDA tensor it launches the hand-written kernel on the current
    stream (no synchronisation) or raises; on a CPU tensor it runs the
    twin.  ``compute`` must come from ``build_coeff_compute`` (the kernel
    reads the bank dims off it).
    """
    if table2.device.type == "cpu":
        return fused_sweep_block_torch(
            table2, row, start, low, limit, compute=compute, metric=metric,
            axis_names=axis_names, shape=shape, n_var=n_var, total=total,
            chunk=chunk, lmax=lmax, block_points=block_points, kk=kk,
            idx_dtype=idx_dtype)
    if table2.device.type != "cuda":
        raise ValueError(f"fused_sweep_block runs on CUDA or CPU tensors, "
                         f"got {table2.device}")
    dims = BankDims(*compute.dims)
    n_axes, vl = table2.shape
    bp, nb = _blocks(block_points, chunk)
    params = kernel_params(dims, metric=metric, shape=shape, n_var=n_var,
                           total=total, chunk=chunk, lmax=lmax,
                           table_cols=vl, bp=bp, kk=kk, start=start,
                           low=low, limit=limit)
    width = params.width
    row = row.reshape(-1)
    if tuple(axis_names) != AXES or tuple(table2.shape[:1]) != (len(shape),):
        raise ValueError(f"the kernel decodes the registry axes {AXES} in "
                         f"order; got axis_names={tuple(axis_names)} and a "
                         f"table of shape {tuple(table2.shape)}")
    for name, t, n in (("table2", table2, None), ("row", row, width)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got "
                             f"{t.dtype} (contiguous={t.is_contiguous()})")
        if t.device != table2.device:
            raise ValueError(f"{name} is on {t.device}, table2 on "
                             f"{table2.device}")
        if n is not None and t.numel() != n:
            raise ValueError(f"{name} has {t.numel()} entries; bank dims "
                             f"{tuple(dims)} lay out rows of {n}")
    if vl % lmax:
        raise ValueError(f"table2 width {vl} is not a multiple of lmax "
                         f"{lmax}")
    if idx_dtype not in (torch.int32, torch.int64):
        raise ValueError(f"idx_dtype must be torch.int32 or torch.int64, "
                         f"got {idx_dtype}")
    if idx_dtype == torch.int32 and total + chunk >= 2 ** 31:
        raise ValueError(f"total + chunk = {total + chunk} needs int64 "
                         f"indices")
    smem = 4 * (width + n_axes * vl)
    if smem > _MAX_SMEM:
        raise ValueError(f"row + axis table need {smem} bytes of shared "
                         f"memory; one block has {_MAX_SMEM}")
    lib = load_kernel_library()
    dev = table2.device
    cand_v = torch.empty((nb, kk), dtype=torch.float32, device=dev)
    cand_l = torch.empty((nb, kk), dtype=torch.int32, device=dev)
    sums = torch.empty((nb,), dtype=torch.float32, device=dev)
    counts = torch.empty((nb,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_fused_sweep(
            table2.data_ptr(), row.data_ptr(), ctypes.byref(params),
            int(idx_dtype == torch.int64), cand_v.data_ptr(),
            cand_l.data_ptr(), sums.data_ptr(), counts.data_ptr(), stream)
    if err:
        raise RuntimeError(f"fused_sweep kernel launch failed: cudaError_t "
                           f"{err}")
    COUNTS["kernel_launches"] += 1
    return cand_v, cand_l, sums, counts
