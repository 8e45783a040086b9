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
   their block-local positions (ascending in IEEE total order, as
   :func:`sort_total` ranks; ties to the lowest position, +inf padded),
   the masked metric sum and the feasible count.

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

On the card each block of ``block_points`` is spread over a thread-block
cluster of 1-8 CTAs; :func:`plan` picks the cluster size and the points a
CTA stages a pass from the block size, ``kk``, the chunk and the SM count
(pure Python, cached per shape), :func:`staging` sizes each pass's tables
from the axis table's geometry, and :func:`run` launches a forced
:class:`Plan`.  The kernel decodes without a division, by the exact magic
multipliers of :func:`repro_torch.kernels.grid_decode.magic` (``fdiv`` of
``csrc/grid_decode.cuh``), as K2 does.

:data:`COUNTS` counts kernel launches (in all, and by cluster size) and
twin calls; each is bumped at the one place the kernel is launched or the
twin runs.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..core.axes import AXES, LN2_F32
from ..core.batch import _F32, INV_LN10_F32, OUT_KEYS, interp_tables
from ..core.energy import CATEGORIES
from ..core.plan_bank import (BankDims, LAYOUT_FIELDS, bank_layout,
                              layout_offsets)
from .cuda_build import launch, load_library, sm_count
from .grid_decode import grid_strides, magic

#: the cluster sizes a plan may take (CTAs a block; 8 is the portable cap)
CLUSTER_CHOICES = (1, 2, 4, 8)
#: launches of the CUDA kernel (in all, and by cluster size) / calls of the
#: torch twin since the last :func:`reset_counts`
COUNTS: Dict[str, int] = {"kernel_launches": 0, "twin_calls": 0,
                          **{f"cluster{c}_launches": 0
                             for c in CLUSTER_CHOICES}}

#: the kernel's other metrics, in its ``Out`` enum order; the library
#: reports each one's code at ABI probes 8..15, checked at load time
_OTHER_METRICS = ("total_j", "on_sensor_j", "t_d_s", "t_a_s", "feasible",
                  "area_mm2", "power_mw", "density_mw_mm2")
#: metric codes of the kernel: category sums first
KERNEL_OUTPUTS: Tuple[str, ...] = tuple(
    f"cat_{c}_j" for c in CATEGORIES) + _OTHER_METRICS
assert set(KERNEL_OUTPUTS) == set(OUT_KEYS), (KERNEL_OUTPUTS, OUT_KEYS)

THREADS = 256                  # threads per CTA (the .cu's kThreads)
_WARPS = THREADS // 32
_MAX_AXES, _MAX_SLOTS, _MAX_KNOTS = 16, 16, 32
_MAX_SMEM = 232_448            # bytes of shared memory one H100 block may use
#: the most points of a block one CTA evaluates in a pass (their metric
#: values are staged in shared memory for the top-kk); a CTA with more
#: takes them in passes
MAX_TILE = 8192
#: a plan takes the smallest cluster whose CTAs number at least this many
#: an SM (a 2^18-point chunk in blocks of 4096 is 64 blocks: cluster 4,
#: 256 CTAs), as long as each CTA keeps a point for every thread.
#: On an H100 (chip_smoke.py's fused_probe line, device ms by cluster
#: size at 2^18 points in blocks of 4096; PERF.md) clusters of 4 are the
#: fastest at kk 3 and 16: at 8 the per-CTA prologue and merges count
#: twice as often, and not every cluster of 8 finds its SMs free at once.
_CTAS_PER_SM = 1
#: shared-memory words that do not scale with the table: the
#: interpolation knots (xs, ys, dx, dy of 4 tables) and the per-slot
#: declared nodes (5 x 16); the node tables take 4 kinds of each cis and
#: soc value
_KNOT_WORDS, _DECL_WORDS, _NODE_KINDS = 4 * 4 * _MAX_KNOTS, 5 * _MAX_SLOTS, 4
#: registry axes whose values the kernel tables (AXES order)
_CIS, _SOC, _ROWS, _COLS, _ADC = 0, 1, 3, 4, 9


def sort_total(x: torch.Tensor, dim: int = -1
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable ascending sort of f32 ``x`` along ``dim`` in IEEE total order:
    a sign-bit NaN below ``-inf``, ``-0`` below ``+0``, a positive NaN
    above ``+inf``; equal values keep their order.

    This is the order of the reference's ``lax.top_k(-x)`` (which ranks
    the total order of ``-x``) and of K1's ``key_of``; ``torch.sort``
    alone puts every NaN last and ``-0`` level with ``+0``.  Returns the
    values (the input's bits, NaN payloads included) and their indices.
    """
    bits = x.contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    _, pos = torch.sort(key, dim=dim, stable=True)
    return torch.gather(x, dim, pos), pos


def reset_counts() -> None:
    """Zero the launch / twin-call counters."""
    for key in COUNTS:
        COUNTS[key] = 0


def _blocks(block_points: int, chunk: int) -> Tuple[int, int]:
    bp = max(min(block_points, chunk), 1)
    return bp, -(-chunk // bp)


class Plan(NamedTuple):
    """How one launch runs: ``cluster`` CTAs a block of ``bp`` points,
    ``rank_points`` of them a CTA, taken in passes of at most ``tile``
    (``ppt`` a thread); each warp keeps its ``kw`` least (value, position)
    pairs of a pass, each CTA its ``kc`` least, and the block gives
    ``kout`` = min(kk, bp) before the padding; ``ctas`` in all."""
    cluster: int
    rank_points: int
    tile: int
    ppt: int
    kw: int
    kc: int
    kout: int
    ctas: int


def make_plan(bp: int, kk: int, chunk: int, cluster: int) -> Plan:
    """The :class:`Plan` of blocks of ``bp`` points over ``chunk`` points
    on clusters of ``cluster`` CTAs; raises ``ValueError`` on what the
    kernel does not take."""
    if cluster not in CLUSTER_CHOICES:
        raise ValueError(f"cluster must be one of {CLUSTER_CHOICES}, got "
                         f"{cluster}")
    if bp < 1 or kk < 1 or chunk < 1:
        raise ValueError(f"bp, kk and chunk must be >= 1, got bp={bp}, "
                         f"kk={kk}, chunk={chunk}")
    rank_points = -(-bp // cluster)
    tile = min(rank_points, MAX_TILE)
    ppt = -(-tile // THREADS)
    return Plan(cluster, rank_points, tile, ppt, min(kk, 32 * ppt),
                min(kk, rank_points), min(kk, bp), -(-chunk // bp) * cluster)


@functools.lru_cache(maxsize=None)
def plan(bp: int, kk: int, chunk: int, n_sm: int) -> Plan:
    """The plan for blocks of ``bp`` points over ``chunk`` points on a
    card with ``n_sm`` SMs: the smallest cluster (1, 2, 4, 8) that takes
    a CTA's points in one pass of at most :data:`MAX_TILE` (8 past 8 x
    that), grown while the CTAs number fewer than ``_CTAS_PER_SM`` an SM
    and each CTA keeps at least one point a thread (blocks of 256 points
    or fewer take one CTA)."""
    nb = -(-chunk // max(bp, 1))
    cluster = next((c for c in CLUSTER_CHOICES if -(-bp // c) <= MAX_TILE),
                   CLUSTER_CHOICES[-1])
    for c in CLUSTER_CHOICES:
        if c <= cluster:
            continue
        if nb * cluster >= _CTAS_PER_SM * n_sm or -(-bp // c) < THREADS:
            break
        cluster = c
    return make_plan(bp, kk, chunk, cluster)


class Staging(NamedTuple):
    """How a CTA's passes table the axis values: at most ``span`` points a
    pass, reaching at most ``nv`` variants, whose (sys_rows, sys_cols)
    timing is tabled when ``tim``; ``smem`` words of shared memory."""
    span: int
    nv: int
    tim: bool
    smem: int


def smem_floats(width: int, dims, shape: Sequence[int], p: Plan, nv: int,
                tim: bool) -> int:
    """4-byte words of shared memory one CTA of plan ``p`` uses (the .cu
    source's ``layout_of``): the row, the knots, the declared nodes; for
    ``nv`` variants their axis values, the node tables over their cis and
    soc values, the ADC factors over their adc values and, when ``tim``,
    the timing of their (sys_rows, sys_cols) pairs; a pass's point keys,
    the warps' lists, the CTA's running and merged lists, the cluster's
    lists as rank 0 gathers them, and the partial sums (the warps', the
    CTA's and, as rank 0 gathers them, the cluster's)."""
    _v, _a, _l, n_fom, n_dig, n_mem = (int(d) for d in dims)
    per_var = (sum(shape) + _NODE_KINDS * (shape[_CIS] + shape[_SOC])
               + n_fom * shape[_ADC])
    if tim:
        per_var += shape[_ROWS] * shape[_COLS] * (n_dig + 1 + n_mem)
    return (width + _KNOT_WORDS + _DECL_WORDS + nv * per_var + p.tile
            + 2 * _WARPS * p.kw + 4 * p.kc + 2 * p.cluster * p.kc
            + 2 * _WARPS + 2 + 2 * p.cluster)


def staging(width: int, dims, shape: Sequence[int], n_var: int,
            n_variants: int, p: Plan) -> Staging:
    """The passes of plan ``p`` over ``n_variants`` variants of ``n_var``
    points on a grid of axis sizes ``shape``: a pass of the plan's whole
    tile, unless the tables of the variants it may reach do not fit one
    CTA's shared memory; then the longest pass whose variants' do.  The
    timing table is kept when it fits what is left.  Raises
    ``ValueError`` when a pass that may straddle two variants (one, with
    one variant) does not fit."""
    words = _MAX_SMEM // 4

    def reach(span):             # the most variants `span` points reach
        return min(n_variants, (span - 1) // n_var + 2)

    span = p.tile
    if smem_floats(width, dims, shape, p, reach(span), False) > words:
        base = smem_floats(width, dims, shape, p, 0, False)
        per_var = smem_floats(width, dims, shape, p, 1, False) - base
        need = min(n_variants, 2)
        if base + need * per_var > words:
            raise ValueError(
                f"a pass's tables for {need} variant(s) of axis sizes "
                f"{tuple(shape)}, the row and a CTA's {p.tile} points need "
                f"{4 * (base + need * per_var)} bytes of shared memory; "
                f"one block has {_MAX_SMEM}")
        span = ((words - base) // per_var - 1) * n_var
    nv = reach(span)
    tim = smem_floats(width, dims, shape, p, nv, True) <= words
    return Staging(span, nv, tim, smem_floats(width, dims, shape, p, nv, tim))


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
    # total order, stable: equal values keep the lower position, like the
    # reference's lax.top_k(-x) and the kernel's (key, position) argmin
    cand_v, cand_l = sort_total(masked, dim=1)
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
        ("mul64_var", ctypes.c_ulonglong),
        ("mul64", ctypes.c_ulonglong * _MAX_AXES),
        ("mul32_var", ctypes.c_uint),
        ("mul32", ctypes.c_uint * _MAX_AXES),
        ("shift_var", ctypes.c_int),
        ("shift", ctypes.c_int * _MAX_AXES),
        *[(n, ctypes.c_int) for n in
          ("bp", "kk", "cluster", "rank_points", "tile", "ppt", "kw", "kc",
           "kout", "smem", "span", "nv", "tim", "sum_shape")],
        ("pre", ctypes.c_int * _MAX_AXES),
        *[(n, ctypes.c_int) for n in
          ("lmax", "table_cols", "width", "n_axes", "metric", "A", "L", "F",
           "D", "M", "n_units")],
        ("off", ctypes.c_int * len(LAYOUT_FIELDS)),
        ("n_knots", ctypes.c_int * 4),
        *[(n, ctypes.c_float) for n in
          ("c_sram_access", "c_stt_read", "c_stt_write", "c_stt_leak",
           "c_utsv", "c_mipi", "c_ln2", "c_inv_ln10")],
    ]


_LIB = {}
_KNOTS: Dict[int, torch.Tensor] = {}


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
            _MAX_SLOTS, CLUSTER_CHOICES[-1], _MAX_KNOTS, len(CATEGORIES),
            len(AXES)) \
        + tuple(KERNEL_OUTPUTS.index(m) for m in _OTHER_METRICS) \
        + (THREADS, 2 * _NODE_KINDS, _DECL_WORDS)
    got = tuple(lib.repro_fused_sweep_abi(i) for i in range(len(want)))
    if got != want:
        raise RuntimeError(f"fused_sweep.cu ABI mismatch: library reports "
                           f"{got}, the wrapper expects {want}")
    lib.repro_fused_sweep.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.repro_fused_sweep.restype = ctypes.c_int
    _LIB["lib"] = lib
    return lib


def _knot_table() -> np.ndarray:
    """The interpolation knots as the kernel stages them: xs, ys, dx, dy,
    each ``[4 tables][_MAX_KNOTS]`` f32 (zero past a table's knots), and
    each table's knot count."""
    out = np.zeros((4, 4, _MAX_KNOTS), np.float32)
    counts = []
    for t, (xs, ys) in enumerate(interp_tables()):
        n = len(xs)
        if n > _MAX_KNOTS:
            raise ValueError(f"interp table {t} has {n} knots; the kernel "
                             f"takes at most {_MAX_KNOTS}")
        if not np.all(np.diff(np.asarray(xs, np.float32)) > 0):
            raise ValueError(f"interp table {t}'s knots do not increase "
                             f"strictly; the kernel locates a segment by "
                             f"binary search")
        counts.append(n)
        out[0, t, :n] = xs
        out[1, t, :n] = ys
        out[2, t, :n - 1] = np.float32(np.diff(np.asarray(xs, np.float32)))
        out[3, t, :n - 1] = np.float32(np.diff(np.asarray(ys, np.float32)))
    return out, counts


def _knots(dev: torch.device) -> torch.Tensor:
    """The knot table on ``dev``, made once per device."""
    t = _KNOTS.get(dev.index)
    if t is None:
        t = _KNOTS[dev.index] = torch.from_numpy(_knot_table()[0]).to(dev)
    return t


@functools.lru_cache(maxsize=32)
def _static_params(dims: BankDims, metric: str, shape: Tuple[int, ...],
                   n_var: int, total: int, chunk: int, lmax: int,
                   table_cols: int, bp: int, kk: int, p_: Plan) -> bytes:
    """The launch parameters that stay fixed across a sweep's chunks, as
    the raw bytes of a :class:`_Params` (built once per sweep shape: the
    knot tables alone take ~0.5 ms of Python to fill); raises
    ``ValueError`` on what the kernel's compile-time caps do not take."""
    for name, val in zip(("A", "L", "F", "D", "M"), tuple(dims)[1:]):
        if val > _MAX_SLOTS:
            raise ValueError(f"bank dim {name}={val} exceeds the CUDA "
                             f"kernel's cap of {_MAX_SLOTS} slots")
    if len(shape) != len(AXES):
        raise ValueError(f"the kernel decodes the {len(AXES)} registry "
                         f"axes; got {len(shape)}")
    if metric not in KERNEL_OUTPUTS:
        raise KeyError(f"unknown metric {metric!r}; valid: "
                       f"{sorted(KERNEL_OUTPUTS)}")
    width = bank_layout(dims)["__width__"][0]
    st = staging(width, dims, shape, int(n_var), int(table_cols) // int(lmax),
                 p_)
    p = _Params()
    p.total, p.n_var, p.chunk = int(total), int(n_var), int(chunk)
    p.mul64_var, p.shift_var = magic(int(n_var), 64)
    p.mul32_var = magic(int(n_var), 32)[0]
    for a, size in enumerate(shape):
        p.shape[a] = int(size)
        p.mul64[a], p.shift[a] = magic(int(size), 64)
        p.mul32[a] = magic(int(size), 32)[0]
        p.pre[a] = int(sum(shape[:a]))
    p.bp, p.kk = bp, int(kk)
    (p.cluster, p.rank_points, p.tile, p.ppt, p.kw, p.kc, p.kout) = p_[:7]
    p.smem, p.span, p.nv, p.tim = st.smem, st.span, st.nv, int(st.tim)
    p.sum_shape = int(sum(shape))
    p.lmax, p.table_cols, p.width = int(lmax), int(table_cols), width
    p.n_axes = len(shape)
    p.metric = KERNEL_OUTPUTS.index(metric)
    p.A, p.L, p.F, p.D, p.M = tuple(dims)[1:]
    p.n_units = dims.n_units
    for i, o in enumerate(layout_offsets(dims)):
        p.off[i] = int(o)
    for t, n in enumerate(_knot_table()[1]):
        p.n_knots[t] = n
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
                  bp: int, kk: int, start: int, low: int, limit: int,
                  p: Plan) -> _Params:
    """The kernel's launch parameters for one chunk under plan ``p``."""
    params = _Params.from_buffer_copy(_static_params(
        BankDims(*(int(d) for d in dims)), metric,
        tuple(int(s) for s in shape), int(n_var), int(total), int(chunk),
        int(lmax), int(table_cols), int(bp), int(kk), p))
    params.start, params.low, params.limit = int(start), int(low), int(limit)
    return params


def fused_sweep_block(table2: torch.Tensor, row: torch.Tensor, start, low,
                      limit, *, compute, metric: str, axis_names, shape,
                      n_var: int, total: int, chunk: int, lmax: int,
                      block_points: int = 4096, kk: int = 16,
                      idx_dtype=torch.int32):
    """Same signature and return contract as :func:`fused_sweep_block_torch`.

    On a CUDA tensor it launches the hand-written kernel under
    :func:`plan` on the current stream (no synchronisation) or raises; on
    a CPU tensor it runs the twin.  ``compute`` must come from
    ``build_coeff_compute`` (the kernel reads the bank dims off it).
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
    bp, _nb = _blocks(block_points, chunk)
    p = plan(bp, kk, chunk, sm_count(table2.device))
    return run(table2, row, start, low, limit, p, compute=compute,
               metric=metric, axis_names=axis_names, shape=shape,
               n_var=n_var, total=total, chunk=chunk, lmax=lmax,
               block_points=block_points, kk=kk, idx_dtype=idx_dtype)


def run(table2: torch.Tensor, row: torch.Tensor, start, low, limit,
        p: Plan, *, compute, metric: str, axis_names, shape, n_var: int,
        total: int, chunk: int, lmax: int, block_points: int = 4096,
        kk: int = 16, idx_dtype=torch.int32):
    """Launch the kernel under plan ``p`` (from :func:`plan` or
    :func:`make_plan` for this ``block_points``, ``kk`` and ``chunk``) on
    CUDA operands; the contract of :func:`fused_sweep_block`."""
    dims = BankDims(*compute.dims)
    n_axes, vl = table2.shape
    bp, nb = _blocks(block_points, chunk)
    if p.ctas != nb * p.cluster or p.kout != min(kk, bp) \
            or p.cluster * p.rank_points < bp:
        raise ValueError(f"{p} is not a plan for blocks of {bp} points, "
                         f"kk={kk}, chunk={chunk}")
    if tuple(axis_names) != AXES or tuple(table2.shape[:1]) != (len(shape),):
        raise ValueError(f"the kernel decodes the registry axes {AXES} in "
                         f"order; got axis_names={tuple(axis_names)} and a "
                         f"table of shape {tuple(table2.shape)}")
    params = kernel_params(dims, metric=metric, shape=shape, n_var=n_var,
                           total=total, chunk=chunk, lmax=lmax,
                           table_cols=vl, bp=bp, kk=kk, start=start,
                           low=low, limit=limit, p=p)
    width = params.width
    row = row.reshape(-1)
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
    lib = load_kernel_library()
    dev = table2.device
    cand_v = torch.empty((nb, kk), dtype=torch.float32, device=dev)
    cand_l = torch.empty((nb, kk), dtype=torch.int32, device=dev)
    sums = torch.empty((nb,), dtype=torch.float32, device=dev)
    counts = torch.empty((nb,), dtype=torch.float32, device=dev)
    launch("fused_sweep", lib.repro_fused_sweep, dev, table2.data_ptr(),
           row.data_ptr(), _knots(dev).data_ptr(), ctypes.byref(params),
           int(idx_dtype == torch.int64), cand_v.data_ptr(),
           cand_l.data_ptr(), sums.data_ptr(), counts.data_ptr())
    COUNTS[f"cluster{p.cluster}_launches"] += 1
    COUNTS["kernel_launches"] += 1
    return cand_v, cand_l, sums, counts
