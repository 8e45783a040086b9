"""Batched Eq. 1-17 physics of the port, in torch: three evaluators.

Torch counterpart of the reference's ``repro/core/batch.py``, with the
reference's three parity-locked forms:

* :func:`_build_eval` / :func:`evaluate_batch` — the per-plan evaluator
  (ref ``:48-365, 846-906``): one ``EnergyPlan``'s coefficients are
  baked in as constants, the per-point arithmetic runs ``(B, slots)``
  over a :class:`DesignPoints` batch, and the per-category accumulation
  rides the ``category_reduce`` kernel (K4,
  ``repro_torch/csrc/category_reduce.cu``).  Interpolation follows
  ``jnp.interp`` (search, clamp and the per-segment formula) exactly;
* :func:`build_banked_eval` — the banked evaluator (ref ``:386-575``):
  coefficients arrive as a variant's fused PlanBank row, so one
  evaluator serves every variant;
* :func:`build_coeff_compute` — the coefficient-form block compute
  (ref ``:578-833``) laid out ``(slots, B)`` over one fused ``(W,)`` row:
  the plain-torch version of what the CUDA megakernel
  (``repro_torch/csrc/fused_sweep.cu``) evaluates per design point, and
  the physics of the banked evaluator.  It is the ``exact=True`` form:
  plain gathers, an ordered scatter-add, and the static piecewise-linear
  interpolation over f32 knots (:func:`_piecewise_interp`).

Every operation keeps the reference's order.  One ulp anywhere on the
way into an interpolation can flip the last bit of its result, and the
interpolations feed ``10 **`` and ``exp`` of values near -13 and -27,
where one ulp is 2e-6 of the output; so on the CPU that path — the DAG
timing's multiply-adds, the natural log and the interpolations'
multiply-add — follows XLA's CPU arithmetic (:func:`_fma`, :func:`_log`),
and the outputs agree with the reference at rel 1e-6
(``tests/test_torch_physics.py``, ``tests/test_torch_sweep.py``).  On
CUDA they follow the kernels' arithmetic instead.  Divisions by
constants divide by device tensors, never by Python scalars: CUDA torch
turns ``x / scalar`` into a multiply by the reciprocal and ``scalar /
x`` into ``reciprocal(x) * scalar``, which round differently from the
reference's IEEE division.
"""
from __future__ import annotations

import functools
import math
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.category_reduce import category_reduce
from ..kernels.runtime import resolve_device
from .axes import (ADC_DECLARED, AXES, AXES_SPEC, AXIS_BY_NAME,
                   axis_default)
from .constants import (DYNAMIC_ENERGY_SCALE, MIPI_CSI2_ENERGY_PER_BYTE,
                        SRAM_ACCESS_ENERGY_PER_BIT_65,
                        SRAM_HP_LEAKAGE_PER_BIT, SRAM_LEAKAGE_PER_BIT,
                        STT_LEAKAGE_PER_BIT, STT_READ_ENERGY_PER_BIT_65,
                        STT_WRITE_ENERGY_PER_BIT_65, UTSV_ENERGY_PER_BYTE,
                        table_points)
from .energy import CATEGORIES
from .fom import fom_table_points
from .plan import _EXTRA_CACHES, EnergyPlan
from .plan_bank import BankDims, bank_layout

#: the evaluators' output schema (same as the reference's OUT_KEYS)
OUT_KEYS = tuple(sorted(
    [f"cat_{c}_j" for c in CATEGORIES]
    + ["total_j", "on_sensor_j", "t_d_s", "t_a_s", "feasible",
       "area_mm2", "power_mw", "density_mw_mm2"]))

#: coefficient hooks + their PlanBank reference column, read FROM the
#: axis registry (the single definition site of each knob's physics)
_VDD_HOOKS = AXIS_BY_NAME["vdd_scale"].coeff_hook
_ADC_HOOK = AXIS_BY_NAME["adc_bits"].coeff_hook["fom"]
_ADC_REF_COL = AXIS_BY_NAME["adc_bits"].coeff_cols[0]      # "fom_bits"

#: f32 ``1 / ln 10``: the reference evaluates ``log10(x)`` as
#: ``log(x) * (1 / ln 10)``
INV_LN10_F32 = float(np.float32(0.4342944819032518))

#: physics constants as the f32 values the device arithmetic uses
_F32 = {name: float(np.float32(v)) for name, v in dict(
    sram_access=SRAM_ACCESS_ENERGY_PER_BIT_65,
    stt_read=STT_READ_ENERGY_PER_BIT_65,
    stt_write=STT_WRITE_ENERGY_PER_BIT_65,
    stt_leak=STT_LEAKAGE_PER_BIT,
    utsv=UTSV_ENERGY_PER_BYTE,
    mipi=MIPI_CSI2_ENERGY_PER_BYTE).items()}


def point_defaults(plan: EnergyPlan) -> Dict[str, float]:
    """Per-axis default values: what the structure was built with."""
    return {a.name: axis_default(a, plan) for a in AXES_SPEC}


def row_getter(row, layout):
    """``name -> coefficient view`` accessor into one fused bank row."""
    def g(name):
        off, shape = layout[name]
        if not shape:
            return row[off]
        size = int(np.prod(shape))
        v = row[off:off + size]
        return v.reshape(shape) if len(shape) > 1 else v
    return g


# ---------------------------------------------------------------------------
# Static-knot interpolation tables (shared with the CUDA kernel's knots)
# ---------------------------------------------------------------------------
def _static_log_points(table) -> Tuple[List[np.float32], List[np.float32]]:
    """Per-node ``(nodes, log(values))`` as f32 knots."""
    nodes, vals = table_points(table)
    return ([np.float32(n) for n in nodes],
            [np.float32(math.log(v)) for v in vals])


def _fom_points() -> Tuple[List[np.float32], List[np.float32]]:
    """Walden-FoM ``(log10 rate, log10 FoM)`` f32 knots."""
    log_r, log_e = fom_table_points()
    return ([np.float32(v) for v in log_r], [np.float32(v) for v in log_e])


def interp_tables() -> List[Tuple[List[np.float32], List[np.float32]]]:
    """The four interpolation tables in kernel order: dynamic-energy
    scale, SRAM leakage, SRAM-HP leakage (all log-value over node), and
    the Walden FoM (log-log)."""
    return [_static_log_points(DYNAMIC_ENERGY_SCALE),
            _static_log_points(SRAM_LEAKAGE_PER_BIT),
            _static_log_points(SRAM_HP_LEAKAGE_PER_BIT),
            _fom_points()]


#: f32 constants of XLA's CPU ``log``: the smallest normal, sqrt(1/2),
#: the Cephes polynomial and the two parts of ln 2
_LOG_MIN_NORMAL = float(np.float32(1.17549435e-38))
_LOG_SQRTHF = float(np.float32(0.707106781186547524))
_LOG_P = [float(np.float32(c)) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1)]
_LOG_Q1 = float(np.float32(-2.12194440e-4))
_LOG_Q2 = float(np.float32(0.693359375))


def _fma(a: torch.Tensor, b, c):
    """``a * b + c`` as the reference's platform computes it.

    On the CPU the reference runs on XLA, whose backend contracts every
    multiply feeding an add into one fused multiply-add (one rounding);
    the product of two f32 values is exact in f64, so the f64 sum
    rounded to f32 gives that result.  On CUDA it is the separate
    multiply and add the kernels compute (built with ``--fmad=false``).
    ``b`` and ``c`` may be tensors or Python floats.
    """
    if a.device.type != "cpu":
        return a * b + c
    wide = [v.double() if isinstance(v, torch.Tensor) else v
            for v in (a, b, c)]
    return (wide[0] * wide[1] + wide[2]).to(torch.float32)


def _log(x: torch.Tensor) -> torch.Tensor:
    """Natural log as the reference's platform computes it.

    On CUDA: ``torch.log``, i.e. CUDA's ``logf``, which the kernels call.
    On the CPU: XLA's own f32 ``log`` (a Cephes-style polynomial after a
    frexp split, its multiply-adds fused, denormals flushed to zero),
    which differs from a correctly rounded log by one ulp in about 1% of
    inputs.  The evaluators feed ``log`` into an interpolation whose
    result is about -13 (the Walden FoM) and then into ``10 **``, where
    one ulp of the exponent is 2.2e-6 of the result: bit-equal logs are
    what holds the port to the reference at rel 1e-6.
    """
    if x.device.type != "cpu":
        return torch.log(x)
    f32 = torch.float32
    bits = torch.clamp_min(x, _LOG_MIN_NORMAL).view(torch.int32)
    # frexp: mantissa in [0.5, 1) and exponent, then fold below sqrt(1/2)
    m = ((bits & -2139095041) | 1056964608).view(f32)
    e = 1.0 + ((bits >> 23) - 127).to(f32)
    small = m < _LOG_SQRTHF
    e = e - small.to(f32)
    xm = (m - 1.0) + torch.where(small, m, 0.0)
    x2 = xm * xm
    x3 = x2 * xm
    p = _LOG_P
    y = _fma(_fma(xm, p[0], p[1]), xm, p[2])
    y1 = _fma(_fma(xm, p[3], p[4]), xm, p[5])
    y2 = _fma(_fma(xm, p[6], p[7]), xm, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * _LOG_Q1)
    xm = _fma(x2, -0.5, xm)
    out = _fma(e, _LOG_Q2, xm + y)
    out = torch.where(x < _LOG_MIN_NORMAL, -torch.inf, out)  # 0, denormal
    out = torch.where(x < 0, torch.nan, out)
    out = torch.where(torch.isposinf(x), torch.inf, out)
    return torch.where(torch.isnan(x), x, out)


def _pow10(x: torch.Tensor) -> torch.Tensor:
    """``10 ** x`` in f32, a point's value independent of its batch.

    On the CPU torch's f32 ``pow`` takes a vector routine for whole
    vectors and a scalar one for a loop's remainder, which differ by one
    ulp on about 1% of inputs: a point's value then depends on where it
    falls in its batch, and a batch split into shards (or chunks) would
    change it.  The f64 ``pow`` rounded to f32 is correctly rounded on
    both routines.  On CUDA each thread computes its own point:
    ``torch.pow``."""
    if x.device.type != "cpu":
        return torch.pow(10.0, x)
    return torch.pow(10.0, x.double()).to(torch.float32)


def _segment_widths(xs):
    """``device -> (n - 1,)`` f32 tensor of the knots' segment widths,
    built once per device (the interpolation divides by a tensor, never
    by a Python scalar: CUDA torch turns ``x / scalar`` into a multiply
    by the reciprocal, which rounds differently from the reference's
    and the kernel's IEEE division)."""
    widths = torch.tensor([float(np.float32(xs[i + 1] - xs[i]))
                           for i in range(len(xs) - 1)], dtype=torch.float32)
    per_device: Dict[torch.device, torch.Tensor] = {}

    def on(device):
        t = per_device.get(device)
        if t is None:
            t = per_device[device] = widths.to(device)
        return t
    return on


def _piecewise_interp(x, xs, ys, dx):
    """Branchless clamped piecewise-linear interpolation, static knots.

    ``jnp.interp`` semantics (endpoint clamping included) as a static
    unroll of compares and the per-segment ``ys[i] + (delta / dx) * dy``
    arithmetic; ``dx`` (a tensor on ``x``'s device) and ``dy`` are f32
    differences of the f32 knots.
    """
    y = torch.full_like(x, float(ys[0]))
    for i in range(len(xs) - 1):
        dy = float(np.float32(ys[i + 1] - ys[i]))
        t = (x - float(xs[i])) / dx[i]
        seg = _fma(t, dy, float(ys[i]))
        y = torch.where((x >= float(xs[i])) & (x < float(xs[i + 1])), seg, y)
    return torch.where(x >= float(xs[-1]), torch.full_like(y, float(ys[-1])),
                       y)


def _make_scale_interp(table):
    """Geometric node-scaling lookup: ``exp`` of the log-value interp."""
    xs, ys = _static_log_points(table)
    widths = _segment_widths(xs)
    return lambda x: torch.exp(_piecewise_interp(x, xs, ys,
                                                 widths(x.device)))


def _make_fom_interp():
    """Walden-FoM lookup (log-log interpolation over the survey table)."""
    xs, ys = _fom_points()
    widths = _segment_widths(xs)
    # log10 as the reference evaluates it: log(x) * f32(1 / ln 10)
    return lambda rate: _pow10(_piecewise_interp(
        _log(rate) * INV_LN10_F32, xs, ys, widths(rate.device)))


def _take_rows(x, idx):
    """Gather rows ``x[idx]`` of an ``(n, B)`` slab."""
    return torch.index_select(x, 0, idx)


def _scatter_add_rows(x, idx, n):
    """Scatter-add the ``(m, B)`` rows of ``x`` into an ``(n, B)`` zero
    slab at ``idx``; duplicates sum in row order (deterministic on every
    device, unlike an atomic ``index_add_``)."""
    out = torch.zeros((n, x.shape[1]), dtype=x.dtype, device=x.device)
    lane = torch.arange(n, device=x.device)[:, None]
    for j in range(x.shape[0]):
        out = torch.where(lane == idx[j], out + x[j][None, :], out)
    return out


def build_coeff_compute(dims):
    """The banked Eqs. 1-17 physics as ONE block-vectorized function.

    Returns ``compute(row, pt) -> {name: (B,) tensor}`` where ``row`` is
    a variant's fused ``(W,)`` coefficient row (``bank_layout``) and
    ``pt`` maps every axis name to a ``(B,)`` f32 value vector
    (``mem_tech`` as its numeric code).  The output schema is exactly
    :data:`OUT_KEYS`.
    """
    dims = BankDims(*(int(d) for d in dims))
    V, A, L, F, D, M = dims
    n_c = len(CATEGORIES)
    layout = bank_layout(dims)

    dyn_scale = _make_scale_interp(DYNAMIC_ENERGY_SCALE)
    leak_scale = _make_scale_interp(SRAM_LEAKAGE_PER_BIT)
    hp_scale = _make_scale_interp(SRAM_HP_LEAKAGE_PER_BIT)
    walden = _make_fom_interp()
    inf = float("inf")

    def compute(row, pt):
        g = row_getter(row, layout)
        b = pt["frame_rate"].shape[0]
        dev = row.device
        f32 = torch.float32
        cis = pt["cis_node"][None, :]
        soc = pt["soc_node"][None, :]

        def node_for(role, declared):
            r = role[:, None]
            return torch.where(r == 0, cis,
                               torch.where(r == 1, soc, declared[:, None]))

        frame_time = 1.0 / pt["frame_rate"]
        dyn_v = _VDD_HOOKS["dynamic"](pt["vdd_scale"])[None, :]
        stat_v = _VDD_HOOKS["static"](pt["vdd_scale"])[None, :]

        # ----- Sec. 4.1 digital timing over padded slots ------------------
        if D:
            thr = ((pt["sys_rows"] * pt["sys_cols"])[None, :]
                   * g("d_util")[:, None])
            cycles = torch.where(
                g("d_is_sys")[:, None] > 0.5,
                torch.ceil(g("d_macs")[:, None] / thr)
                + (pt["sys_rows"] + pt["sys_cols"])[None, :],
                g("d_cycles")[:, None])
            durs = cycles / g("d_clock")[:, None]            # (D, B)
            edge_w = g("d_edge_w")
            edge_m = g("d_edge_mask") > 0.5
            zero = torch.zeros((b,), dtype=f32, device=dev)
            starts = []
            for i in range(D):      # static unroll; DAG edges go backward
                s_i = zero
                for j in range(i):
                    s_i = torch.maximum(s_i, torch.where(
                        edge_m[i, j], _fma(durs[j], edge_w[i, j], starts[j]),
                        zero))
                starts.append(s_i)
            starts = torch.stack(starts)                     # (D, B)
            ends = starts + durs
            dv = g("d_valid")[:, None] > 0.5
            t_d = (torch.amax(torch.where(dv, ends, -inf), dim=0)
                   - torch.amin(torch.where(dv, starts, inf), dim=0))
            t_d = torch.where(dv.any(), t_d, zero)
        else:
            t_d = torch.zeros((b,), dtype=f32, device=dev)
        t_a = (frame_time - t_d) / g("n_phases")
        feasible = t_a > 0.0

        rows = []

        # ----- analog rows (Eqs. 2-13) ------------------------------------
        if A:
            pad = t_a[None, :] * g("a_pad_coeff")[:, None]   # (A, B)
            e_access = g("a_const")[:, None].expand(A, b) * dyn_v
            if L:
                la = g("lin_arr").to(torch.int64)
                t_cell = torch.clamp_min(
                    _take_rows(pad, la) * g("lin_inv")[:, None], 1e-12)
                e_access = e_access + _scatter_add_rows(
                    g("lin_coeff")[:, None] * t_cell * stat_v, la, A)
            if F:
                fa = g("fom_arr").to(torch.int64)
                t_cell = torch.clamp_min(
                    _take_rows(pad, fa) * g("fom_inv")[:, None], 1e-12)
                fom = walden(1.0 / t_cell)
                fom = fom * _ADC_HOOK(pt["adc_bits"][None, :],
                                      g(_ADC_REF_COL)[:, None])
                e_access = e_access + _scatter_add_rows(
                    g("fom_scale")[:, None] * fom * dyn_v, fa, A)
            rows.append(e_access * g("a_ops")[:, None])

        # ----- digital compute rows (Eqs. 14-15) --------------------------
        if D:
            node_u = node_for(g("d_role"), g("d_node"))
            s_u = dyn_scale(node_u)
            rows.append(g("d_dyn")[:, None] * s_u * dyn_v
                        + g("d_static")[:, None] * durs * stat_v)

        # ----- memory rows (Eq. 16) ---------------------------------------
        if M:
            node_m = node_for(g("m_role"), g("m_node"))
            s_m = dyn_scale(node_m)
            mt = pt["mem_tech"].to(f32)[None, :]
            tech = torch.where(mt >= 0, mt.expand(M, b),
                               g("m_tech")[:, None])
            is_stt = tech == 2
            bits = g("m_bits_pa")[:, None]
            sram_access = (_F32["sram_access"] * bits
                           * g("m_size_f")[:, None]) * s_m
            read_e = torch.where(is_stt, _F32["stt_read"] * bits * s_m,
                                 sram_access)
            write_e = torch.where(is_stt, _F32["stt_write"] * bits * s_m,
                                  sram_access)
            read_e = torch.where(torch.isnan(g("m_read_x"))[:, None],
                                 read_e, g("m_read_x")[:, None])
            write_e = torch.where(torch.isnan(g("m_write_x"))[:, None],
                                  write_e, g("m_write_x")[:, None])
            leak_bit = torch.where(
                is_stt, torch.full_like(tech, _F32["stt_leak"]),
                torch.where(tech == 1, hp_scale(node_m),
                            leak_scale(node_m)))
            leak = leak_bit * g("m_bits_total")[:, None]
            leak = torch.where(torch.isnan(g("m_leak_x"))[:, None],
                               leak, g("m_leak_x")[:, None])
            reads = (g("m_reads_fixed")[:, None]
                     + g("m_reads_dnn2")[:, None]
                     / torch.clamp_min(pt["sys_rows"], 1.0)[None, :])
            alpha = (g("m_alpha")[:, None]
                     * pt["active_fraction_scale"][None, :])
            rows.append((read_e * reads
                         + write_e * g("m_writes")[:, None]) * dyn_v
                        + leak * frame_time[None, :] * alpha * stat_v)

        # ----- communication rows (Eq. 17) --------------------------------
        rows.append(torch.stack([
            (g("utsv_bytes") * _F32["utsv"]).expand(b),
            (g("mipi_bytes") * _F32["mipi"]).expand(b)]))
        unit_e = torch.cat(rows, dim=0)                      # (U, B)
        # per-category sums in unit order (weights are exact 0/1, so the
        # products are exact and only the summation order matters)
        weights = g("weights")                               # (U, C+2)
        red = torch.zeros((n_c + 2, b), dtype=f32, device=dev)
        for u in range(unit_e.shape[0]):
            red = red + weights[u][:, None] * unit_e[u][None, :]

        # ----- Sec. 6.2 power density -------------------------------------
        pitch = pt["pixel_pitch_um"] * 1e-3
        analog_area = g("n_pixels") * (pitch * pitch)
        if M:
            node_area = node_for(g("m_area_role"), g("m_node")) * 1e-6
            cell_area = 150.0 * (node_area * node_area)
            per_mem = g("m_bits_total")[:, None] * cell_area
            digital_area = torch.zeros((b,), dtype=f32, device=dev)
            for m in range(M):          # memory order, like the kernel
                digital_area = digital_area + per_mem[m]
        else:
            digital_area = torch.zeros((b,), dtype=f32, device=dev)
        area = torch.where(g("stacked") > 0,
                           torch.maximum(analog_area, digital_area),
                           analog_area + digital_area)

        out = {f"cat_{c}_j": red[i] for i, c in enumerate(CATEGORIES)}
        out["total_j"] = red[n_c]
        out["on_sensor_j"] = red[n_c + 1]
        out["t_d_s"] = t_d
        out["t_a_s"] = t_a
        out["feasible"] = feasible
        out["area_mm2"] = area
        out["power_mw"] = out["on_sensor_j"] * pt["frame_rate"] * 1e3
        out["density_mw_mm2"] = out["power_mw"] / torch.clamp_min(area, 1e-9)
        assert set(out) == set(OUT_KEYS), (sorted(out), OUT_KEYS)
        return out

    compute.dims = dims             # read by the CUDA kernel's wrapper
    return compute


# ---------------------------------------------------------------------------
# Design-point batches
# ---------------------------------------------------------------------------
class DesignPoints(NamedTuple):
    """Struct-of-arrays batch of design points (all fields ``(B,)``
    tensors on one device; ``mem_tech`` int32, the rest f32).

    Field order is the axis-registry order (``repro_torch.core.axes.AXES``)
    — the grid decoder emits axis rows positionally against it.
    """
    cis_node: torch.Tensor           # nm, sensor-layer process node
    soc_node: torch.Tensor           # nm, host/compute-layer process node
    mem_tech: torch.Tensor           # int: -1 declared, 0 sram, 1 hp, 2 stt
    sys_rows: torch.Tensor           # systolic array rows
    sys_cols: torch.Tensor           # systolic array cols
    frame_rate: torch.Tensor         # FPS
    active_fraction_scale: torch.Tensor  # multiplies each memory's alpha
    pixel_pitch_um: torch.Tensor     # analog area knob (power density)
    vdd_scale: torch.Tensor          # supply scale: dyn x v^2, static x v
    adc_bits: torch.Tensor           # ADC resolution override (-1 declared)

    @property
    def batch(self) -> int:
        return int(self.cis_node.shape[0])


# the axis registry and the point struct can never drift apart
assert DesignPoints._fields == AXES, (DesignPoints._fields, AXES)


def _hooks_active(points: DesignPoints) -> bool:
    """Whether a batch leaves the coefficient-hook defaults
    (``vdd_scale == 1``, ``adc_bits < 0``).  Reads the values back to the
    host: sweeps decide once per grid with
    :func:`grid_hooks_active` instead."""
    return bool(torch.any(points.vdd_scale != 1.0)
                or torch.any(points.adc_bits >= 0))


def grid_hooks_active(grids: Dict[str, Sequence]) -> bool:
    """Sweep-level hook decision from a (host) grids dict: True iff a
    coefficient-hook axis leaves its default anywhere in the grid."""
    v = np.asarray(grids.get("vdd_scale", 1.0), np.float64)
    a = np.asarray(grids.get("adc_bits", ADC_DECLARED), np.float64)
    return bool(np.any(v != 1.0) or np.any(a >= 0.0))


def make_points(plan: EnergyPlan, n: Optional[int] = None, *,
                device="cuda", **axes: Sequence) -> DesignPoints:
    """Broadcast per-axis values against :func:`point_defaults`, onto
    ``device`` (``cuda`` unless the caller asks for ``"cpu"``)."""
    device = resolve_device(device)
    defaults = point_defaults(plan)
    unknown = set(axes) - set(defaults)
    if unknown:
        raise KeyError(f"unknown sweep axes {sorted(unknown)}; "
                       f"valid: {sorted(defaults)}")
    if n is None:
        n = max([np.size(v) for v in axes.values()] or [1])
    out = {}
    for name, dflt in defaults.items():
        v = np.asarray(axes.get(name, dflt), np.float64)
        v = np.broadcast_to(np.atleast_1d(v), (n,))
        dt = np.int32 if AXIS_BY_NAME[name].integer else np.float32
        out[name] = torch.from_numpy(v.astype(dt)).to(device)
    return DesignPoints(**out)


def points_from_axis_rows(vals: Sequence[torch.Tensor]) -> DesignPoints:
    """``DesignPoints`` from decoded per-axis value rows in AXES order;
    integer-coded axes (``mem_tech``) are cast per the axis registry."""
    assert len(vals) == len(AXES_SPEC), (len(vals), AXES)
    return DesignPoints(*(v.to(torch.int32) if spec.integer else v
                          for spec, v in zip(AXES_SPEC, vals)))


# ---------------------------------------------------------------------------
# jnp.interp-exact technology tables of the per-plan evaluator
# ---------------------------------------------------------------------------
#: the smallest dx that jnp.interp divides by (``np.spacing(eps)``)
_INTERP_DX0 = float(np.spacing(np.finfo(np.float32).eps))


def _log_interp_const(table) -> Tuple[np.ndarray, np.ndarray]:
    """``(nodes, log(values))`` as f32 arrays."""
    nodes, vals = table_points(table)
    return (np.asarray(nodes, np.float32),
            np.asarray([math.log(v) for v in vals], np.float32))


@functools.lru_cache(maxsize=None)
def _knots(device: torch.device) -> Dict[str, Tuple[torch.Tensor, ...]]:
    """The per-plan evaluator's interpolation knots on ``device``: the
    three node-scaling tables and the Walden-FoM table, f32."""
    log_r, log_e = fom_table_points()
    host = dict(dyn=_log_interp_const(DYNAMIC_ENERGY_SCALE),
                leak=_log_interp_const(SRAM_LEAKAGE_PER_BIT),
                hp=_log_interp_const(SRAM_HP_LEAKAGE_PER_BIT),
                fom=(np.asarray(log_r, np.float32),
                     np.asarray(log_e, np.float32)))
    return {name: tuple(torch.from_numpy(a).to(device) for a in pair)
            for name, pair in host.items()}


def _interp(x: torch.Tensor, xp: torch.Tensor,
            fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` as jax computes it: the segment from a
    right-side search clipped to ``[1, n - 1]``, then ``fp[i-1] + (delta
    / dx) * df``, then ``fp[0]`` below ``xp[0]`` and ``fp[-1]`` above
    ``xp[-1]`` (so ``x == xp[-1]`` takes the computed endpoint)."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True),
                    1, n - 1)
    x0, f0 = xp[i - 1], fp[i - 1]
    df = fp[i] - f0
    dx = xp[i] - x0
    delta = x - x0
    dx0 = torch.abs(dx) <= _INTERP_DX0
    f = torch.where(dx0, f0,
                    _fma(delta / torch.where(dx0, 1.0, dx), df, f0))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _interp_table(node: torch.Tensor, name: str) -> torch.Tensor:
    """Geometric interpolation over process nodes
    (== ``constants._lookup_scale``)."""
    nodes, log_vals = _knots(node.device)[name]
    return torch.exp(_interp(node, nodes, log_vals))


def _walden_fom(rate: torch.Tensor) -> torch.Tensor:
    """Median Walden FoM at ``rate``: log-log interpolation, with
    ``log10`` as the reference evaluates it (``log(x) * f32(1/ln 10)``)."""
    log_r, log_e = _knots(rate.device)["fom"]
    return _pow10(_interp(_log(rate) * INV_LN10_F32, log_r, log_e))


# ---------------------------------------------------------------------------
# Per-plan evaluator
# ---------------------------------------------------------------------------
def _build_eval(plan: EnergyPlan):
    """The plan's evaluator ``eval_batch(points, keep_unit_energies=False,
    hooks=False) -> {name: (B,) tensor}``.

    ``hooks`` is a specialisation, as the reference's static flag: a
    batch at the hook defaults runs none of the hook arithmetic.  The
    ``(B, U)`` per-unit energies fold to categories through
    :func:`~repro_torch.kernels.category_reduce.category_reduce` and are
    returned only when ``keep_unit_energies`` asks for them.
    """
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    A = len(plan.a_const)
    D = len(plan.d_is_sys)
    M = len(plan.m_reads_fixed)
    lin_arr = [int(i) for i in plan.lin_arr]
    fom_arr = [int(i) for i in plan.fom_arr]
    n_c = len(CATEGORIES)

    bits = f32(plan.m_bits_per_access)
    # comm rows: f64 products on the host, then f32 (as the reference)
    comm = ([plan.utsv_bytes * UTSV_ENERGY_PER_BYTE] if plan.utsv_bytes
            else []) + [plan.mipi_bytes * MIPI_CSI2_ENERGY_PER_BYTE]
    # durations of the fixed-cycle stages: f32 constants
    fixed_dur = [f32(plan.d_cycles_fixed[i]) / f32(plan.d_clock_hz[i])
                 for i in range(D)]
    host = dict(
        a_const=f32(plan.a_const), a_padc=f32(plan.a_pad_coeff),
        a_ops=f32(plan.a_ops),
        lin_coeff=f32(plan.lin_coeff), lin_inv=f32(plan.lin_inv_div),
        fom_scale=f32(plan.fom_scale), fom_inv=f32(plan.fom_inv_div),
        fom_bits=f32(plan.fom_bits),
        d_macs=f32(plan.d_macs), d_clock=f32(plan.d_clock_hz),
        d_role=np.asarray(plan.d_role, np.int32),
        d_node=f32(plan.d_declared_node), d_dyn=f32(plan.d_dyn_coeff),
        d_static=f32(plan.d_static_power),
        n_phases=f32(plan.n_phases),
        m_role=np.asarray(plan.m_role, np.int32),
        m_area_role=np.asarray(plan.m_area_role, np.int32),
        m_node=f32(plan.m_declared_node),
        m_tech=np.asarray(plan.m_tech, np.int32),
        # (c * bits) * size_factor: constant products, in f32
        sram_access=(np.float32(SRAM_ACCESS_ENERGY_PER_BIT_65) * bits
                     * f32(plan.m_size_factor)),
        stt_read=np.float32(STT_READ_ENERGY_PER_BIT_65) * bits,
        stt_write=np.float32(STT_WRITE_ENERGY_PER_BIT_65) * bits,
        read_x=f32(plan.m_read_explicit),
        read_keep=np.isnan(f32(plan.m_read_explicit)),
        write_x=f32(plan.m_write_explicit),
        write_keep=np.isnan(f32(plan.m_write_explicit)),
        leak_x=f32(plan.m_leak_explicit),
        leak_keep=np.isnan(f32(plan.m_leak_explicit)),
        bits_total=f32(plan.m_bits_total),
        reads_fixed=f32(plan.m_reads_fixed),
        reads_dnn2=f32(plan.m_reads_dnn2), writes=f32(plan.m_writes),
        alpha=f32(plan.m_alpha),
        comm=f32(comm),
        # [C category columns | total | on-sensor total]
        weights=np.concatenate([plan.category_onehot(),
                                np.ones((plan.num_units, 1), np.float32),
                                f32(plan.unit_on_sensor)[:, None]],
                               axis=1).astype(np.float32))
    per_device: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def consts(dev):
        c = per_device.get(dev)
        if c is None:
            c = per_device[dev] = {k: torch.from_numpy(
                np.ascontiguousarray(v)).to(dev) for k, v in host.items()}
        return c

    def node_for(role, declared, cis, soc):
        return torch.where(role == 0, cis[:, None],
                           torch.where(role == 1, soc[:, None], declared))

    def eval_one(pt: DesignPoints, hooks: bool):
        c = consts(pt.frame_rate.device)
        b = pt.batch
        frame_time = 1.0 / pt.frame_rate
        if hooks:
            dyn_v = _VDD_HOOKS["dynamic"](pt.vdd_scale)[:, None]
            stat_v = _VDD_HOOKS["static"](pt.vdd_scale)[:, None]

        def hdyn(x):
            return x * dyn_v if hooks else x

        def hstat(x):
            return x * stat_v if hooks else x

        # ----- Sec. 4.1: digital timing, unrolled over the (tiny) DAG -----
        durs = []
        for i in range(D):
            if plan.d_is_sys[i]:
                thr = pt.sys_rows * pt.sys_cols * float(f32(plan.d_util[i]))
                cycles = (torch.ceil(c["d_macs"][i] / thr)
                          + pt.sys_rows + pt.sys_cols)
                durs.append(cycles / c["d_clock"][i])
            else:
                durs.append(torch.full((b,), float(fixed_dur[i]),
                                       dtype=torch.float32,
                                       device=pt.frame_rate.device))
        starts, ends = [], []
        for i in range(D):
            s_i = torch.zeros_like(pt.frame_rate)
            for j in range(i):
                if plan.d_edge_mask[i, j]:
                    s_i = torch.maximum(s_i, _fma(
                        durs[j], float(f32(plan.d_edge_w[i, j])),
                        starts[j]))
            starts.append(s_i)
            ends.append(s_i + durs[i])
        if D:
            t_d = (torch.amax(torch.stack(ends, dim=1), dim=1)
                   - torch.amin(torch.stack(starts, dim=1), dim=1))
        else:
            t_d = torch.zeros_like(pt.frame_rate)
        t_a = (frame_time - t_d) / c["n_phases"]
        feasible = t_a > 0.0

        rows = []

        # ----- analog rows (Eqs. 2-13) ------------------------------------
        if A:
            pad = t_a[:, None] * c["a_padc"][None, :]        # (B, A)
            e_access = hdyn(c["a_const"][None, :].expand(b, A))
            for arr, coeff, inv, is_fom in (
                    (lin_arr, "lin_coeff", "lin_inv", False),
                    (fom_arr, "fom_scale", "fom_inv", True)):
                if not arr:
                    continue
                t_cell = torch.clamp_min(pad[:, arr] * c[inv][None, :],
                                         1e-12)
                if is_fom:
                    fom = _walden_fom(1.0 / t_cell)
                    if hooks:
                        fom = fom * _ADC_HOOK(pt.adc_bits[:, None],
                                              c["fom_bits"][None, :])
                    term = hdyn(c[coeff][None, :] * fom)
                else:
                    term = hstat(c[coeff][None, :] * t_cell)
                # scatter-add in term order (duplicate slots sum in order)
                acc = torch.zeros((b, A), dtype=torch.float32,
                                  device=pad.device)
                for j, slot in enumerate(arr):
                    acc[:, slot] = acc[:, slot] + term[:, j]
                e_access = e_access + acc
            rows.append(e_access * c["a_ops"][None, :])

        # ----- digital compute rows (Eqs. 14-15) --------------------------
        if D:
            node_u = node_for(c["d_role"], c["d_node"], pt.cis_node,
                              pt.soc_node)
            s_u = _interp_table(node_u, "dyn")
            dyn = c["d_dyn"][None, :] * s_u
            rows.append(hdyn(dyn) + hstat(c["d_static"][None, :]
                                          * torch.stack(durs, dim=1)))

        # ----- memory rows (Eq. 16) ---------------------------------------
        if M:
            node_m = node_for(c["m_role"], c["m_node"], pt.cis_node,
                              pt.soc_node)
            s_m = _interp_table(node_m, "dyn")
            mt = pt.mem_tech[:, None]
            tech = torch.where(mt >= 0, mt, c["m_tech"][None, :])
            is_stt = tech == 2
            sram_access = c["sram_access"][None, :] * s_m
            read_e = torch.where(is_stt, c["stt_read"][None, :] * s_m,
                                 sram_access)
            write_e = torch.where(is_stt, c["stt_write"][None, :] * s_m,
                                  sram_access)
            read_e = torch.where(c["read_keep"], read_e, c["read_x"])
            write_e = torch.where(c["write_keep"], write_e, c["write_x"])
            leak_bit = torch.where(
                is_stt, _F32["stt_leak"],
                torch.where(tech == 1, _interp_table(node_m, "hp"),
                            _interp_table(node_m, "leak")))
            leak = leak_bit * c["bits_total"][None, :]
            leak = torch.where(c["leak_keep"], leak, c["leak_x"])
            reads = (c["reads_fixed"][None, :] + c["reads_dnn2"][None, :]
                     / torch.clamp_min(pt.sys_rows, 1.0)[:, None])
            alpha = c["alpha"][None, :] * pt.active_fraction_scale[:, None]
            rows.append(hdyn(read_e * reads
                             + write_e * c["writes"][None, :])
                        + hstat(leak * frame_time[:, None] * alpha))

        # ----- communication rows (Eq. 17) --------------------------------
        rows.append(c["comm"][None, :].expand(b, len(comm)))
        unit_e = torch.cat(rows, dim=1)                      # (B, U)

        # ----- Sec. 6.2 power density -------------------------------------
        pitch = pt.pixel_pitch_um * 1e-3
        analog_area = (pitch * pitch) * float(plan.n_pixels)
        digital_area = torch.zeros_like(pitch)
        if M:
            node_area = node_for(c["m_area_role"], c["m_node"],
                                 pt.cis_node, pt.soc_node) * 1e-6
            per_mem = c["bits_total"][None, :] * (150.0
                                                  * (node_area * node_area))
            for m in range(M):          # memory order
                digital_area = digital_area + per_mem[:, m]
        if plan.stacked:
            area = torch.maximum(analog_area, digital_area)
        else:
            area = analog_area + digital_area
        return dict(unit_e=unit_e, t_d=t_d, t_a=t_a, feasible=feasible,
                    area_mm2=area)

    def eval_batch(points: DesignPoints, keep_unit_energies: bool = False,
                   hooks: bool = False) -> Dict[str, torch.Tensor]:
        per = eval_one(points, hooks)
        c = consts(points.frame_rate.device)
        red = category_reduce(per["unit_e"].contiguous(), c["weights"])
        out = {f"cat_{cat}_j": red[:, i] for i, cat in enumerate(CATEGORIES)}
        out["total_j"] = red[:, n_c]
        out["on_sensor_j"] = red[:, n_c + 1]
        out["t_d_s"] = per["t_d"]
        out["t_a_s"] = per["t_a"]
        out["feasible"] = per["feasible"]
        out["area_mm2"] = per["area_mm2"]
        out["power_mw"] = out["on_sensor_j"] * points.frame_rate * 1e3
        out["density_mw_mm2"] = out["power_mw"] / torch.clamp_min(
            per["area_mm2"], 1e-9)
        if keep_unit_energies:
            out["unit_e"] = per["unit_e"]
        return out

    return eval_batch


def eval_fn(plan: EnergyPlan):
    """The plan's evaluator ``(points, keep_unit_energies=False,
    hooks=False)``, built once per plan."""
    if plan._eval_fn is None:
        plan._eval_fn = _build_eval(plan)
    return plan._eval_fn


def evaluate_batch(plan: EnergyPlan, points: DesignPoints,
                   keep_unit_energies: bool = False,
                   timings: Optional[Dict[str, float]] = None,
                   hooks: Optional[bool] = None) -> Dict[str, np.ndarray]:
    """Score a whole batch of design points on the points' device.

    Returns numpy arrays keyed by output name; the ``(B, U)`` per-unit
    energies only when ``keep_unit_energies`` asks for them.  ``hooks``
    (``None``: read from the points) selects the hook arithmetic.
    ``timings``, if given, accumulates ``compile_s`` (building the plan's
    evaluator, once per plan) and ``eval_s`` (the evaluation and the copy
    to the host).
    """
    return evaluate_split(plan, points, (points.cis_node.device,),
                          keep_unit_energies=keep_unit_energies,
                          timings=timings, hooks=hooks)


def evaluate_split(plan: EnergyPlan, points: DesignPoints, devices,
                   keep_unit_energies: bool = False,
                   timings: Optional[Dict[str, float]] = None,
                   hooks: Optional[bool] = None) -> Dict[str, np.ndarray]:
    """:func:`evaluate_batch` with the batch split into ``len(devices)``
    equal shards (the batch must divide), shard *i* scored on
    ``devices[i]``.  Every shard is enqueued before the first comes back;
    the outputs are concatenated on the host in shard order."""
    t0 = time.perf_counter()
    fn = eval_fn(plan)
    compile_s = time.perf_counter() - t0
    hooks = _hooks_active(points) if hooks is None else bool(hooks)
    t0 = time.perf_counter()
    shard = points.batch // len(devices)
    outs = [fn(DesignPoints(*(x[i * shard:(i + 1) * shard].to(
        dev, non_blocking=True) for x in points)),
        keep_unit_energies=bool(keep_unit_energies), hooks=hooks)
        for i, dev in enumerate(devices)]
    out = {}
    for key in outs[0]:
        parts = [o[key].cpu().numpy() for o in outs]
        out[key] = parts[0] if len(parts) == 1 else np.concatenate(parts)
    eval_s = time.perf_counter() - t0
    if timings is not None:
        timings["compile_s"] = timings.get("compile_s", 0.0) + compile_s
        timings["eval_s"] = timings.get("eval_s", 0.0) + eval_s
    return out


# ---------------------------------------------------------------------------
# Banked (multi-variant) evaluator: PlanBank rows as inputs
# ---------------------------------------------------------------------------
def build_banked_eval(dims):
    """Evaluators whose coefficients are a PlanBank's fused rows, not
    baked constants; one pair serves every variant of the bank.

    Returns ``(eval_bank, eval_bank_uniform)``:

    * ``eval_bank(bank, variant_ids, points)`` — mixed batches: each
      point is scored against its own variant's row;
    * ``eval_bank_uniform(bank, variant_id, points)`` — one variant for
      the whole batch (the staged engine aligns its chunks to variant
      boundaries so it can ride this path).

    ``bank`` is a :class:`~repro_torch.core.plan_bank.PlanBank` and
    ``points`` a :class:`DesignPoints` batch on the bank's device.  The
    physics is :func:`build_coeff_compute`'s (the per-category sum a
    matvec against the row's ``(U, C+2)`` weight slab, in unit order);
    the output schema is exactly :data:`OUT_KEYS`.
    """
    compute = build_coeff_compute(dims)

    def _pt(points: DesignPoints) -> Dict[str, torch.Tensor]:
        return points._asdict()

    def eval_bank_uniform(bank, variant_id: int, points: DesignPoints):
        return compute(bank.fused[int(variant_id)], _pt(points))

    def eval_bank(bank, variant_ids, points: DesignPoints):
        dev = points.frame_rate.device
        ids = torch.as_tensor(variant_ids, device=dev).to(torch.int64)
        pt = _pt(points)
        out: Dict[str, torch.Tensor] = {}
        for v in torch.unique(ids).tolist():
            sel = torch.nonzero(ids == v).reshape(-1)
            res = compute(bank.fused[v],
                          {k: t.index_select(0, sel) for k, t in pt.items()})
            for key, val in res.items():
                if key not in out:
                    out[key] = torch.empty((points.batch,), dtype=val.dtype,
                                           device=dev)
                out[key].index_copy_(0, sel, val)
        return out

    return eval_bank, eval_bank_uniform


_BANKED_FN: Dict[tuple, object] = {}
_EXTRA_CACHES.append(_BANKED_FN)        # flushed by lower_cache_clear()


def banked_eval_fn(dims):
    """The mixed-variant :func:`build_banked_eval` evaluator, memoized on
    the bank dims."""
    key = tuple(int(d) for d in dims)
    fn = _BANKED_FN.get(key)
    if fn is None:
        fn = _BANKED_FN[key] = build_banked_eval(BankDims(*key))[0]
    return fn
