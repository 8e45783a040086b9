"""Coefficient-form Eq. 1-17 physics of the port, in torch.

Torch counterpart of the reference's ``repro/core/batch.py:578-833``:
:func:`build_coeff_compute` is the banked physics laid out ``(slots, B)``
over one variant's fused ``(W,)`` coefficient row — the plain-torch
version of what the CUDA megakernel (``repro_torch/csrc/fused_sweep.cu``)
evaluates per design point.  It is the ``exact=True`` form: plain
gathers and an ordered scatter-add, and the static piecewise-linear
interpolation over f32 knots (:func:`_piecewise_interp`) for the process
-node and Walden-FoM tables.

Every operation keeps the reference's order, so on the CPU the outputs
agree with the reference at rel 1e-6 (``tests/test_torch_physics.py``);
the CUDA kernel keeps the same order again, point by point, and is held
against this twin on the card (``chip_smoke.py``).

``build_banked_eval`` (the vmap-ed per-point evaluator) is not ported:
the fused engine re-gathers its k winners' full rows through this same
compute.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from .axes import AXES_SPEC, AXIS_BY_NAME, axis_default
from .constants import (DYNAMIC_ENERGY_SCALE, MIPI_CSI2_ENERGY_PER_BYTE,
                        SRAM_ACCESS_ENERGY_PER_BIT_65,
                        SRAM_HP_LEAKAGE_PER_BIT, SRAM_LEAKAGE_PER_BIT,
                        STT_LEAKAGE_PER_BIT, STT_READ_ENERGY_PER_BIT_65,
                        STT_WRITE_ENERGY_PER_BIT_65, UTSV_ENERGY_PER_BYTE,
                        table_points)
from .energy import CATEGORIES
from .fom import fom_table_points
from .plan import EnergyPlan
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
        seg = float(ys[i]) + t * dy
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
    return lambda rate: torch.pow(10.0, _piecewise_interp(
        torch.log(rate) * INV_LN10_F32, xs, ys, widths(rate.device)))


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
                        edge_m[i, j], starts[j] + edge_w[i, j] * durs[j],
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
