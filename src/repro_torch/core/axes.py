"""Declarative sweep-axis registry of the port (torch coefficient hooks).

Field-for-field copy of the reference registry ``repro/core/axes.py``:
the same ordered :data:`AXES_SPEC` (names, kinds, defaults, integer
flags, encoders, PlanBank coefficient columns and hook groups), with the
three coefficient hooks (``vdd_dynamic_scale``, ``vdd_static_scale``,
``adc_fom_mod``) rewritten on torch tensors.  ``tests/test_torch_bank.py``
holds the two registries equal.

* ``vdd_scale`` — dynamic (``C V^2``-shaped) energies scale with
  ``vdd_scale ** 2``; static / bias-current terms linearly; the MIPI /
  uTSV I/O rails do not track the knob.
* ``adc_bits`` — Walden conversion terms re-price by
  ``2 ** (adc_bits - ref)``; comparators (``ref <= 1``) and the
  ``adc_bits < 0`` sentinel keep the lowered energy.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .plan import TECH_INDEX

#: f32 ``ln 2``: the reference lowers ``exp2(x)`` to ``exp(ln2 * x)``
LN2_F32 = float(np.float32(np.log(2.0)))

#: ``mem_tech`` sentinel: keep each memory's declared technology
TECH_DECLARED = -1

#: ``adc_bits`` sentinel: keep each converter's lowered resolution
ADC_DECLARED = -1.0


# ---------------------------------------------------------------------------
# Coefficient hooks (torch; shared by the coefficient-form compute)
# ---------------------------------------------------------------------------
def vdd_dynamic_scale(vdd):
    """Multiplier on dynamic (``C V^2``) energy terms."""
    return vdd * vdd


def vdd_static_scale(vdd):
    """Multiplier on static / bias-current (``V * I``) energy terms."""
    return vdd


def adc_fom_mod(adc_bits, ref_bits):
    """Multiplier on a Walden-FoM term lowered at ``ref_bits`` resolution.

    ``2 ** (adc_bits - ref_bits)`` for converters; comparators
    (``ref_bits <= 1``) and the ``adc_bits < 0`` sentinel stay at 1.
    Broadcasting is the caller's job: pass ``(F, 1)`` against ``(1, B)``
    for the coefficient-form block compute.
    """
    # exp2 as the reference evaluates it: exp(f32(ln 2) * x)
    mod = torch.exp(LN2_F32 * (adc_bits - ref_bits))
    return torch.where((adc_bits < 0) | (ref_bits <= 1.0),
                       torch.ones_like(mod), mod)


def _tech_code(v) -> int:
    """Map a memory-technology name (or code) to its numeric axis code."""
    if v is None or v == "declared" or v == TECH_DECLARED:
        return TECH_DECLARED
    if isinstance(v, str):
        if v not in TECH_INDEX:
            raise KeyError(f"unknown memory technology {v!r}; valid: "
                           f"{sorted(TECH_INDEX)} or 'declared'")
        return TECH_INDEX[v]
    return int(v)


# ---------------------------------------------------------------------------
# Axis specs
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Axis:
    """Declarative spec of one sweep axis.

    ``kind`` is ``"structural"`` (selects a lowered plan — the
    ``variant`` axis), ``"numeric"`` (a traced per-point value) or
    ``"tech"`` (a coded categorical riding the numeric machinery).
    ``default`` is either a literal or the name of the
    :class:`~repro.core.plan.EnergyPlan` attribute holding the value the
    structure was built with.  ``encode`` maps user-facing values to the
    numeric code swept on device.  ``coeff_hook`` (with its per-variant
    ``coeff_cols`` PlanBank columns) ties the value into the banked
    physics — see the module docstring.
    """
    name: str
    kind: str                                  # structural | numeric | tech
    doc: str
    default: object = None                     # literal or plan attr name
    integer: bool = False                      # rides int32 on device
    encode: Optional[Callable] = None          # value -> numeric code
    coeff_cols: Tuple[str, ...] = ()           # PlanBank columns the hooks read
    #: term-group -> traceable multiplier fn.  The groups are the fixed
    #: extension points of the Eq. 1-17 arithmetic — "dynamic" (C V^2
    #: terms), "static" (bias/leakage terms), "fom" (Walden conversion
    #: terms) — and the evaluators in ``repro.core.batch`` READ the hook
    #: (and its ``coeff_cols``) from this registry entry, so changing an
    #: axis's physics is an edit here, not in the three evaluators.
    coeff_hook: Optional[Dict[str, Callable]] = None


VARIANT_AXIS = Axis(
    "variant", "structural",
    "structural variant name; selects which lowered EnergyPlan scores "
    "the point (each variant is one PlanBank row)")

#: ordered numeric/tech axes — defines DesignPoints fields, ChunkedGrid
#: axis order and the on-device decode layout
AXES_SPEC: Tuple[Axis, ...] = (
    Axis("cis_node", "numeric",
         "sensor-layer process node [nm] (DeepScaleTool dynamic-energy + "
         "leakage scaling)", default="default_cis_node"),
    Axis("soc_node", "numeric",
         "host/compute-layer process node [nm]",
         default="default_soc_node"),
    Axis("mem_tech", "tech",
         "memory technology for ALL memories: 'sram', 'sram_hp', 'stt' "
         "or 'declared' (-1) to keep each memory's own",
         default=TECH_DECLARED, integer=True, encode=_tech_code),
    Axis("sys_rows", "numeric", "systolic array rows",
         default="default_sys_rows"),
    Axis("sys_cols", "numeric", "systolic array cols",
         default="default_sys_cols"),
    Axis("frame_rate", "numeric", "frame rate [FPS]",
         default="default_frame_rate"),
    Axis("active_fraction_scale", "numeric",
         "multiplier on each memory's power-gating active fraction "
         "(Eq. 16 leakage)", default=1.0),
    Axis("pixel_pitch_um", "numeric",
         "pixel pitch [um] (Sec. 6.2 analog area / power density)",
         default="default_pixel_pitch"),
    Axis("vdd_scale", "numeric",
         "supply-voltage scale vs the declared rails: dynamic energies "
         "x vdd^2, static/bias/leakage x vdd; MIPI/uTSV I/O rails are "
         "independent", default=1.0,
         coeff_hook={"dynamic": vdd_dynamic_scale,
                     "static": vdd_static_scale}),
    Axis("adc_bits", "numeric",
         "ADC resolution override [bits]: Walden-FoM conversion terms "
         "re-price by 2^(adc_bits - lowered bits); < 0 keeps the "
         "declared resolution", default=ADC_DECLARED,
         coeff_cols=("fom_bits",), coeff_hook={"fom": adc_fom_mod}),
)

#: canonical numeric-axis name order (== DesignPoints._fields)
AXES: Tuple[str, ...] = tuple(a.name for a in AXES_SPEC)

AXIS_BY_NAME = {a.name: a for a in (VARIANT_AXIS,) + AXES_SPEC}


def axis_default(axis: Axis, plan) -> float:
    """The axis value the plan's structure was built with."""
    if isinstance(axis.default, str):
        return float(getattr(plan, axis.default))
    return axis.default


def encode_axis_value(name: str, v):
    """Encode one user-facing axis value to its numeric sweep code."""
    try:
        axis = AXIS_BY_NAME[name]
    except KeyError:
        raise KeyError(
            f"unknown axis {name!r}; registered axes: "
            f"{sorted(AXIS_BY_NAME)}") from None
    return axis.encode(v) if axis.encode is not None else v
