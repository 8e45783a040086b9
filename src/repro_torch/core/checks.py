# Verbatim copy of src/repro/core/checks.py (jax-free model layer).
"""Pre-simulation design checks (Sec. 3.2).

CamJ verifies, before estimating energy, that the algorithm + hardware
combination is 1) functionally viable (domain continuity; ADCs between the
analog and digital worlds), 2) stall-free (delegated to delay.py), and
3) a well-formed DAG (no cycles; geometry consistent).
"""
from __future__ import annotations

from typing import List

from .domains import Domain, compatible
from .hw import HWConfig
from .mapping import Mapping
from .sw import ProcessStage, Stage, topological_order


class DesignCheckError(ValueError):
    pass


def run_design_checks(hw: HWConfig, stages: List[Stage], mapping: Mapping) -> List[str]:
    """Raise DesignCheckError on fatal problems; return advisory notes."""
    notes: List[str] = []

    # --- DAG well-formedness (raises on cycles) -------------------------
    order = topological_order(stages)

    # --- every stage mapped to a real unit ------------------------------
    mapping.validate(hw, order)

    # --- stencil geometry ------------------------------------------------
    for s in order:
        if isinstance(s, ProcessStage):
            s.check_geometry()

    # --- domain continuity along the analog chain ------------------------
    arrays = hw.analog_arrays
    for prod, cons in zip(arrays, arrays[1:]):
        if not compatible(prod.output_domain, cons.input_domain):
            raise DesignCheckError(
                f"analog domain mismatch: {prod.name!r} outputs "
                f"{prod.output_domain} but {cons.name!r} consumes "
                f"{cons.input_domain}; insert a conversion component "
                f"(Sec. 3.3)")
        if prod.num_output != cons.num_input:
            notes.append(
                f"signal-width mismatch {prod.name!r}->{cons.name!r} "
                f"({prod.num_output} vs {cons.num_input}): an analog buffer "
                f"is required in-between (energy implications, Sec. 3.3)")

    # --- ADC between analog and digital domains --------------------------
    analog_names = {a.name for a in hw.analog_arrays}
    for s in order:
        unit = mapping.unit_for(s)
        if unit in hw.digital:
            # find an analog producer feeding this digital stage
            for dep in s.inputs:
                dep_unit = mapping.stage_to_unit.get(dep.name)
                if dep_unit in analog_names:
                    arr = next(a for a in hw.analog_arrays if a.name == dep_unit)
                    if arr.output_domain != Domain.DIGITAL:
                        raise DesignCheckError(
                            f"stage {s.name!r} is digital but its producer "
                            f"{dep.name!r} on {dep_unit!r} outputs "
                            f"{arr.output_domain}; an ADC must sit between "
                            f"the analog and digital domains")
    return notes
