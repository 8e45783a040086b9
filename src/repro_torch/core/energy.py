# Verbatim copy of src/repro/core/energy.py (jax-free model layer).
"""Energy estimation orchestrator (Sec. 4, Eqs. 1-17).

    E_frame = E_analog + E_digital + E_communication          (Eq. 1)

The orchestrator runs design checks, the delay model, then walks the mapped
DAG accumulating per-unit energies into an ``EnergyReport`` with the
component-level breakdown the paper reports (SEN / COMP-A / MEM-A / COMP-D /
MEM-D / MIPI / uTSV).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .afa import AnalogArray
from .checks import run_design_checks
from .constants import MIPI_CSI2_ENERGY_PER_BYTE, UTSV_ENERGY_PER_BYTE
from .delay import DelayReport, estimate_delays
from .digital import MemoryBase, SystolicArray
from .hw import HWConfig
from .mapping import Mapping
from .sw import DNNProcessStage, PixelInput, ProcessStage, Stage, topological_order

#: component-level breakdown categories, in report order (Eq. 1 split);
#: the batched engine's output schema (``cat_<name>_j``) follows this.
CATEGORIES = ("SEN", "COMP-A", "MEM-A", "ADC", "COMP-D", "MEM-D", "MIPI",
              "UTSV")


@dataclasses.dataclass
class UnitEnergy:
    unit: str
    category: str            # SEN | COMP-A | MEM-A | ADC | COMP-D | MEM-D | MIPI | UTSV
    energy: float            # J per frame
    accesses: float = 0.0
    layer: int = 0
    off_sensor: bool = False


@dataclasses.dataclass
class EnergyReport:
    per_unit: List[UnitEnergy]
    delay: DelayReport
    notes: List[str]
    hw_name: str = ""

    # ------------------------------------------------------------------
    def total(self, include_off_sensor: bool = True) -> float:
        return sum(u.energy for u in self.per_unit
                   if include_off_sensor or not u.off_sensor)

    def by_category(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for u in self.per_unit:
            out[u.category] = out.get(u.category, 0.0) + u.energy
        return out

    def by_unit(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for u in self.per_unit:
            out[u.unit] = out.get(u.unit, 0.0) + u.energy
        return out

    def energy_per_pixel(self, num_pixels: int) -> float:
        return self.total() / max(num_pixels, 1)

    def power(self, frame_rate: float) -> float:
        return self.total() * frame_rate

    def on_sensor_power(self, frame_rate: float) -> float:
        return self.total(include_off_sensor=False) * frame_rate

    def pretty(self) -> str:
        lines = [f"EnergyReport[{self.hw_name}]  total={self.total()*1e6:.3f} uJ/frame"]
        for cat, e in sorted(self.by_category().items()):
            lines.append(f"  {cat:8s} {e*1e6:12.4f} uJ")
        lines.append(f"  T_D={self.delay.digital_latency*1e3:.3f} ms  "
                     f"T_A={self.delay.analog_stage_delay*1e3:.3f} ms  "
                     f"phases={self.delay.num_analog_phases}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
def _analog_array_by_name(hw: HWConfig, name: str) -> Optional[AnalogArray]:
    for a in hw.analog_arrays:
        if a.name == name:
            return a
    return None


def _category_for_array(arr: AnalogArray, idx: int) -> str:
    from .domains import Domain
    if idx == 0:
        return "SEN"  # the pixel array itself
    if arr.output_domain == Domain.DIGITAL:
        return "ADC"
    n = arr.name.lower()
    if "mem" in n or "buffer" in n or "sh_" in n:
        return "MEM-A"
    return "COMP-A"


def estimate_energy(hw: HWConfig, stages: List[Stage], mapping: Mapping,
                    strict: bool = True) -> EnergyReport:
    """Full CamJ estimation: checks -> delays -> Eqs. 1-17."""
    notes = run_design_checks(hw, stages, mapping)
    delay = estimate_delays(hw, stages, mapping)
    if strict and delay.stall_warnings:
        raise ValueError("pipeline stalls detected: "
                         + "; ".join(delay.stall_warnings))
    notes = notes + delay.stall_warnings

    order = topological_order(stages)
    per_unit: List[UnitEnergy] = []
    frame_time = hw.frame_time()

    # ----- analog domain (Eq. 2-13) -------------------------------------
    # collect ops mapped onto each analog array
    ops_per_array: Dict[str, float] = {}
    for s in order:
        unit = mapping.unit_for(s)
        if _analog_array_by_name(hw, unit) is not None:
            ops_per_array[unit] = ops_per_array.get(unit, 0.0) + s.num_ops()

    for idx, arr in enumerate(hw.analog_arrays):
        ops = ops_per_array.get(arr.name, 0.0)
        if ops == 0.0:
            continue
        e = arr.energy_per_frame(ops, delay.analog_stage_delay)
        per_unit.append(UnitEnergy(
            unit=arr.name, category=_category_for_array(arr, idx), energy=e,
            accesses=arr.accesses_per_component(ops) * arr.num_components,
            layer=arr.layer))

    # ----- digital domain (Eq. 14-16) ------------------------------------
    mem_reads: Dict[str, float] = {m: 0.0 for m in hw.memories}
    mem_writes: Dict[str, float] = {m: 0.0 for m in hw.memories}
    mem_off: Dict[str, bool] = {m: False for m in hw.memories}

    analog_names = {a.name for a in hw.analog_arrays}
    last_in_sensor: Optional[Stage] = None

    for s in order:
        unit_name = mapping.unit_for(s)
        off = mapping.is_off_sensor(s)
        if not off:
            last_in_sensor = s
        if unit_name not in hw.digital:
            continue
        binding = hw.digital[unit_name]
        unit = binding.unit

        if isinstance(unit, SystolicArray):
            macs = s.num_ops()
            e_comp = unit.energy_for_macs(macs)
            accesses = macs
        else:
            outs = s.num_outputs()
            e_comp = unit.energy_for_outputs(outs)
            accesses = unit.cycles_for_outputs(outs)
        per_unit.append(UnitEnergy(unit=unit_name, category="COMP-D",
                                   energy=e_comp, accesses=accesses,
                                   layer=unit.layer, off_sensor=off))

        # memory traffic: 1 read/tap (2 for DNN: weight + activation) divided
        # by the datapath reuse factor — a weight-stationary systolic array
        # re-uses each fetched operand across its ``rows`` PEs, so SRAM sees
        # ~2*MACs/rows accesses, not 2*MACs (standard dataflow accounting).
        if binding.input_memory in mem_reads:
            if isinstance(s, DNNProcessStage):
                reuse = unit.rows if isinstance(unit, SystolicArray) else 1.0
                factor = 2.0 / max(reuse, 1.0)
            else:
                factor = 1.0
            mem_reads[binding.input_memory] += factor * s.num_ops()
            mem_off[binding.input_memory] |= off
        if binding.output_memory in mem_writes:
            mem_writes[binding.output_memory] += s.num_outputs()
            mem_off[binding.output_memory] |= off
        # producer writes into this stage's input memory
        if binding.input_memory in mem_writes:
            for dep in s.inputs:
                mem_writes[binding.input_memory] += dep.num_outputs()

    for name, mem in hw.memories.items():
        e_mem = mem.energy_per_frame(mem_reads[name], mem_writes[name],
                                     frame_time)
        per_unit.append(UnitEnergy(unit=name, category="MEM-D", energy=e_mem,
                                   accesses=mem_reads[name] + mem_writes[name],
                                   layer=mem.layer, off_sensor=mem_off[name]))

    # ----- communication (Eq. 17) ----------------------------------------
    bits = hw.output_bits_per_element

    # uTSV: every producer->consumer edge that crosses stack layers
    if hw.stacked:
        tsv_bytes = 0.0
        for s in order:
            s_unit = mapping.unit_for(s)
            s_layer = _unit_layer(hw, s_unit)
            for dep in s.inputs:
                d_layer = _unit_layer(hw, mapping.unit_for(dep))
                if d_layer != s_layer and not mapping.is_off_sensor(s):
                    tsv_bytes += dep.output_bytes(bits)
        if tsv_bytes:
            per_unit.append(UnitEnergy(
                unit="utsv", category="UTSV",
                energy=tsv_bytes * UTSV_ENERGY_PER_BYTE, accesses=tsv_bytes))

    # MIPI: bytes leaving the sensor = outputs of the last in-sensor stage
    # feeding an off-sensor consumer, or the final outputs if everything is
    # in-sensor (results still leave the chip).
    mipi_bytes = 0.0
    off_stages = [s for s in order if mapping.is_off_sensor(s)]
    if off_stages:
        seen = set()
        for s in off_stages:
            for dep in s.inputs:
                if not mapping.is_off_sensor(dep) and id(dep) not in seen:
                    seen.add(id(dep))
                    mipi_bytes += dep.output_bytes(bits)
    else:
        sinks = _sink_stages(order)
        mipi_bytes = sum(s.output_bytes(bits) for s in sinks)
    per_unit.append(UnitEnergy(unit="mipi", category="MIPI",
                               energy=mipi_bytes * MIPI_CSI2_ENERGY_PER_BYTE,
                               accesses=mipi_bytes))

    return EnergyReport(per_unit=per_unit, delay=delay, notes=notes,
                        hw_name=hw.name)


def reference_outputs(report: EnergyReport, hw: HWConfig) -> Dict[str, float]:
    """Flatten a scalar report into the batched-engine output schema.

    Keys match ``repro.core.batch.evaluate_batch`` so the scalar path can
    serve as the reference oracle in parity tests and benchmarks.
    """
    cats = report.by_category()
    out = {f"cat_{c}_j": cats.get(c, 0.0) for c in CATEGORIES}
    out["total_j"] = report.total()
    out["on_sensor_j"] = report.total(include_off_sensor=False)
    out["t_d_s"] = report.delay.digital_latency
    out["t_a_s"] = report.delay.analog_stage_delay
    out["feasible"] = float(report.delay.analog_stage_delay > 0)
    out["area_mm2"] = hw.total_area_mm2()
    out["power_mw"] = report.on_sensor_power(hw.frame_rate) * 1e3
    out["density_mw_mm2"] = out["power_mw"] / max(out["area_mm2"], 1e-9)
    return out


def _unit_layer(hw: HWConfig, unit_name: str) -> int:
    arr = _analog_array_by_name(hw, unit_name)
    if arr is not None:
        return arr.layer
    if unit_name in hw.digital:
        return hw.digital[unit_name].unit.layer
    return 0


def _sink_stages(order: List[Stage]) -> List[Stage]:
    consumed = set()
    for s in order:
        for dep in s.inputs:
            consumed.add(id(dep))
    return [s for s in order if id(s) not in consumed]
