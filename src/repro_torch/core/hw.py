# Verbatim copy of src/repro/core/hw.py (jax-free model layer).
"""Hardware description: the full computational-CIS system (Sec. 3.3).

A ``HWConfig`` assembles analog functional arrays, digital compute units and
memory structures, plus the physical structure needed for communication
accounting (2-D vs 3-D stacking, layer assignment) and power-density
estimation (pixel pitch, process nodes per layer).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

from .afa import AnalogArray
from .digital import ComputeUnit, MemoryBase, SystolicArray

DigitalUnit = Union[ComputeUnit, SystolicArray]


@dataclasses.dataclass
class DigitalBinding:
    """Wiring of one digital compute unit into the memory fabric."""
    unit: DigitalUnit
    input_memory: Optional[str] = None    # memory name
    output_memory: Optional[str] = None


@dataclasses.dataclass
class HWConfig:
    name: str = "cis"
    #: analog arrays in signal-flow order (pixel array first)
    analog_arrays: List[AnalogArray] = dataclasses.field(default_factory=list)
    digital: Dict[str, DigitalBinding] = dataclasses.field(default_factory=dict)
    memories: Dict[str, MemoryBase] = dataclasses.field(default_factory=dict)

    # --- physical structure -------------------------------------------
    stacked: bool = False
    num_layers: int = 1
    #: process node per stack layer, nm (layer 0 = pixel layer)
    process_nodes: List[int] = dataclasses.field(default_factory=lambda: [65])
    pixel_pitch_um: float = 3.0
    frame_rate: float = 30.0              # FPS target (drives T_A, Sec. 4.1)
    #: where results leave the sensor: bytes * MIPI energy (Eq. 17)
    output_bits_per_element: int = 8

    # ------------------------------------------------------------------
    def add_analog_array(self, array: AnalogArray) -> "HWConfig":
        self.analog_arrays.append(array)
        return self

    def add_memory(self, mem: MemoryBase) -> "HWConfig":
        self.memories[mem.name] = mem
        return self

    def add_compute(self, unit: DigitalUnit, input_memory: Optional[str] = None,
                    output_memory: Optional[str] = None) -> "HWConfig":
        self.digital[unit.name] = DigitalBinding(unit, input_memory,
                                                 output_memory)
        return self

    def frame_time(self) -> float:
        return 1.0 / self.frame_rate

    def node_for_layer(self, layer: int) -> int:
        if layer < len(self.process_nodes):
            return self.process_nodes[layer]
        return self.process_nodes[-1]

    # --- area model (conservative, Sec. 6.2 "Power Density") ----------
    def analog_area_mm2(self) -> float:
        """Approximate analog area by the pixel array area."""
        if not self.analog_arrays:
            return 0.0
        pixels = self.analog_arrays[0].num_components
        return pixels * (self.pixel_pitch_um * 1e-3) ** 2

    def digital_area_mm2(self) -> float:
        """Approximate digital area by total SRAM macro area (150 F^2/bit)."""
        area = 0.0
        for mem in self.memories.values():
            node_m = self.node_for_layer(mem.layer) * 1e-9
            cell_area_mm2 = 150.0 * (node_m * 1e3) ** 2  # mm^2 per bit
            area += mem.capacity_bytes * 8 * cell_area_mm2
        return area

    def total_area_mm2(self) -> float:
        if self.stacked:
            # stacked: footprint is the max layer, not the sum
            return max(self.analog_area_mm2(), self.digital_area_mm2())
        return self.analog_area_mm2() + self.digital_area_mm2()
