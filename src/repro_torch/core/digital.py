# Verbatim copy of src/repro/core/digital.py (jax-free model layer).
"""Digital hardware units (Tbl. 1, digital column) + cycle-level simulation.

CamJ deliberately asks the user for per-cycle / per-access energy of digital
units (Sec. 3.2): these come from synthesis flows or tools like CACTI /
DESTINY.  CamJ contributes the *access counts* and *cycle counts* via
cycle-level simulation of the declared pipeline, plus stall checks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from .constants import (DIGITAL_MAC_ENERGY_65NM, STT_LEAKAGE_PER_BIT,
                        STT_READ_ENERGY_PER_BIT_65, STT_WRITE_ENERGY_PER_BIT_65,
                        scale_energy, sram_access_energy, sram_leakage_per_bit)


# ---------------------------------------------------------------------------
# Compute units
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ComputeUnit:
    """Generic pipelined accelerator (Sec. 3.3).

    Parameters mirror the paper's interface: the shape of pixels consumed per
    cycle, produced per cycle, and the pipeline depth.  ``energy_per_cycle``
    is user-supplied (synthesis result).
    """
    name: str
    energy_per_cycle: float                 # J/cycle, user supplied
    input_pixels_per_cycle: Tuple[int, ...] = (1, 1)
    output_pixels_per_cycle: Tuple[int, ...] = (1, 1)
    num_stages: int = 1                     # pipeline depth
    clock_mhz: float = 50.0
    layer: int = 0                          # stack layer (for uTSV accounting)
    process_node_nm: int = 65
    static_power: float = 0.0               # W while active

    def outputs_per_cycle(self) -> int:
        n = 1
        for d in self.output_pixels_per_cycle:
            n *= int(d)
        return max(n, 1)

    def cycles_for_outputs(self, num_outputs: float) -> int:
        """Fully-pipelined: fill latency + one output bundle per cycle."""
        return int(math.ceil(num_outputs / self.outputs_per_cycle())) + self.num_stages

    def latency_for_outputs(self, num_outputs: float) -> float:
        return self.cycles_for_outputs(num_outputs) / (self.clock_mhz * 1e6)

    def energy_for_outputs(self, num_outputs: float) -> float:
        """Eq. 15: E = E_cycle * Num_cycle (+ static power over the run)."""
        cycles = self.cycles_for_outputs(num_outputs)
        return (self.energy_per_cycle * cycles
                + self.static_power * cycles / (self.clock_mhz * 1e6))


@dataclasses.dataclass
class SystolicArray:
    """Weight-stationary systolic array for DNN stages.

    Cycle model: a conv layer with ``macs`` multiply-accumulates runs at
    ``rows*cols*utilization`` MACs/cycle.  Per-MAC energy defaults to the
    synthesized 65 nm MAC of [5], scaled across nodes [60, 64].
    """
    name: str
    rows: int = 16
    cols: int = 16
    energy_per_mac: Optional[float] = None  # J; default = scaled 65nm MAC
    utilization: float = 0.85
    clock_mhz: float = 200.0
    layer: int = 0
    process_node_nm: int = 65
    static_power: float = 0.0

    def mac_energy(self) -> float:
        if self.energy_per_mac is not None:
            return self.energy_per_mac
        return scale_energy(DIGITAL_MAC_ENERGY_65NM, self.process_node_nm, 65)

    def cycles_for_macs(self, macs: float) -> int:
        throughput = self.rows * self.cols * self.utilization
        return int(math.ceil(macs / throughput)) + self.rows + self.cols

    def latency_for_macs(self, macs: float) -> float:
        return self.cycles_for_macs(macs) / (self.clock_mhz * 1e6)

    def energy_for_macs(self, macs: float) -> float:
        e = self.mac_energy() * macs
        e += self.static_power * self.latency_for_macs(macs)
        return e

    # ComputeUnit-compatible aliases used by the scheduler
    def outputs_per_cycle(self) -> int:
        return max(int(self.rows * self.cols * self.utilization), 1)


# ---------------------------------------------------------------------------
# Memory structures
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class MemoryBase:
    name: str
    capacity_bytes: float = 1024.0
    bits_per_access: int = 8
    num_ports: int = 1
    process_node_nm: int = 65
    layer: int = 0
    technology: str = "sram"                # sram | sram_hp | stt
    read_energy_per_access: Optional[float] = None   # J, user supplied
    write_energy_per_access: Optional[float] = None
    leakage_power: Optional[float] = None            # W, user supplied
    #: fraction of the frame time the macro is powered (alpha in Eq. 16)
    active_fraction: float = 1.0

    def _default_access_energy(self, write: bool) -> float:
        if self.technology == "stt":
            per_bit = (STT_WRITE_ENERGY_PER_BIT_65 if write
                       else STT_READ_ENERGY_PER_BIT_65)
            return scale_energy(per_bit * self.bits_per_access,
                                self.process_node_nm, 65)
        return sram_access_energy(self.capacity_bytes, self.bits_per_access,
                                  self.process_node_nm)

    def read_energy(self) -> float:
        if self.read_energy_per_access is not None:
            return self.read_energy_per_access
        return self._default_access_energy(write=False)

    def write_energy(self) -> float:
        if self.write_energy_per_access is not None:
            return self.write_energy_per_access
        return self._default_access_energy(write=True)

    def leakage(self) -> float:
        if self.leakage_power is not None:
            return self.leakage_power
        if self.technology == "stt":
            return STT_LEAKAGE_PER_BIT * self.capacity_bytes * 8
        hp = self.technology == "sram_hp"
        return sram_leakage_per_bit(self.process_node_nm,
                                    high_performance=hp) * self.capacity_bytes * 8

    def energy_per_frame(self, num_reads: float, num_writes: float,
                         frame_time: float) -> float:
        """Eq. 16: dynamic read/write + leakage over the active fraction."""
        return (self.read_energy() * num_reads
                + self.write_energy() * num_writes
                + self.leakage() * frame_time * self.active_fraction)


@dataclasses.dataclass
class FIFO(MemoryBase):
    pass


@dataclasses.dataclass
class LineBuffer(MemoryBase):
    """Line buffer holding ``num_lines`` image rows of ``line_width`` pixels.

    A consumer with a k-row stencil can start once ``k`` lines are resident
    (Sec. 4.1 example: edge detection starts after the second line).
    """
    num_lines: int = 2
    line_width: int = 0

    def __post_init__(self):
        if self.line_width and not self.capacity_bytes:
            self.capacity_bytes = self.num_lines * self.line_width * \
                self.bits_per_access / 8.0


@dataclasses.dataclass
class DoubleBuffer(MemoryBase):
    """Double-buffered SRAM: producer fills one half while consumer drains
    the other, hiding the hand-off (capacity check uses half the size)."""
    pass
