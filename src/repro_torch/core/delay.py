# Verbatim copy of src/repro/core/delay.py (jax-free model layer).
"""Delay estimation (Sec. 4.1).

The CIS pipeline is designed to *never stall*: pixels arrive at a constant
rate, so any stall accumulates frame latency.  CamJ exploits this invariant:

  1. simulate the digital domain cycle-by-cycle  ->  T_D
  2. the analog budget is what remains of the frame time, evenly split
     across the analog phases:  T_A = (T_FR - T_D) / N_phases

``N_phases`` counts the analog pipeline stages *plus the exposure phase*
(the worked example in Fig. 6 divides by 3 for two analog units: exposure,
binned readout, ADC).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from .digital import ComputeUnit, DoubleBuffer, FIFO, LineBuffer, SystolicArray
from .hw import HWConfig
from .mapping import Mapping
from .sw import DNNProcessStage, PixelInput, ProcessStage, Stage, topological_order


@dataclasses.dataclass
class StageTiming:
    start: float
    end: float
    cycles: int

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class DelayReport:
    frame_time: float
    digital_latency: float          # T_D
    analog_stage_delay: float       # T_A
    num_analog_phases: int
    digital_timings: Dict[str, StageTiming]
    stall_warnings: List[str]

    @property
    def feasible(self) -> bool:
        return self.analog_stage_delay > 0 and not self.stall_warnings


def _stencil_rows(stage: Stage) -> int:
    if isinstance(stage, (ProcessStage, DNNProcessStage)):
        return int(stage.kernel_size[0])
    return 1


def start_weight(hw: HWConfig, binding, stage: Stage, dep: Stage) -> float:
    """Fraction of the producer's runtime the consumer must wait for.

    ``start = dep_start + w * dep_duration`` unifies the three memory
    hand-off rules of Sec. 4.1: a line buffer releases the consumer once the
    stencil-height rows are resident (w = rows/total), a FIFO streams
    (w = 0), and a double buffer / default hands off the full tile (w = 1).
    Shared by the cycle-level simulator below and the batched-engine
    lowering pass (plan.py), which bakes the weights into an edge matrix.
    """
    mem = (hw.memories.get(binding.input_memory)
           if binding.input_memory else None)
    if isinstance(mem, LineBuffer):
        rows_needed = max(_stencil_rows(stage), mem.num_lines)
        total_rows = dep.output_size[0] if dep.output_size else 1
        return min(rows_needed / max(total_rows, 1), 1.0)
    if isinstance(mem, FIFO):
        return 0.0
    return 1.0


def estimate_delays(hw: HWConfig, stages: List[Stage], mapping: Mapping,
                    host_clock_mhz: float = 500.0) -> DelayReport:
    """Cycle-level simulation of the digital stages + analog budget split."""
    order = topological_order(stages)
    t_fr = hw.frame_time()
    warnings: List[str] = []

    digital_stages = [s for s in order
                      if mapping.stage_to_unit.get(s.name) in hw.digital]

    timings: Dict[str, StageTiming] = {}
    end_time: Dict[str, float] = {}
    start_time: Dict[str, float] = {}

    for s in digital_stages:
        binding = hw.digital[mapping.unit_for(s)]
        unit = binding.unit

        # ----- when can this stage start? -------------------------------
        start = 0.0
        for dep in s.inputs:
            if dep.name in end_time:
                dep_start = start_time[dep.name]
                dep_end = end_time[dep.name]
                w = start_weight(hw, binding, s, dep)
                start = max(start, dep_start + (dep_end - dep_start) * w)
            # analog producers stream at the analog rate; digital consumers
            # may start immediately after the first rows -> approximated as 0.

        # ----- how long does it run? ------------------------------------
        if isinstance(unit, SystolicArray):
            macs = s.num_ops()
            cycles = unit.cycles_for_macs(macs)
            duration = unit.latency_for_macs(macs)
        else:
            outs = s.num_outputs()
            cycles = unit.cycles_for_outputs(outs)
            duration = unit.latency_for_outputs(outs)

        timings[s.name] = StageTiming(start, start + duration, cycles)
        start_time[s.name] = start
        end_time[s.name] = start + duration

        # ----- stall checks (Sec. 4.1, three scenarios) ------------------
        _check_stalls(hw, s, binding, warnings)

    t_d = max((t.end for t in timings.values()), default=0.0) - \
        min((t.start for t in timings.values()), default=0.0)

    # analog phases: each analog array is one pipeline phase, plus exposure
    num_analog = len(hw.analog_arrays)
    n_phases = max(num_analog + 1, 1)
    t_a = (t_fr - t_d) / n_phases

    if t_a <= 0:
        warnings.append(
            f"digital latency T_D={t_d:.3e}s exceeds the frame time "
            f"T_FR={t_fr:.3e}s: the pipeline cannot meet {hw.frame_rate} FPS; "
            f"re-design the digital units (Sec. 4.1)")

    return DelayReport(frame_time=t_fr, digital_latency=t_d,
                       analog_stage_delay=t_a, num_analog_phases=n_phases,
                       digital_timings=timings, stall_warnings=warnings)


def _check_stalls(hw: HWConfig, stage: Stage, binding, warnings: List[str]) -> None:
    """The three stall scenarios of Sec. 4.1."""
    unit = binding.unit
    # (1) producer rate vs consumer need is covered by the start-offset model;
    # here we check rate mismatch for streaming memories.
    # (2) memory in-between two stages is full.
    if binding.input_memory:
        mem = hw.memories.get(binding.input_memory)
        if mem is not None:
            bits = mem.bits_per_access
            if isinstance(mem, LineBuffer):
                need_rows = _stencil_rows(stage)
                row_bytes = (stage.input_size[1] * bits / 8.0
                             if isinstance(stage, (ProcessStage, DNNProcessStage))
                             else 0.0)
                need = need_rows * row_bytes
                if need > mem.capacity_bytes + 1e-9:
                    warnings.append(
                        f"memory {mem.name!r} too small for stage "
                        f"{stage.name!r}: stencil needs {need:.0f} B, "
                        f"capacity {mem.capacity_bytes:.0f} B")
            elif isinstance(mem, DoubleBuffer):
                if isinstance(stage, (ProcessStage, DNNProcessStage)):
                    ih, iw, ic = stage.input_size
                    need = ih * iw * ic * bits / 8.0
                    if need > mem.capacity_bytes / 2 + 1e-9:
                        warnings.append(
                            f"double buffer {mem.name!r} half-capacity "
                            f"{mem.capacity_bytes/2:.0f} B < working tile "
                            f"{need:.0f} B for stage {stage.name!r}")
    # (3) enough access ports.  A line buffer feeds one pixel per resident
    # line per cycle (the kxk window is assembled in shift registers), so the
    # requirement is stencil *rows*; other memories need the full pixel count.
    if binding.input_memory:
        mem = hw.memories.get(binding.input_memory)
        if mem is not None and isinstance(unit, ComputeUnit):
            if isinstance(mem, LineBuffer):
                need_ports = int(unit.input_pixels_per_cycle[0])
                avail = max(mem.num_ports, mem.num_lines)
            else:
                need_ports = 1
                for d in unit.input_pixels_per_cycle:
                    need_ports *= int(d)
                avail = mem.num_ports
            if need_ports > avail:
                warnings.append(
                    f"memory {mem.name!r} provides {avail} access(es)/cycle "
                    f"but unit {unit.name!r} needs {need_ports}")
