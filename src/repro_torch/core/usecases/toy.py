# Verbatim copy of src/repro/core/usecases/toy.py (jax-free model layer).
"""Toy corner-detector pipeline: the algorithm-registry demo use-case.

Not from the paper — a deliberately small third pipeline (QVGA pixel
array -> column ADC -> 3x3 gradient -> corner thresholding) used by the
example and the tests to show that a NEW algorithm is a registry entry,
not a core-file edit:

    from repro.explore import DesignSpace, explore, register_algorithm
    from repro.core.usecases.toy import TOY_VARIANTS, build_toy
    register_algorithm("toy", build_toy, TOY_VARIANTS)
    explore(DesignSpace(["edgaze", "toy"], grids))

Its lowered plan stacks into the same PlanBank and rides the same single
step executable as the built-ins (tests/test_explore.py pins both the
staged-oracle parity and the executable count).
"""
from __future__ import annotations

from ..acomponent import ActivePixelSensor, AnalogToDigitalConverter
from ..afa import AnalogArray
from ..digital import ComputeUnit, LineBuffer
from ..hw import HWConfig
from ..mapping import Mapping
from ..sw import PixelInput, ProcessStage

H, W = 240, 320                    # QVGA
CORNER_FRACTION = 0.25             # thresholding keeps ~25 % of the rows
FPS = 30.0

TOY_VARIANTS = ("2d_in", "2d_off")


def _stages():
    px = PixelInput(name="pixels", output_size=(H, W))
    adc = ProcessStage(name="adc", input_size=(H, W), kernel_size=(1, 1),
                       stride=(1, 1), output_size=(H, W))
    adc.set_input_stage(px)
    grad = ProcessStage(name="gradient", input_size=(H, W),
                        kernel_size=(3, 3), stride=(1, 1),
                        output_size=(H - 2, W - 2), ops_per_output=2.0)
    grad.set_input_stage(adc)
    corners = ProcessStage(name="corner_select", input_size=(H - 2, W - 2),
                           kernel_size=(1, 1), stride=(1, 1),
                           output_size=(int(H * CORNER_FRACTION), W - 2),
                           irregular=True)
    corners.set_input_stage(grad)
    return [px, adc, grad, corners]


def build_toy(variant: str, cis_node: int = 65, soc_node: int = 22):
    """Returns (hw, stages, mapping, meta) for the requested variant."""
    assert variant in TOY_VARIANTS, variant
    off = variant == "2d_off"
    compute_node = soc_node if off else cis_node

    hw = HWConfig(name=f"toy_{variant}_{cis_node}nm", frame_rate=FPS,
                  stacked=False, num_layers=1, process_nodes=[cis_node],
                  pixel_pitch_um=3.0)
    hw.add_analog_array(AnalogArray(
        name="pixel_array", num_components=H * W,
        component=ActivePixelSensor(num_transistors=4, pd_capacitance=4e-15,
                                    fd_capacitance=2e-15,
                                    sf_load_capacitance=1.0e-12,
                                    v_swing=1.0, vdda=2.5),
        num_input=(H, W), num_output=(H, W)))
    hw.add_analog_array(AnalogArray(
        name="adc_array", num_components=W,
        component=AnalogToDigitalConverter(resolution_bits=10),
        num_input=(1, W), num_output=(1, W)))

    hw.add_memory(LineBuffer(name="line_buffer", capacity_bytes=8192,
                             num_lines=3, bits_per_access=64,
                             process_node_nm=compute_node, layer=0,
                             technology="sram_hp", active_fraction=0.5))
    hw.add_compute(ComputeUnit(name="grad_unit",
                               energy_per_cycle=_cycle_e(compute_node),
                               input_pixels_per_cycle=(1, 8),
                               output_pixels_per_cycle=(1, 8), num_stages=3,
                               clock_mhz=200, process_node_nm=compute_node,
                               layer=0),
                   input_memory="line_buffer", output_memory="line_buffer")
    hw.add_compute(ComputeUnit(name="corner_unit",
                               energy_per_cycle=_cycle_e(compute_node),
                               input_pixels_per_cycle=(1, 8),
                               output_pixels_per_cycle=(1, 8), num_stages=2,
                               clock_mhz=200, process_node_nm=compute_node,
                               layer=0),
                   input_memory="line_buffer", output_memory=None)

    mapping = Mapping({"pixels": "pixel_array", "adc": "adc_array",
                       "gradient": "grad_unit",
                       "corner_select": "corner_unit"},
                      off_sensor_stages=(["gradient", "corner_select"]
                                         if off else []))
    meta = dict(pixels=H * W, variant=variant, cis_node=cis_node,
                soc_node=soc_node, fps=FPS)
    return hw, _stages(), mapping, meta


def _cycle_e(node: int) -> float:
    from ..constants import scale_energy
    return scale_energy(0.9e-12, node, 65)
