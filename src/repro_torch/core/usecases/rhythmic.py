# Verbatim copy of src/repro/core/usecases/rhythmic.py (jax-free model layer).
"""Rhythmic Pixel Regions use-case (Fig. 8a): ROI-based image encoder.

Pipeline: 1280x720 pixels -> Compare & Sample accelerator (7.4e6 ops/frame)
-> ROI encoding that halves the transmitted image.  Communication-dominant:
the in-sensor variant trades MIPI bytes for (older-node) compute energy.
"""
from __future__ import annotations

from ..acomponent import ActivePixelSensor, AnalogToDigitalConverter
from ..afa import AnalogArray
from ..digital import ComputeUnit, LineBuffer
from ..hw import HWConfig
from ..mapping import Mapping
from ..sw import PixelInput, ProcessStage

H, W = 720, 1280
ROI_FRACTION = 0.5                # ROI keeps 50 % of the image
OPS_PER_FRAME = 7.4e6             # Sec. 6.1
FPS = 30.0

RHYTHMIC_VARIANTS = ("2d_in", "2d_off", "3d_in")


def _stages():
    px = PixelInput(name="pixels", output_size=(H, W))
    adc = ProcessStage(name="adc", input_size=(H, W), kernel_size=(1, 1),
                       stride=(1, 1), output_size=(H, W))
    adc.set_input_stage(px)
    # compare & sample: ~8 ops/pixel over the full frame => 7.4e6 ops
    cmp = ProcessStage(name="compare_sample", input_size=(H, W),
                       kernel_size=(1, 1), stride=(1, 1), output_size=(H, W),
                       ops_per_output=OPS_PER_FRAME / (H * W))
    cmp.set_input_stage(adc)
    roi = ProcessStage(name="roi_encode", input_size=(H, W),
                       kernel_size=(1, 1), stride=(1, 1),
                       output_size=(int(H * ROI_FRACTION), W),
                       irregular=True)
    roi.set_input_stage(cmp)
    return [px, adc, cmp, roi]


def build_rhythmic(variant: str, cis_node: int = 65, soc_node: int = 22):
    assert variant in RHYTHMIC_VARIANTS, variant
    stacked = variant == "3d_in"
    off = variant == "2d_off"
    compute_node = soc_node if (stacked or off) else cis_node
    compute_layer = 1 if stacked else 0

    hw = HWConfig(name=f"rhythmic_{variant}_{cis_node}nm", frame_rate=FPS,
                  stacked=stacked, num_layers=2 if stacked else 1,
                  process_nodes=[cis_node, compute_node] if stacked
                  else [cis_node],
                  pixel_pitch_um=3.0)
    hw.add_analog_array(AnalogArray(
        name="pixel_array", num_components=H * W,
        component=ActivePixelSensor(num_transistors=4, pd_capacitance=4e-15,
                                    fd_capacitance=2e-15,
                                    sf_load_capacitance=1.2e-12,
                                    v_swing=1.0, vdda=2.5),
        num_input=(H, W), num_output=(H, W)))
    hw.add_analog_array(AnalogArray(
        name="adc_array", num_components=W,
        component=AnalogToDigitalConverter(resolution_bits=8),
        num_input=(1, W), num_output=(1, W)))

    # 2 KB of line buffering (the paper notes the design needs only ~2K)
    hw.add_memory(LineBuffer(name="line_buffer", capacity_bytes=2048,
                             num_lines=2, bits_per_access=64,
                             process_node_nm=compute_node,
                             layer=compute_layer, technology="sram_hp",
                             active_fraction=0.6))
    hw.add_compute(ComputeUnit(name="cmp_sample",
                               energy_per_cycle=_cycle_e(compute_node),
                               input_pixels_per_cycle=(1, 8),
                               output_pixels_per_cycle=(1, 8), num_stages=3,
                               clock_mhz=250, process_node_nm=compute_node,
                               layer=compute_layer),
                   input_memory="line_buffer", output_memory="line_buffer")
    hw.add_compute(ComputeUnit(name="roi_encoder",
                               energy_per_cycle=_cycle_e(compute_node),
                               input_pixels_per_cycle=(1, 8),
                               output_pixels_per_cycle=(1, 8), num_stages=2,
                               clock_mhz=250, process_node_nm=compute_node,
                               layer=compute_layer),
                   input_memory="line_buffer", output_memory=None)

    mapping = Mapping({"pixels": "pixel_array", "adc": "adc_array",
                       "compare_sample": "cmp_sample",
                       "roi_encode": "roi_encoder"},
                      off_sensor_stages=(["compare_sample", "roi_encode"]
                                         if off else []))
    meta = dict(pixels=H * W, variant=variant, cis_node=cis_node,
                soc_node=soc_node, fps=FPS)
    return hw, _stages(), mapping, meta


def _cycle_e(node: int) -> float:
    from ..constants import scale_energy
    return scale_energy(1.2e-12, node, 65)
