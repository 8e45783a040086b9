# Verbatim copy of src/repro/core/usecases/edgaze.py (jax-free model layer).
"""Ed-Gaze use-case (Fig. 8b / Fig. 10): gaze tracking with event-driven ROI.

Pipeline: 640x400 pixels -> 2x2 downsample (S1) -> frame subtraction against
the previous frame (S2) -> ROI DNN (S3, 5.76e7 MACs).  ROI reduces the image
transmitted off-chip to 75 % of full resolution.

Variants:
  2d_in       everything in the CIS at node H
  2d_off      CIS at H; everything post-ADC on a 22 nm SoC (full image on MIPI)
  3d_in       stacked: pixel layer at H, compute layer at L=22 nm
  3d_in_stt   3d_in with the SRAMs replaced by STT-RAM (NVMExplorer-style)
  2d_in_mixed S1+S2 in the analog domain (Sec. 6.3, Fig. 10)

The frame buffer (previous downsampled frame) can never be power-gated
(alpha=1): a frame must be retained for subtraction — the leakage effect the
paper highlights at 65 nm.  The DNN SRAM is event-driven and power-gated
outside its run window (alpha=0.15).
"""
from __future__ import annotations

from ..acomponent import (ActivePixelSensor, AnalogSubtractor,
                          AnalogToDigitalConverter, Comparator,
                          PassiveAnalogMemory, PassiveAverager)
from ..afa import AnalogArray
from ..digital import ComputeUnit, DoubleBuffer, SystolicArray
from ..hw import HWConfig
from ..mapping import Mapping
from ..sw import DNNProcessStage, PixelInput, ProcessStage

H, W = 400, 640
DH, DW = H // 2, W // 2            # 200 x 320 after 2x2 downsample
DNN_MACS = 5.76e7                  # per frame (Sec. 6.1)
ROI_FRACTION = 0.75                # ROI keeps 75 % of the image
FPS = 30.0

EDGAZE_VARIANTS = ("2d_in", "2d_off", "3d_in", "3d_in_stt", "2d_in_mixed")


def _stages(mixed: bool):
    px = PixelInput(name="pixels", output_size=(H, W))
    s1 = ProcessStage(name="downsample", input_size=(H, W), kernel_size=(2, 2),
                      stride=(2, 2), output_size=(DH, DW))
    s1.set_input_stage(px)
    s2 = ProcessStage(name="frame_sub", input_size=(DH, DW),
                      kernel_size=(1, 1), stride=(1, 1), output_size=(DH, DW),
                      ops_per_output=2.0)   # subtract + threshold
    s2.set_input_stage(s1)
    if not mixed:
        adc = ProcessStage(name="adc", input_size=(H, W), kernel_size=(1, 1),
                           stride=(1, 1), output_size=(H, W))
        adc.set_input_stage(px)
        s1.inputs = [adc]
    else:
        # events are digitized by per-column comparators after S2
        adc = ProcessStage(name="digitize", input_size=(DH, DW),
                           kernel_size=(1, 1), stride=(1, 1),
                           output_size=(DH, DW))
        adc.set_input_stage(s2)
    # S3: the ROI DNN — geometry chosen to land on 5.76e7 MACs:
    # 100x160x8 out, 3x3 kernel, 5 in-ch => 100*160*8*9*5 = 5.76e6... use
    # explicit conv dims: out 100x160x16, k 3x3, in 25 ch -> 5.76e7.
    s3 = DNNProcessStage(name="roi_dnn", op_type="conv2d",
                         input_size=(DH, DW, 25), kernel_size=(3, 3),
                         stride=(2, 2), output_size=(100, 160, 16))
    s3.set_input_stage(adc if mixed else s2)
    out = ProcessStage(name="roi_out", input_size=(DH, DW), kernel_size=(1, 1),
                       stride=(1, 1),
                       output_size=(int(DH * ROI_FRACTION), DW),
                       irregular=True)
    out.set_input_stage(s3)
    if mixed:
        return [px, s1, s2, adc, s3, out]
    return [px, adc, s1, s2, s3, out]


def build_edgaze(variant: str, cis_node: int = 65, soc_node: int = 22):
    """Returns (hw, stages, mapping, meta) for the requested variant."""
    assert variant in EDGAZE_VARIANTS, variant
    mixed = variant == "2d_in_mixed"
    stacked = variant.startswith("3d")
    off = variant == "2d_off"
    compute_node = soc_node if (stacked or off) else cis_node
    compute_layer = 1 if stacked else 0
    mem_tech = "stt" if variant == "3d_in_stt" else "sram_hp"

    hw = HWConfig(name=f"edgaze_{variant}_{cis_node}nm",
                  frame_rate=FPS, stacked=stacked,
                  num_layers=2 if stacked else 1,
                  process_nodes=[cis_node, compute_node] if stacked
                  else [cis_node],
                  pixel_pitch_um=5.0)

    # ----- analog front end ---------------------------------------------
    pixel_array = AnalogArray(
        name="pixel_array", num_components=H * W,
        component=ActivePixelSensor(num_transistors=4, pd_capacitance=5e-15,
                                    fd_capacitance=2.5e-15,
                                    sf_load_capacitance=1.5e-12,
                                    v_swing=1.0, vdda=2.5),
        num_input=(H, W), num_output=(H, W))
    hw.add_analog_array(pixel_array)

    if mixed:
        # S1 in-pixel binning (charge domain) + analog frame buffer + analog
        # subtract PE + comparator bank.  All capacitors 100 fF (Sec. 6.3,
        # conservative sizing).
        pixel_array.add_component(PassiveAverager(num_capacitors=4,
                                                  capacitance=100e-15))
        amem = AnalogArray(name="analog_frame_buffer",
                           num_components=DH * DW,
                           component=PassiveAnalogMemory(capacitance=100e-15),
                           num_input=(DH, DW), num_output=(DH, DW))
        hw.add_analog_array(amem)
        pe = AnalogArray(name="analog_pe_array", num_components=DW,
                         component=AnalogSubtractor(capacitance=100e-15,
                                                    use_opamp=True,
                                                    opamp_load=100e-15,
                                                    vdda=2.5),
                         num_input=(DH, DW), num_output=(DH, DW))
        pe.add_component(Comparator())
        hw.add_analog_array(pe)
    else:
        hw.add_analog_array(AnalogArray(
            name="adc_array", num_components=W,
            component=AnalogToDigitalConverter(resolution_bits=8),
            num_input=(1, W), num_output=(1, W)))

    # ----- digital units --------------------------------------------------
    # frame buffer: previous downsampled frame, never gated (alpha = 1)
    if not mixed:
        hw.add_memory(DoubleBuffer(name="frame_buffer",
                                   capacity_bytes=2 * DH * DW,
                                   bits_per_access=64,
                                   process_node_nm=compute_node,
                                   layer=compute_layer, technology=mem_tech,
                                   active_fraction=1.0))
        # event map + activation staging buffers (also retained: they feed the
        # event-driven DNN asynchronously)
        hw.add_memory(DoubleBuffer(name="event_buffer",
                                   capacity_bytes=3 * DH * DW,
                                   bits_per_access=64,
                                   process_node_nm=compute_node,
                                   layer=compute_layer, technology=mem_tech,
                                   active_fraction=1.0))
        hw.add_compute(
            ComputeUnit(name="preproc", energy_per_cycle=_cycle_e(compute_node),
                        input_pixels_per_cycle=(2, 8),
                        output_pixels_per_cycle=(1, 4), num_stages=4,
                        clock_mhz=200, process_node_nm=compute_node,
                        layer=compute_layer),
            input_memory="frame_buffer", output_memory="event_buffer")

    # DNN weights + activations; event-driven => power-gated when idle
    hw.add_memory(DoubleBuffer(name="dnn_sram", capacity_bytes=256e3,
                               bits_per_access=64,
                               process_node_nm=compute_node,
                               layer=compute_layer, technology=mem_tech,
                               active_fraction=0.15))
    hw.add_compute(SystolicArray(name="dnn", rows=16, cols=16,
                                 clock_mhz=200, process_node_nm=compute_node,
                                 layer=compute_layer),
                   input_memory="dnn_sram", output_memory="dnn_sram")
    hw.add_compute(ComputeUnit(name="roi_filter",
                               energy_per_cycle=_cycle_e(compute_node),
                               input_pixels_per_cycle=(1, 8),
                               output_pixels_per_cycle=(1, 8), num_stages=2,
                               clock_mhz=200, process_node_nm=compute_node,
                               layer=compute_layer),
                   input_memory="dnn_sram", output_memory=None)

    # ----- mapping ---------------------------------------------------------
    if mixed:
        mapping = Mapping({"pixels": "pixel_array",
                           "downsample": "pixel_array",
                           "frame_sub": "analog_pe_array",
                           "digitize": "analog_pe_array",
                           "roi_dnn": "dnn", "roi_out": "roi_filter"})
    else:
        mapping = Mapping({"pixels": "pixel_array", "adc": "adc_array",
                           "downsample": "preproc", "frame_sub": "preproc",
                           "roi_dnn": "dnn", "roi_out": "roi_filter"},
                          off_sensor_stages=(["downsample", "frame_sub",
                                              "roi_dnn", "roi_out"]
                                             if off else []))

    meta = dict(pixels=H * W, variant=variant, cis_node=cis_node,
                soc_node=soc_node, dnn_macs=DNN_MACS, fps=FPS)
    return hw, _stages(mixed), mapping, meta


def _cycle_e(node: int) -> float:
    from ..constants import scale_energy
    return scale_energy(1.2e-12, node, 65)
