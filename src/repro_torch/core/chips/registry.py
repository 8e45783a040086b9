# Verbatim copy of src/repro/core/chips/registry.py (jax-free model layer).
"""Builders for the nine Tbl. 2 validation chips.

Every builder returns ``(hw, stages, mapping, meta)`` where meta carries the
reported reference numbers and the frame geometry.  Circuit parameters follow
the original papers where reported; the rest are CamJ-default implementations
(Sec. 4.2).  Reference per-pixel energies are headline numbers from the chip
papers (see module docstring in __init__).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

from ..acomponent import (ActiveAnalogMemory, ActivePixelSensor,
                          AnalogAdder, AnalogLog, AnalogMax,
                          AnalogSubtractor, AnalogToDigitalConverter,
                          Comparator, CurrentMirrorMAC, DigitalPixelSensor,
                          PassiveAnalogMemory, PassiveAverager,
                          PulseWidthModulationPixel, SwitchedCapacitorMAC)
from ..afa import AnalogArray
from ..digital import ComputeUnit, DoubleBuffer, LineBuffer, SystolicArray
from ..hw import HWConfig
from ..mapping import Mapping
from ..sw import DNNProcessStage, PixelInput, ProcessStage


def _pixel_stage(h: int, w: int) -> PixelInput:
    return PixelInput(name="pixels", output_size=(h, w))


def _adc_stage(h: int, w: int, src) -> ProcessStage:
    s = ProcessStage(name="adc", input_size=(h, w), kernel_size=(1, 1),
                     stride=(1, 1), output_size=(h, w))
    s.set_input_stage(src)
    return s


# ---------------------------------------------------------------------------
# 1. ISSCC'17 [5]  Bong et al. — 65 nm 2D, 3T APS, analog avg&add (Haar),
#    digital CNN (160 KB SRAM, 4x4x64 MACs), always-on face recognition @1fps.
# ---------------------------------------------------------------------------
def isscc17():
    H, W = 240, 320
    hw = HWConfig(name="isscc17", frame_rate=1.0, process_nodes=[65],
                  pixel_pitch_um=7.5)
    hw.add_analog_array(AnalogArray(
        name="pixel_array", num_components=H * W,
        component=ActivePixelSensor(num_transistors=3, pd_capacitance=8e-15,
                                    sf_load_capacitance=1.2e-12, v_swing=1.0,
                                    vdda=2.5, correlated_double_sampling=False),
        num_input=(H, W), num_output=(H, W)))
    hw.add_analog_array(AnalogArray(
        name="haar_array", num_components=W,
        component=AnalogAdder(capacitance=150e-15),
        num_input=(1, W), num_output=(1, W)))
    hw.add_analog_array(AnalogArray(
        name="adc_array", num_components=W,
        component=AnalogToDigitalConverter(resolution_bits=8),
        num_input=(1, W), num_output=(1, W)))
    hw.add_memory(DoubleBuffer(name="sram", capacity_bytes=160e3,
                               bits_per_access=64, process_node_nm=65,
                               read_energy_per_access=3.5e-12,
                               write_energy_per_access=4.0e-12))
    hw.add_compute(SystolicArray(name="cnn", rows=16, cols=16,
                                 energy_per_mac=2.9e-12, clock_mhz=100,
                                 process_node_nm=65),
                   input_memory="sram", output_memory="sram")

    px = _pixel_stage(H, W)
    haar = ProcessStage(name="haar", input_size=(H, W), kernel_size=(2, 2),
                        stride=(2, 2), output_size=(H // 2, W // 2))
    haar.set_input_stage(px)
    adc = _adc_stage(H // 2, W // 2, haar)
    cnn = DNNProcessStage(name="cnn_stage", op_type="conv2d",
                          input_size=(H // 2, W // 2, 48), kernel_size=(5, 5),
                          stride=(1, 1), output_size=(29, 39, 128))
    cnn.set_input_stage(adc)
    stages = [px, haar, adc, cnn]
    mapping = Mapping({"pixels": "pixel_array", "haar": "haar_array",
                       "adc": "adc_array", "cnn_stage": "cnn"})
    meta = dict(pixels=H * W, reported_pj_per_pixel=8070.0, approx=True,
                source="0.62 mW @ QVGA, 1 fps always-on [5]")
    return hw, stages, mapping, meta


# ---------------------------------------------------------------------------
# 2. JSSC'19 [72]  Young et al. — 130 nm, 4T APS, column log-gradient
#    (logarithmic subtraction), 1.5/2.75-bit compressive readout, no digital.
# ---------------------------------------------------------------------------
def jssc19():
    H, W = 240, 320
    hw = HWConfig(name="jssc19", frame_rate=30.0, process_nodes=[130],
                  pixel_pitch_um=5.0, output_bits_per_element=4)
    hw.add_analog_array(AnalogArray(
        name="pixel_array", num_components=H * W,
        component=ActivePixelSensor(num_transistors=4, pd_capacitance=6e-15,
                                    fd_capacitance=3e-15,
                                    sf_load_capacitance=1.8e-12, v_swing=0.9,
                                    vdda=2.8),
        num_input=(H, W), num_output=(H, W)))
    log_arr = AnalogArray(
        name="log_grad", num_components=W,
        component=AnalogLog(bias_current=1.1e-6, vdda=2.8),
        num_input=(1, W), num_output=(1, W))
    log_arr.add_component(AnalogSubtractor(capacitance=80e-15, use_opamp=False))
    hw.add_analog_array(log_arr)
    hw.add_analog_array(AnalogArray(
        name="adc_array", num_components=W,
        component=AnalogToDigitalConverter(
            resolution_bits=3, energy_per_conversion=1.1e-12),
        num_input=(1, W), num_output=(1, W)))

    px = _pixel_stage(H, W)
    grad = ProcessStage(name="loggrad", input_size=(H, W), kernel_size=(2, 2),
                        stride=(1, 1), output_size=(H - 1, W - 1))
    grad.set_input_stage(px)
    adc = _adc_stage(H - 1, W - 1, grad)
    stages = [px, grad, adc]
    mapping = Mapping({"pixels": "pixel_array", "loggrad": "log_grad",
                       "adc": "adc_array"})
    meta = dict(pixels=H * W, reported_pj_per_pixel=170.0, approx=True,
                source="~0.4 mW @ QVGA 30 fps multi-scale readout [72]")
    return hw, stages, mapping, meta


# ---------------------------------------------------------------------------
# 3. Sensors'20 [13]  Choi et al. — 110 nm, 4T APS, column MAC + MaxPool
#    (first CNN layer in analog), always-on.
# ---------------------------------------------------------------------------
def sensors20():
    H, W = 240, 320
    hw = HWConfig(name="sensors20", frame_rate=30.0, process_nodes=[110],
                  pixel_pitch_um=4.5)
    hw.add_analog_array(AnalogArray(
        name="pixel_array", num_components=H * W,
        component=ActivePixelSensor(num_transistors=4, pd_capacitance=5e-15,
                                    fd_capacitance=2.5e-15,
                                    sf_load_capacitance=1.5e-12, v_swing=1.0,
                                    vdda=2.8),
        num_input=(H, W), num_output=(H, W)))
    mac_arr = AnalogArray(
        name="mac_array", num_components=W,
        component=SwitchedCapacitorMAC(num_capacitors=9, capacitance=200e-15,
                                       v_swing=1.0, vdda=2.8,
                                       opamp_load=500e-15),
        num_input=(1, W), num_output=(1, W))
    mac_arr.add_component(AnalogMax(num_inputs=4, bias_current=2.2e-6, vdda=2.8))
    hw.add_analog_array(mac_arr)
    hw.add_analog_array(AnalogArray(
        name="adc_array", num_components=W // 2,
        component=AnalogToDigitalConverter(resolution_bits=8),
        num_input=(1, W // 2), num_output=(1, W // 2)))

    px = _pixel_stage(H, W)
    conv1 = DNNProcessStage(name="conv1", op_type="conv2d",
                            input_size=(H, W, 1), kernel_size=(3, 3),
                            stride=(2, 2), output_size=(H // 2, W // 2, 1))
    conv1.set_input_stage(px)
    adc = _adc_stage(H // 2, W // 2, conv1)
    stages = [px, conv1, adc]
    mapping = Mapping({"pixels": "pixel_array", "conv1": "mac_array",
                       "adc": "adc_array"})
    meta = dict(pixels=H * W, reported_pj_per_pixel=250.0, approx=True,
                source="always-on analog CNN layer, ~0.58 mW @30 fps [13]")
    return hw, stages, mapping, meta


# ---------------------------------------------------------------------------
# 4. ISSCC'21 [16]  Sony IMX500 — 65/22 nm stacked, 12.3 Mp, column ADC,
#    digital DNN accelerator (8 MB, 2304 MACs) on the logic die.
# ---------------------------------------------------------------------------
def isscc21():
    H, W = 3040, 4056
    hw = HWConfig(name="isscc21", frame_rate=30.0, stacked=True, num_layers=2,
                  process_nodes=[65, 22], pixel_pitch_um=1.55)
    hw.add_analog_array(AnalogArray(
        name="pixel_array", num_components=H * W,
        component=ActivePixelSensor(num_transistors=4, pd_capacitance=1.5e-15,
                                    fd_capacitance=1.0e-15,
                                    sf_load_capacitance=8.0e-12, v_swing=0.6,
                                    vdda=2.8),
        num_input=(H, W), num_output=(H, W)))
    hw.add_analog_array(AnalogArray(
        name="adc_array", num_components=W,
        component=AnalogToDigitalConverter(resolution_bits=10,
                                           energy_per_conversion=800e-12),
        num_input=(1, W), num_output=(1, W)))
    hw.add_memory(DoubleBuffer(name="sram", capacity_bytes=8e6,
                               bits_per_access=256, process_node_nm=22,
                               layer=1, read_energy_per_access=22e-12,
                               write_energy_per_access=25e-12))
    hw.add_compute(SystolicArray(name="dnn", rows=48, cols=48,
                                 energy_per_mac=0.20e-12, clock_mhz=400,
                                 process_node_nm=22, layer=1),
                   input_memory="sram", output_memory="sram")
    hw.add_compute(ComputeUnit(name="readout_unit", energy_per_cycle=2e-12,
                               input_pixels_per_cycle=(1, 32),
                               output_pixels_per_cycle=(1, 32), num_stages=4,
                               clock_mhz=600, process_node_nm=22, layer=1),
                   input_memory="sram", output_memory=None)

    px = _pixel_stage(H, W)
    adc = _adc_stage(H, W, px)
    # MobileNet-class network on a 224x224 crop of the binned image
    dnn = DNNProcessStage(name="mobilenet", op_type="conv2d",
                          input_size=(224, 224, 32), kernel_size=(3, 3),
                          stride=(1, 1), output_size=(112, 112, 64))
    dnn.set_input_stage(adc)
    # the full 12.3 Mp image also streams out over MIPI alongside the DNN
    # results (the IMX500 outputs image + metadata)
    img_out = ProcessStage(name="image_out", input_size=(H, W),
                           kernel_size=(1, 1), stride=(1, 1),
                           output_size=(H, W))
    img_out.set_input_stage(adc)
    stages = [px, adc, dnn, img_out]
    mapping = Mapping({"pixels": "pixel_array", "adc": "adc_array",
                       "mobilenet": "dnn", "image_out": "readout_unit"})
    meta = dict(pixels=H * W, reported_pj_per_pixel=1030.0, approx=True,
                source="~380 mW @ 12.3 Mp 30 fps full pipeline [16]")
    return hw, stages, mapping, meta


# ---------------------------------------------------------------------------
# 5. JSSC'21-I [30]  Hsu et al. — 180 nm, PWM pixels, current-domain column
#    MAC feature extraction, 0.5 V.
# ---------------------------------------------------------------------------
def jssc21_i():
    H, W = 128, 128
    hw = HWConfig(name="jssc21_i", frame_rate=480.0, process_nodes=[180],
                  pixel_pitch_um=7.0, output_bits_per_element=6)
    hw.add_analog_array(AnalogArray(
        name="pixel_array", num_components=H * W,
        component=PulseWidthModulationPixel(pd_capacitance=10e-15,
                                            ramp_capacitance=15e-15,
                                            v_swing=0.5, vdda=0.5),
        num_input=(H, W), num_output=(H, W)))
    hw.add_analog_array(AnalogArray(
        name="mac_array", num_components=W,
        component=CurrentMirrorMAC(bias_current=0.15e-6, vdda=0.5, duty=0.4),
        num_input=(1, W), num_output=(1, W)))
    hw.add_analog_array(AnalogArray(
        name="adc_array", num_components=W,
        component=AnalogToDigitalConverter(resolution_bits=8,
                                           energy_per_conversion=2.0e-12),
        num_input=(1, W), num_output=(1, W)))

    px = _pixel_stage(H, W)
    feat = ProcessStage(name="feature", input_size=(H, W), kernel_size=(3, 3),
                        stride=(1, 1), output_size=(H - 2, W - 2))
    feat.set_input_stage(px)
    pool = ProcessStage(name="pool", input_size=(H - 2, W - 2),
                        kernel_size=(3, 3), stride=(3, 3),
                        output_size=(42, 42))
    pool.set_input_stage(feat)
    adc = _adc_stage(42, 42, pool)
    stages = [px, feat, pool, adc]
    mapping = Mapping({"pixels": "pixel_array", "feature": "mac_array",
                       "pool": "mac_array", "adc": "adc_array"})
    meta = dict(pixels=H * W, reported_pj_per_pixel=8.0, approx=True,
                source="64 uW @ 128x128, 480 fps, 0.5 V [30]")
    return hw, stages, mapping, meta


# ---------------------------------------------------------------------------
# 6. JSSC'21-II [54]  Park et al. — 110 nm, 4T APS, charge-domain column MAC,
#    4x compressive single-shot readout.  Headline: 51 pJ/pixel.
# ---------------------------------------------------------------------------
def jssc21_ii():
    H, W = 480, 640
    hw = HWConfig(name="jssc21_ii", frame_rate=30.0, process_nodes=[110],
                  pixel_pitch_um=3.0, output_bits_per_element=10)
    hw.add_analog_array(AnalogArray(
        name="pixel_array", num_components=H * W,
        component=ActivePixelSensor(num_transistors=4, pd_capacitance=4e-15,
                                    fd_capacitance=2e-15,
                                    sf_load_capacitance=1.4e-12, v_swing=0.8,
                                    vdda=2.8),
        num_input=(H, W), num_output=(H, W)))
    hw.add_analog_array(AnalogArray(
        name="cs_mac", num_components=W,
        component=SwitchedCapacitorMAC(num_capacitors=4, capacitance=25e-15,
                                       v_swing=0.8, vdda=2.8, use_opamp=False),
        num_input=(1, W), num_output=(1, W // 2)))
    hw.add_analog_array(AnalogArray(
        name="adc_array", num_components=W // 2,
        component=AnalogToDigitalConverter(resolution_bits=10,
                                           energy_per_conversion=55e-12),
        num_input=(1, W // 2), num_output=(1, W // 2)))

    px = _pixel_stage(H, W)
    cs = ProcessStage(name="compress", input_size=(H, W), kernel_size=(2, 2),
                      stride=(2, 2), output_size=(H // 2, W // 2))
    cs.set_input_stage(px)
    adc = _adc_stage(H // 2, W // 2, cs)
    stages = [px, cs, adc]
    mapping = Mapping({"pixels": "pixel_array", "compress": "cs_mac",
                       "adc": "adc_array"})
    meta = dict(pixels=H * W, reported_pj_per_pixel=51.0, approx=False,
                source="51-pJ/pixel (paper title) [54]")
    return hw, stages, mapping, meta


# ---------------------------------------------------------------------------
# 7. VLSI'21 [61]  Samsung — 65/28 nm stacked, 2 Mp global shutter DPS
#    (pixel-level ADC), in-pixel memory, 120 fps.  116.2 mW.
# ---------------------------------------------------------------------------
def vlsi21():
    H, W = 1232, 1632
    hw = HWConfig(name="vlsi21", frame_rate=120.0, stacked=True, num_layers=2,
                  process_nodes=[65, 28], pixel_pitch_um=2.2,
                  output_bits_per_element=10)
    hw.add_analog_array(AnalogArray(
        name="pixel_array", num_components=H * W,
        component=DigitalPixelSensor(pd_capacitance=3e-15, v_swing=0.7,
                                     adc_resolution=10,
                                     adc_energy_per_conversion=290e-12),
        num_input=(H, W), num_output=(H, W)))
    hw.add_memory(DoubleBuffer(name="frame_mem", capacity_bytes=6e6,
                               bits_per_access=128, process_node_nm=28,
                               layer=1, read_energy_per_access=12e-12,
                               write_energy_per_access=14e-12))
    hw.add_compute(ComputeUnit(name="readout", energy_per_cycle=18e-12,
                               input_pixels_per_cycle=(1, 64),
                               output_pixels_per_cycle=(1, 64),
                               num_stages=4, clock_mhz=600,
                               process_node_nm=28, layer=1),
                   input_memory="frame_mem", output_memory="frame_mem")

    px = _pixel_stage(H, W)
    ro = ProcessStage(name="readout_stage", input_size=(H, W),
                      kernel_size=(1, 1), stride=(1, 1), output_size=(H, W))
    ro.set_input_stage(px)
    stages = [px, ro]
    mapping = Mapping({"pixels": "pixel_array", "readout_stage": "readout"})
    meta = dict(pixels=H * W, reported_pj_per_pixel=484.0, approx=True,
                source="116.2 mW @ 2 Mp 120 fps [61]")
    return hw, stages, mapping, meta


# ---------------------------------------------------------------------------
# 8. ISSCC'22 [29]  Hsu et al. — 180 nm, 0.8 V PWM, mixed-mode PIP tiny CNN,
#    256 B digital buffer.
# ---------------------------------------------------------------------------
def isscc22():
    H, W = 120, 160
    hw = HWConfig(name="isscc22", frame_rate=30.0, process_nodes=[180],
                  pixel_pitch_um=7.0)
    hw.add_analog_array(AnalogArray(
        name="pixel_array", num_components=H * W,
        component=PulseWidthModulationPixel(pd_capacitance=12e-15,
                                            ramp_capacitance=20e-15,
                                            v_swing=0.8, vdda=0.8),
        num_input=(H, W), num_output=(H, W)))
    hw.add_analog_array(AnalogArray(
        name="mac_array", num_components=W,
        component=CurrentMirrorMAC(bias_current=8e-6, vdda=0.8, duty=0.5),
        num_input=(1, W), num_output=(1, W)))
    hw.add_analog_array(AnalogArray(
        name="adc_array", num_components=W // 4,
        component=AnalogToDigitalConverter(resolution_bits=8),
        num_input=(1, W // 4), num_output=(1, W // 4)))
    hw.add_memory(DoubleBuffer(name="buf", capacity_bytes=256,
                               bits_per_access=8, process_node_nm=180,
                               read_energy_per_access=0.2e-12,
                               write_energy_per_access=0.25e-12))
    hw.add_compute(ComputeUnit(name="fc", energy_per_cycle=6e-12,
                               input_pixels_per_cycle=(1, 1),
                               output_pixels_per_cycle=(1, 1), num_stages=2,
                               clock_mhz=20, process_node_nm=180),
                   input_memory="buf", output_memory="buf")

    px = _pixel_stage(H, W)
    conv = DNNProcessStage(name="tiny_cnn", op_type="conv2d",
                           input_size=(H, W, 1), kernel_size=(3, 3),
                           stride=(2, 2), output_size=(H // 2 - 1, W // 2 - 1, 4))
    conv.set_input_stage(px)
    adc = _adc_stage(H // 2 - 1, W // 2 - 1, conv)
    fc = DNNProcessStage(name="fc_stage", op_type="fc",
                         input_size=(1, 1, 64), output_size=(1, 1, 10))
    fc.set_input_stage(adc)
    stages = [px, conv, adc, fc]
    mapping = Mapping({"pixels": "pixel_array", "tiny_cnn": "mac_array",
                       "adc": "adc_array", "fc_stage": "fc"})
    meta = dict(pixels=H * W, reported_pj_per_pixel=230.0, approx=True,
                source="~133 uW mixed-mode PIP @30 fps [29]")
    return hw, stages, mapping, meta


# ---------------------------------------------------------------------------
# 9. TCAS-I'22 [70]  Xu et al. (Senputing) — 180 nm, 3T APS, pixel-level
#    current-domain Mul&Add, always-on BNN first layer.
# ---------------------------------------------------------------------------
def tcas22():
    H, W = 240, 320
    hw = HWConfig(name="tcas22", frame_rate=20.0, process_nodes=[180],
                  pixel_pitch_um=10.0, output_bits_per_element=1)
    hw.add_analog_array(AnalogArray(
        name="pixel_array", num_components=H * W,
        component=ActivePixelSensor(num_transistors=3, pd_capacitance=15e-15,
                                    sf_load_capacitance=40e-15, v_swing=0.5,
                                    vdda=1.8, correlated_double_sampling=False),
        num_input=(H, W), num_output=(H, W)))
    hw.add_analog_array(AnalogArray(
        name="mul_add", num_components=H * W,
        component=CurrentMirrorMAC(bias_current=0.52e-9, vdda=1.8, duty=0.3),
        num_input=(H, W), num_output=(1, 64)))
    hw.add_analog_array(AnalogArray(
        name="comp_array", num_components=64,
        component=Comparator(energy_per_conversion=0.4e-12),
        num_input=(1, 64), num_output=(1, 64)))

    px = _pixel_stage(H, W)
    bnn = DNNProcessStage(name="bnn1", op_type="fc", input_size=(1, 1, H * W),
                          output_size=(1, 1, 64))
    bnn.set_input_stage(px)
    comp = ProcessStage(name="digitize", input_size=(1, 64),
                        kernel_size=(1, 1), stride=(1, 1), output_size=(1, 64))
    comp.set_input_stage(bnn)
    stages = [px, bnn, comp]
    mapping = Mapping({"pixels": "pixel_array", "bnn1": "mul_add",
                       "digitize": "comp_array"})
    meta = dict(pixels=H * W, reported_pj_per_pixel=3.6, approx=True,
                source="5.5 uW sensing-with-computing @20 fps [70]")
    return hw, stages, mapping, meta


CHIP_REGISTRY: Dict[str, Callable] = {
    "isscc17": isscc17, "jssc19": jssc19, "sensors20": sensors20,
    "isscc21": isscc21, "jssc21_i": jssc21_i, "jssc21_ii": jssc21_ii,
    "vlsi21": vlsi21, "isscc22": isscc22, "tcas22": tcas22,
}


def chip_ids() -> List[str]:
    return list(CHIP_REGISTRY)


def build_chip(chip_id: str):
    return CHIP_REGISTRY[chip_id]()
