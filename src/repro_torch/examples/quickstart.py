"""Quickstart: the paper's Fig. 5 example end-to-end (the port of
``examples/quickstart.py``).

Declares the 32x32 pixel array -> 2x2 binning -> ADC -> 3x3 edge-detection
CIS with the CamJ interface, runs the design checks + delay model + energy
estimation, AND executes the pipeline numerically (K5 ``binning`` and K6
``stencil_conv`` on the CUDA device; their plain-torch twins with
``--device cpu``) to show the declared DAG computes what it claims.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from ..core import (ActivePixelSensor, AnalogArray, AnalogToDigitalConverter,
                    ComputeUnit, HWConfig, LineBuffer, Mapping,
                    PassiveAverager, PixelInput, ProcessStage,
                    estimate_energy)
from ..functional import fig5_pipeline
from ..kernels.runtime import resolve_device


def build_fig5_system():
    # ---- software DAG (Fig. 5, camj_sw_config) -------------------------
    pixels = PixelInput(name="pixels", output_size=(32, 32))
    binning = ProcessStage(name="binning", input_size=(32, 32),
                           kernel_size=(2, 2), stride=(2, 2),
                           output_size=(16, 16))
    binning.set_input_stage(pixels)
    adc = ProcessStage(name="adc", input_size=(16, 16), kernel_size=(1, 1),
                       stride=(1, 1), output_size=(16, 16))
    adc.set_input_stage(binning)
    edge = ProcessStage(name="edge", input_size=(16, 16), kernel_size=(3, 3),
                        stride=(1, 1), output_size=(14, 14))
    edge.set_input_stage(adc)
    stages = [pixels, binning, adc, edge]

    # ---- hardware (camj_hw_config) --------------------------------------
    hw = HWConfig(name="fig5", frame_rate=30.0, process_nodes=[65],
                  pixel_pitch_um=5.0)
    pixel_array = AnalogArray(name="pixel_array", num_components=32 * 32,
                              component=ActivePixelSensor(),
                              num_input=(32, 32), num_output=(16, 16))
    pixel_array.add_component(PassiveAverager(num_capacitors=4))
    hw.add_analog_array(pixel_array)
    hw.add_analog_array(AnalogArray(
        name="adc_array", num_components=16,
        component=AnalogToDigitalConverter(resolution_bits=8),
        num_input=(1, 16), num_output=(1, 16)))
    hw.add_memory(LineBuffer(name="line_buf", capacity_bytes=3 * 16,
                             num_lines=3))
    hw.add_compute(ComputeUnit(name="edge_unit", energy_per_cycle=2e-12,
                               input_pixels_per_cycle=(3, 3),
                               output_pixels_per_cycle=(1, 1), num_stages=3,
                               clock_mhz=10.0),
                   input_memory="line_buf")

    # ---- mapping (camj_mapping) -----------------------------------------
    mapping = Mapping({"pixels": "pixel_array", "binning": "pixel_array",
                       "adc": "adc_array", "edge": "edge_unit"})
    return hw, stages, mapping


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", default="cuda",
                    help="where the functional pipeline runs (default "
                         "cuda; cpu runs the kernels' plain-torch twins)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    hw, stages, mapping = build_fig5_system()
    report = estimate_energy(hw, stages, mapping)
    print(report.pretty())
    print(f"energy/pixel: {report.energy_per_pixel(1024) * 1e12:.2f} pJ")

    # functional twin: the same pipeline on numbers
    rng = np.random.default_rng(0)
    frame = torch.from_numpy(
        rng.uniform(size=(32, 32)).astype(np.float32)).to(device)
    edges = fig5_pipeline(frame)
    print(f"functional sim: input {tuple(frame.shape)} -> edge map "
          f"{tuple(edges.shape)}, mean response {float(edges.mean()):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
