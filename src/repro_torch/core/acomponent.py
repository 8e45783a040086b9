# Verbatim copy of src/repro/core/acomponent.py (jax-free model layer).
"""A-Component library (Tbl. 1, analog column) with default implementations.

Each A-Component is a small bundle of A-Cells (Sec. 4.2 "Modeling
A-Components Access Energy").  The default cell-level implementations are
surveyed from classic CIS designs [30, 34, 54, 71, 72]; expert users can pass
custom cells via the ``cells`` argument or subclass.

Energy of one component *output* is Eq. 4; the component's per-frame access
count comes from the AFA it belongs to (Eq. 3, see afa.py).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from .acell import ACell, DynamicCell, NonLinearCell, StaticCell, component_energy
from .constants import DEFAULT_VDDA
from .domains import Domain


@dataclasses.dataclass
class AComponent:
    """Base analog functional component."""
    name: str = "acomponent"
    input_domain: Domain = Domain.VOLTAGE
    output_domain: Domain = Domain.VOLTAGE
    cells: Sequence[ACell] = dataclasses.field(default_factory=list)
    #: ops performed per access (e.g. a column MAC does 1 MAC per access).
    ops_per_access: float = 1.0

    def energy_per_access(self, delay: float) -> float:
        """Eq. 4 with even per-cell delay allocation (Eq. 11 fallback)."""
        return component_energy(self.cells, delay)


# ---------------------------------------------------------------------------
# Pixels
# ---------------------------------------------------------------------------
def ActivePixelSensor(name: str = "aps",
                      pd_capacitance: float = 5e-15,
                      fd_capacitance: float = 2e-15,
                      sf_load_capacitance: float = 50e-15,
                      v_swing: float = 1.0,
                      vdda: float = DEFAULT_VDDA,
                      num_transistors: int = 4,
                      correlated_double_sampling: bool = True,
                      num_readouts: int = 1,
                      cells: Optional[List[ACell]] = None) -> AComponent:
    """3T/4T active pixel: photodiode + floating diffusion + source follower.

    The SF is a static-biased cell that directly drives the column line
    (Eq. 8/9).  CDS reads the pixel twice (reset + signal), doubling the SF
    temporal count (the Eq. 13 example in the paper).
    """
    reads = num_readouts * (2 if correlated_double_sampling else 1)
    if cells is None:
        cells = [
            DynamicCell(name="photodiode", capacitance=pd_capacitance,
                        v_swing=v_swing),
            DynamicCell(name="floating_diffusion", capacitance=fd_capacitance,
                        v_swing=v_swing,
                        num_temporal=reads if num_transistors >= 4 else 1),
            StaticCell(name="source_follower", load_capacitance=sf_load_capacitance,
                       v_swing=v_swing, vdda=vdda, drives_load=True,
                       num_temporal=reads),
        ]
    return AComponent(name=name, input_domain=Domain.OPTICAL,
                      output_domain=Domain.VOLTAGE, cells=cells)


def DigitalPixelSensor(name: str = "dps",
                       pd_capacitance: float = 5e-15,
                       v_swing: float = 1.0,
                       vdda: float = DEFAULT_VDDA,
                       adc_resolution: int = 8,
                       adc_energy_per_conversion: Optional[float] = None) -> AComponent:
    """Per-pixel ADC pixel (DPS): photodiode + in-pixel ADC -> digital out."""
    cells = [
        DynamicCell(name="photodiode", capacitance=pd_capacitance, v_swing=v_swing),
        NonLinearCell(name="pixel_adc", resolution_bits=adc_resolution,
                      energy_per_conversion=adc_energy_per_conversion),
    ]
    return AComponent(name=name, input_domain=Domain.OPTICAL,
                      output_domain=Domain.DIGITAL, cells=cells)


def PulseWidthModulationPixel(name: str = "pwm",
                              pd_capacitance: float = 5e-15,
                              ramp_capacitance: float = 10e-15,
                              v_swing: float = 1.0,
                              vdda: float = DEFAULT_VDDA) -> AComponent:
    """PWM pixel: encodes intensity as pulse width (time domain) [30, 29]."""
    cells = [
        DynamicCell(name="photodiode", capacitance=pd_capacitance, v_swing=v_swing),
        DynamicCell(name="ramp", capacitance=ramp_capacitance, v_swing=v_swing),
        NonLinearCell(name="pwm_comparator", resolution_bits=1),
    ]
    return AComponent(name=name, input_domain=Domain.OPTICAL,
                      output_domain=Domain.TIME, cells=cells)


# ---------------------------------------------------------------------------
# Converters / compute
# ---------------------------------------------------------------------------
def AnalogToDigitalConverter(name: str = "adc", resolution_bits: int = 10,
                             energy_per_conversion: Optional[float] = None) -> AComponent:
    return AComponent(
        name=name, input_domain=Domain.VOLTAGE, output_domain=Domain.DIGITAL,
        cells=[NonLinearCell(name="adc", resolution_bits=resolution_bits,
                             energy_per_conversion=energy_per_conversion)])


def Comparator(name: str = "comparator",
               energy_per_conversion: Optional[float] = None) -> AComponent:
    """A comparator is a 1-bit ADC (Sec. 4.2)."""
    return AComponent(
        name=name, input_domain=Domain.VOLTAGE, output_domain=Domain.DIGITAL,
        cells=[NonLinearCell(name="comparator", resolution_bits=1,
                             energy_per_conversion=energy_per_conversion)])


def SwitchedCapacitorMAC(name: str = "sc_mac",
                         capacitance: Optional[float] = None,
                         num_capacitors: int = 8,
                         v_swing: float = 1.0,
                         vdda: float = DEFAULT_VDDA,
                         resolution_bits: int = 8,
                         use_opamp: bool = True,
                         opamp_gain: float = 2.0,
                         opamp_load: float = 100e-15) -> AComponent:
    """Charge-redistribution multiplier/MAC [42]: cap array (+ OpAmp).

    The capacitor array is dynamic (Eq. 5, C from the noise bound when not
    given); the active version adds a gm/Id-sized OpAmp (Eq. 10).
    """
    cells: List[ACell] = [
        DynamicCell(name="cap_array", capacitance=capacitance, v_swing=v_swing,
                    resolution_bits=resolution_bits, num_nodes=num_capacitors),
    ]
    if use_opamp:
        cells.append(StaticCell(name="opamp", load_capacitance=opamp_load,
                                v_swing=v_swing, vdda=vdda, drives_load=False,
                                gain=opamp_gain))
    return AComponent(name=name, input_domain=Domain.VOLTAGE,
                      output_domain=Domain.VOLTAGE, cells=cells)


def CurrentMirrorMAC(name: str = "cm_mac", bias_current: float = 1e-6,
                     vdda: float = DEFAULT_VDDA,
                     duty: float = 1.0) -> AComponent:
    """Current-domain MAC (PWM x current integration) [30, 29]."""
    cell = StaticCell(name="current_mirror", vdda=vdda, drives_load=False,
                      bias_current_override=bias_current,
                      t_static_fraction=duty)
    return AComponent(name=name, input_domain=Domain.TIME,
                      output_domain=Domain.CURRENT, cells=[cell])


def PassiveAverager(name: str = "binning", num_capacitors: int = 4,
                    capacitance: Optional[float] = None, v_swing: float = 1.0,
                    resolution_bits: int = 8) -> AComponent:
    """Passive switched-cap averaging (pixel binning, Fig. 5 example)."""
    return AComponent(
        name=name, input_domain=Domain.VOLTAGE, output_domain=Domain.VOLTAGE,
        cells=[DynamicCell(name="avg_caps", capacitance=capacitance,
                           v_swing=v_swing, resolution_bits=resolution_bits,
                           num_nodes=num_capacitors)])


def AnalogAdder(name: str = "adder", capacitance: Optional[float] = None,
                v_swing: float = 1.0, resolution_bits: int = 8) -> AComponent:
    return AComponent(
        name=name, input_domain=Domain.VOLTAGE, output_domain=Domain.VOLTAGE,
        cells=[DynamicCell(name="add_caps", capacitance=capacitance,
                           v_swing=v_swing, resolution_bits=resolution_bits,
                           num_nodes=2)])


def AnalogSubtractor(name: str = "subtractor", capacitance: Optional[float] = None,
                     v_swing: float = 1.0, resolution_bits: int = 8,
                     vdda: float = DEFAULT_VDDA, use_opamp: bool = True,
                     opamp_load: float = 100e-15) -> AComponent:
    """Switched-cap (absolute) subtractor — Ed-Gaze frame differencing."""
    cells: List[ACell] = [
        DynamicCell(name="sub_caps", capacitance=capacitance, v_swing=v_swing,
                    resolution_bits=resolution_bits, num_nodes=2)]
    if use_opamp:
        cells.append(StaticCell(name="opamp", load_capacitance=opamp_load,
                                v_swing=v_swing, vdda=vdda, drives_load=False))
    return AComponent(name=name, input_domain=Domain.VOLTAGE,
                      output_domain=Domain.VOLTAGE, cells=cells)


def AnalogMax(name: str = "max", num_inputs: int = 4,
              bias_current: float = 0.5e-6, vdda: float = DEFAULT_VDDA) -> AComponent:
    """Winner-take-all max circuit (static-biased)."""
    cell = StaticCell(name="wta", vdda=vdda,
                      bias_current_override=bias_current, drives_load=False)
    return AComponent(name=name, input_domain=Domain.VOLTAGE,
                      output_domain=Domain.VOLTAGE, cells=[cell])


def AnalogScaling(name: str = "scale", capacitance: Optional[float] = None,
                  v_swing: float = 1.0, resolution_bits: int = 8) -> AComponent:
    """Capacitor-ratio scaling (passive)."""
    return AComponent(
        name=name, input_domain=Domain.VOLTAGE, output_domain=Domain.VOLTAGE,
        cells=[DynamicCell(name="scale_caps", capacitance=capacitance,
                           v_swing=v_swing, resolution_bits=resolution_bits,
                           num_nodes=2)])


def AnalogLog(name: str = "log", bias_current: float = 0.2e-6,
              vdda: float = DEFAULT_VDDA) -> AComponent:
    """Sub-threshold logarithmic cell [72]."""
    cell = StaticCell(name="log_tx", vdda=vdda,
                      bias_current_override=bias_current, drives_load=False)
    return AComponent(name=name, input_domain=Domain.VOLTAGE,
                      output_domain=Domain.VOLTAGE, cells=[cell])


def AnalogAbs(name: str = "abs", capacitance: Optional[float] = None,
              v_swing: float = 1.0, resolution_bits: int = 8) -> AComponent:
    return AComponent(
        name=name, input_domain=Domain.VOLTAGE, output_domain=Domain.VOLTAGE,
        cells=[DynamicCell(name="abs_caps", capacitance=capacitance,
                           v_swing=v_swing, resolution_bits=resolution_bits,
                           num_nodes=2),
               NonLinearCell(name="sign_comparator", resolution_bits=1)])


# ---------------------------------------------------------------------------
# Analog memories (Tbl. 1 memory column)
# ---------------------------------------------------------------------------
def PassiveAnalogMemory(name: str = "passive_amem",
                        capacitance: Optional[float] = None,
                        v_swing: float = 1.0, resolution_bits: int = 8) -> AComponent:
    """Sample-and-hold capacitor (dynamic; C from the noise/precision bound)."""
    return AComponent(
        name=name, input_domain=Domain.VOLTAGE, output_domain=Domain.VOLTAGE,
        cells=[DynamicCell(name="sample_cap", capacitance=capacitance,
                           v_swing=v_swing, resolution_bits=resolution_bits)])


def ActiveAnalogMemory(name: str = "active_amem",
                       capacitance: Optional[float] = None,
                       v_swing: float = 1.0, vdda: float = DEFAULT_VDDA,
                       resolution_bits: int = 8,
                       opamp_load: float = 100e-15,
                       hold_fraction: float = 1.0) -> AComponent:
    """Actively buffered analog memory: S/H cap + hold OpAmp (Eq. 7/10)."""
    cells = [
        DynamicCell(name="sample_cap", capacitance=capacitance, v_swing=v_swing,
                    resolution_bits=resolution_bits),
        StaticCell(name="hold_opamp", load_capacitance=opamp_load,
                   v_swing=v_swing, vdda=vdda, drives_load=False,
                   t_static_fraction=hold_fraction),
    ]
    return AComponent(name=name, input_domain=Domain.VOLTAGE,
                      output_domain=Domain.VOLTAGE, cells=cells)
