# Verbatim copy of src/repro/core/acell.py (jax-free model layer).
"""A-Cell energy models (Sec. 4.2, Eqs. 5-13).

Every analog component (A-Component) is built from A-Cells.  CamJ groups
A-Cells into three classes with distinct energy mechanisms:

  1. Dynamic cells           E = sum_i C_i * Vswing_i^2                 (Eq. 5)
  2. Static-biased cells     E = V_DDA * I_bias * t_static              (Eq. 7)
  3. Non-linear cells (ADC)  E = FoM * 2^bits * Num_conversions         (Eq. 12)

The functions are written with plain arithmetic so they broadcast over
``jax.numpy`` arrays — design-space sweeps vmap/vectorize directly over
capacitances, voltages, resolutions and delays.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from .constants import (BOLTZMANN, DEFAULT_VDDA, GM_ID_DEFAULT,
                        ROOM_TEMPERATURE)
from .fom import adc_energy_per_conversion


def thermal_noise_capacitance(v_swing: float, resolution_bits: int,
                              temperature: float = ROOM_TEMPERATURE) -> float:
    """Minimum capacitance meeting the thermal-noise bound of Eq. 6.

    The kT/C noise sigma must satisfy 3*sigma < LSB/2 with
    LSB = v_swing / 2**resolution_bits, i.e.::

        sqrt(kT/C) < LSB/6   =>   C > 36 * kT / LSB^2

    Note: the worked example in the paper (Sec. 4.2) quotes 2.6 mV for
    V=1 V/8-bit where the formula as printed gives 0.65 mV; we implement the
    formula (3*sigma < LSB/2) literally.
    """
    lsb = v_swing / (2.0 ** resolution_bits)
    return 36.0 * BOLTZMANN * temperature / (lsb * lsb)


# ---------------------------------------------------------------------------
# Cell dataclasses
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ACell:
    """Base class: a named analog cell with spatial/temporal access counts.

    ``num_spatial`` and ``num_temporal`` implement Eq. 13:
    Num_access(cell) = Num_spatial * Num_temporal per A-Component output.
    """
    name: str = "acell"
    num_spatial: int = 1
    num_temporal: int = 1

    @property
    def accesses_per_output(self) -> int:
        return self.num_spatial * self.num_temporal

    def energy(self, delay: float) -> float:  # pragma: no cover - abstract
        raise NotImplementedError

    def energy_per_output(self, delay: float) -> float:
        return self.energy(delay) * self.accesses_per_output


@dataclasses.dataclass
class DynamicCell(ACell):
    """Dynamic A-Cell: charging/discharging node capacitances (Eq. 5).

    If ``capacitance`` is None it is derived from the thermal-noise bound
    (Eq. 6) using ``resolution_bits``.  ``num_nodes`` models N_c identical
    capacitance nodes (a CDAC, a S/H bank, ...).
    """
    capacitance: Optional[float] = None   # F per node
    v_swing: float = 1.0                  # V
    resolution_bits: int = 8
    num_nodes: int = 1

    def node_capacitance(self) -> float:
        if self.capacitance is not None:
            return self.capacitance
        return thermal_noise_capacitance(self.v_swing, self.resolution_bits)

    def energy(self, delay: float) -> float:
        c = self.node_capacitance()
        return self.num_nodes * c * self.v_swing ** 2


@dataclasses.dataclass
class StaticCell(ACell):
    """Static-biased A-Cell (Eqs. 7-11).

    Two bias-current estimates:
      * ``drives_load=True``  : I = C_load*Vswing/t  =>  E = C*Vswing*V_DDA (Eq. 9)
      * ``drives_load=False`` : gm/Id method, I = 2*pi*C_load*GBW/(gm/Id) (Eq. 10)
        with GBW = gain * BW and BW = 1/delay (Sec. 4.2).

    ``t_static_fraction`` lets an A-Component mark a cell as biased for only a
    fraction of the component delay (Eq. 11 with explicit user timing); the
    default 1.0 matches CamJ's even-allocation fallback, where ``delay`` passed
    in is already the per-cell slice of the component delay.
    """
    load_capacitance: float = 10e-15     # F
    v_swing: float = 1.0
    vdda: float = DEFAULT_VDDA
    drives_load: bool = True
    gain: float = 1.0
    gm_id: float = GM_ID_DEFAULT
    t_static_fraction: float = 1.0
    bias_current_override: Optional[float] = None

    def bias_current(self, delay: float) -> float:
        t = max(delay, 1e-12) * self.t_static_fraction
        if self.bias_current_override is not None:
            return self.bias_current_override
        if self.drives_load:
            return self.load_capacitance * self.v_swing / t          # Eq. 8
        bandwidth = 1.0 / t
        gbw = self.gain * bandwidth
        return 2.0 * math.pi * self.load_capacitance * gbw / self.gm_id  # Eq. 10

    def energy(self, delay: float) -> float:
        t = max(delay, 1e-12) * self.t_static_fraction
        if self.bias_current_override is None and self.drives_load:
            # Eq. 9: delay cancels.
            return self.load_capacitance * self.v_swing * self.vdda
        return self.vdda * self.bias_current(delay) * t               # Eq. 7


@dataclasses.dataclass
class NonLinearCell(ACell):
    """Non-linear A-Cell: ADCs / comparators (Eq. 12).

    Energy per conversion comes from the Walden FoM survey [53] at the
    sampling rate implied by the cell delay, unless the user supplies
    ``energy_per_conversion`` (expert interface).
    """
    resolution_bits: int = 8
    energy_per_conversion: Optional[float] = None

    def energy(self, delay: float) -> float:
        if self.energy_per_conversion is not None:
            return self.energy_per_conversion
        sampling_rate = 1.0 / max(delay, 1e-12)
        return adc_energy_per_conversion(sampling_rate, self.resolution_bits)


def component_energy(cells: Sequence[ACell], component_delay: float) -> float:
    """Eq. 4: weighted sum of cell energies for one A-Component output.

    Absent user timing, the component delay is evenly allocated across cells
    on the (uni-directional) critical path — Eq. 11's fallback.
    """
    if not cells:
        return 0.0
    per_cell_delay = component_delay / len(cells)
    return float(sum(c.energy_per_output(per_cell_delay) for c in cells))
