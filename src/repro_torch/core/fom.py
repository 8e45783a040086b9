# Verbatim copy of src/repro/core/fom.py (jax-free model layer).
"""Walden Figure-of-Merit survey for ADC energy estimation (Eq. 12, [53]).

The Murmann survey plots energy-per-conversion-step (the Walden FoM,
J/conv-step) against sampling rate.  CamJ uses the *median* FoM at the ADC's
sampling rate (the reciprocal of the A-Cell delay) when the user provides no
chip-specific conversion energy.

We encode the median curve as a log-log piecewise-linear table distilled from
the 1997-2022 survey: FoM is roughly flat (~15-40 fJ/step) through the
CIS-relevant 10 kS/s - 100 MS/s range and rises steeply beyond ~1 GS/s where
technology limits bite.
"""
from __future__ import annotations

import math

# (sampling_rate [S/s], median Walden FoM [J/conversion-step])
_MEDIAN_FOM_TABLE = [
    (1e3,  80e-15),
    (1e4,  45e-15),
    (1e5,  30e-15),
    (1e6,  22e-15),
    (1e7,  18e-15),
    (1e8,  25e-15),
    (1e9,  60e-15),
    (1e10, 300e-15),
]


def fom_table_points():
    """``(log10(rates), log10(foms))`` tuples for vectorized log-log interp.

    ``10 ** interp(log10(rate), *fom_table_points())`` reproduces
    :func:`walden_fom` exactly, including the endpoint clamping.
    """
    return (tuple(math.log10(f) for f, _ in _MEDIAN_FOM_TABLE),
            tuple(math.log10(e) for _, e in _MEDIAN_FOM_TABLE))


def walden_fom(sampling_rate: float) -> float:
    """Median Walden FoM (J/conversion-step) at a sampling rate, log-log interp."""
    pts = _MEDIAN_FOM_TABLE
    if sampling_rate <= pts[0][0]:
        return pts[0][1]
    if sampling_rate >= pts[-1][0]:
        return pts[-1][1]
    for (f0, e0), (f1, e1) in zip(pts, pts[1:]):
        if f0 <= sampling_rate <= f1:
            t = (math.log10(sampling_rate) - math.log10(f0)) / (
                math.log10(f1) - math.log10(f0))
            return 10 ** (math.log10(e0) * (1 - t) + math.log10(e1) * t)
    raise AssertionError("unreachable")


def adc_energy_per_conversion(sampling_rate: float, resolution_bits: int) -> float:
    """Energy of one full conversion: FoM * 2^ENOB (Walden definition)."""
    return walden_fom(sampling_rate) * (2.0 ** resolution_bits)
