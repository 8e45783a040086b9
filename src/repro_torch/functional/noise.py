# Verbatim copy of src/repro/functional/noise.py's thermal_noise_sigma_volts.
"""Thermal-noise injection for the functional simulator (Eq. 6).

An analog stage realized with capacitance C carries kT/C sampling noise;
the functional simulator can inject it to study precision/energy trade-offs
(smaller C = cheaper dynamic energy = more noise).
"""
from __future__ import annotations

import torch

from ..core.constants import BOLTZMANN, ROOM_TEMPERATURE


def thermal_noise_sigma_volts(capacitance: float,
                              temperature: float = ROOM_TEMPERATURE) -> float:
    """sigma = sqrt(kT/C) in volts."""
    return float((BOLTZMANN * temperature / capacitance) ** 0.5)


def with_thermal_noise(generator: torch.Generator, signal: torch.Tensor,
                       capacitance: float,
                       v_swing: float = 1.0) -> torch.Tensor:
    """Add kT/C noise to a normalized [0,1] signal sampled on ``capacitance``.

    The noise is ``torch.randn`` drawn from ``generator`` (the reference
    takes a ``jax.random`` key), on the signal's device and in its dtype;
    the generator lives on that device.  One seed gives the same noise on
    every call; the bits differ from jax's, the distribution does not.
    """
    sigma = thermal_noise_sigma_volts(capacitance) / v_swing
    return signal + sigma * torch.randn(signal.shape, generator=generator,
                                        device=signal.device,
                                        dtype=signal.dtype)
