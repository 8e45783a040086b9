"""Functional (numerical) simulation of declared sensor pipelines in torch.

The port of ``repro/functional``: CamJ's declarative stages describe
*what* a pipeline computes; this package executes it, so the declared
DAG can be checked for functional correctness and noise behaviour
(thermal kT/C noise per Eq. 6) before energy estimation.  The pipelines
run the port's hand-written kernels on CUDA tensors and their plain-torch
twins on CPU tensors.

:func:`params_from_reference` carries the reference's ``simple_dnn``
weights across: numpy arrays in, contiguous f32 tensors on the device
out.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..kernels.runtime import resolve_device
from .noise import thermal_noise_sigma_volts, with_thermal_noise
from .pipelines import (edgaze_frontend, fig5_pipeline,
                        rhythmic_pixel_frontend, simple_dnn)

__all__ = ["fig5_pipeline", "edgaze_frontend", "rhythmic_pixel_frontend",
           "simple_dnn", "with_thermal_noise", "thermal_noise_sigma_volts",
           "params_from_reference"]


def params_from_reference(w1, w2, device="cuda"
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``simple_dnn``'s ``(w1, w2)`` from arrays (numpy, or anything
    ``np.asarray`` takes) as contiguous f32 tensors on ``device``.

    Runs on the card unless the caller passes ``device="cpu"``; without a
    GPU the default raises.
    """
    dev = resolve_device(device)
    return tuple(torch.tensor(np.asarray(w, dtype=np.float32), device=dev)
                 for w in (w1, w2))
