# Copy of src/repro/energy/roofline.py (jax-free), with an H100 HW and
# RooflineTerms.hw (see the docstring).
"""Three-term roofline model for TPU v5e (the CamJ never-stall budget,
applied to a training/serving step instead of a sensor frame).

    t_compute    = FLOPs_global    / (chips * 197e12)     [bf16 peak]
    t_memory     = HBM_bytes_global/ (chips * 819e9)
    t_collective = wire_bytes_global / (chips * 50e9)     [per-link ICI]

The dominant term is the stall-free lower bound on step time; the useful-
compute ratio MODEL_FLOPS / HLO_FLOPs catches remat/redundancy waste
(ratio < 1 when the compiled module does extra work; ~0.75 is the expected
value for full-remat training: 8 flops/param/token executed vs 6 counted).

Two changes from the reference.  ``H100`` holds an NVIDIA H100 SXM's
published rates and capacity; its per-access energies (``pj_*``) are the
reference's TPU v5e values, not fitted to that card (``chip_smoke.py``'s
``dryrun_path`` prints NVML's joules a step beside the model's).  With
``H100`` the ``ici_bw`` term is NVLink 4: a 16-wide ``model`` axis spans
two 8-GPU nodes, so the intra-node rate is a lower bound on that axis's
time, and the ``dcn`` terms stand for the inter-node network.  And
:class:`RooflineTerms` carries the ``hw`` it was built with:
``roofline_fraction`` divides by that ``hw.peak_flops``, where the
reference divides by ``V5E.peak_flops`` whatever ``hw`` was passed.
Under ``V5E`` every value equals the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class HW:
    """TPU v5e per-chip constants (targets; container runs on CPU)."""
    peak_flops: float = 197e12       # bf16
    hbm_bw: float = 819e9            # B/s
    ici_bw: float = 50e9             # B/s per link
    hbm_bytes: float = 16e9          # capacity
    # CamJ-for-TPU per-access energies (tpu_energy.py)
    pj_per_flop: float = 0.35
    pj_per_hbm_byte: float = 30.0
    pj_per_ici_byte: float = 10.0
    pj_per_dcn_byte: float = 100.0   # the "MIPI" of the hierarchy


V5E = HW()

H100 = HW(
    peak_flops=989e12,   # dense bf16 tensor-core rate, H100 SXM5 datasheet
    hbm_bw=3.35e12,      # HBM3, H100 SXM5 datasheet
    ici_bw=450e9,        # NVLink 4, 900 GB/s bidirectional: 450 a direction
    hbm_bytes=80e9,      # H100 SXM5 80 GB
)


@dataclasses.dataclass
class RooflineTerms:
    t_compute: float
    t_memory: float
    t_collective: float
    flops_global: float
    bytes_global: float
    coll_bytes_global: float
    model_flops: float
    chips: int
    hw: HW = V5E

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_compute_ratio(self) -> float:
        return self.model_flops / max(self.flops_global, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of peak the step achieves if it runs at the bound:
        MODEL_FLOPS / (bound_time * chips * peak) — i.e. model FLOPs
        delivered per second of wall-clock divided by peak."""
        return self.model_flops / (self.bound_time * self.chips
                                   * self.hw.peak_flops)

    def as_dict(self) -> Dict:
        return {
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
            "flops_global": self.flops_global,
            "bytes_global": self.bytes_global,
            "coll_bytes_global": self.coll_bytes_global,
            "model_flops": self.model_flops,
            "useful_compute_ratio": self.useful_compute_ratio,
            "roofline_fraction": self.roofline_fraction,
            "bound_time_s": self.bound_time, "chips": self.chips,
        }


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   coll_bytes_per_device: float, chips: int,
                   model_flops: float, hw: HW = V5E) -> RooflineTerms:
    return RooflineTerms(
        t_compute=flops_per_device / hw.peak_flops,
        t_memory=bytes_per_device / hw.hbm_bw,
        t_collective=coll_bytes_per_device / hw.ici_bw,
        flops_global=flops_per_device * chips,
        bytes_global=bytes_per_device * chips,
        coll_bytes_global=coll_bytes_per_device * chips,
        model_flops=model_flops, chips=chips, hw=hw)


def model_flops(cfg: ModelConfig, kind: str, batch: int, seq: int) -> float:
    """Analytic MODEL_FLOPS: 6*N*D (train) / 2*N*D (inference), N active.

    D = tokens processed by the step: batch*seq for train/prefill, batch
    for one decode step.  (The assignment's 6*N*D convention; attention
    O(S^2) flops are intentionally excluded so the ratio to HLO FLOPs
    exposes attention + remat overhead explicitly.)
    """
    n = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n * batch * seq
    if kind == "prefill":
        return 2.0 * n * batch * seq
    if kind == "decode":
        return 2.0 * n * batch
    raise ValueError(kind)
