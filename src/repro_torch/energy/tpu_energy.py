# Copy of src/repro/energy/tpu_energy.py (jax-free); the code is verbatim,
# the docstring adds the H100 mapping.
"""CamJ-for-TPU: the paper's component-level energy methodology applied to
the compiled training/serving step.

CamJ's Eq. 2/14/17 — energy = sum over components of (access count x
per-access energy) — maps directly:

    CIS component          TPU component       access count source
    ------------------     ----------------    --------------------------
    PE / systolic array    MXU                 HLO FLOPs (cost_analysis)
    line buffer / SRAM     HBM<->VMEM traffic  HLO bytes accessed
    uTSV (1 pJ/B)          ICI (intra-pod)     parsed collective bytes
    MIPI (100 pJ/B)        DCN (cross-pod)     'pod'-axis collective bytes

Like CamJ, the per-access energies are technology constants supplied to the
model (HW dataclass), and the framework contributes the *counts* from the
declarative description — here, the lowered XLA module instead of the
stencil DAG.  The in-vs-off-sensor finding has the same shape at this
level: keeping traffic on ICI vs DCN is the in-sensor-vs-MIPI decision.

With ``hw=H100`` (``roofline.H100``) the keys keep their names and map
onto the card: ``e_mxu_j`` is the tensor cores' energy, ``e_hbm_j`` HBM3's,
``e_ici_j`` NVLink's, and ``e_dcn_j`` the inter-node network's.  The
per-access energies stay the reference's v5e values.
"""
from __future__ import annotations

from typing import Dict

from .roofline import HW, V5E


def tpu_energy_report(flops_per_device: float, bytes_per_device: float,
                      ici_bytes_per_device: float, chips: int,
                      dcn_bytes_per_device: float = 0.0,
                      hw: HW = V5E) -> Dict[str, float]:
    """Per-step energy breakdown (Joules, whole system)."""
    e_mxu = flops_per_device * chips * hw.pj_per_flop * 1e-12
    e_hbm = bytes_per_device * chips * hw.pj_per_hbm_byte * 1e-12
    e_ici = ici_bytes_per_device * chips * hw.pj_per_ici_byte * 1e-12
    e_dcn = dcn_bytes_per_device * chips * hw.pj_per_dcn_byte * 1e-12
    total = e_mxu + e_hbm + e_ici + e_dcn
    return {
        "e_mxu_j": e_mxu, "e_hbm_j": e_hbm, "e_ici_j": e_ici,
        "e_dcn_j": e_dcn, "e_total_j": total,
        "dominant": max({"MXU": e_mxu, "HBM": e_hbm, "ICI": e_ici,
                         "DCN": e_dcn}.items(), key=lambda kv: kv[1])[0],
    }
