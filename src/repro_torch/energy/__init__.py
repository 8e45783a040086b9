"""Roofline + CamJ-style energy bridge of the port (torch counterpart of
``src/repro/energy/``): the reference's roofline, energy report and HLO
collective accounting, the ``H100`` constants, and the counts of a traced
torch step (:mod:`.trace`, :mod:`.collectives`) in place of XLA's."""
from .collectives import CollectiveCounter
from .hlo import collective_bytes, parse_collectives
from .roofline import (H100, HW, V5E, RooflineTerms, model_flops,
                       roofline_terms)
from .tpu_energy import tpu_energy_report
from .trace import StepTrace, trace_step

__all__ = ["parse_collectives", "collective_bytes", "roofline_terms",
           "RooflineTerms", "model_flops", "HW", "V5E", "H100",
           "tpu_energy_report", "CollectiveCounter", "StepTrace",
           "trace_step"]
