# Verbatim copy of src/repro/core/chips/__init__.py (jax-free model layer).
"""Nine validation chips (Tbl. 2 / Fig. 7).

Each builder returns (hw, stages, mapping, meta).  ``meta['reported_pj_per_pixel']``
is the measured per-pixel energy we validate against.  Provenance: the CamJ
paper reports these only graphically (Fig. 7, log scale); our reference
values are digitized from the original chip papers' headline numbers
(e.g. JSSC'21-II is literally "51-pJ/pixel" in its title) and are marked
``approx=True`` where digitization was required.  Where the original paper
reports circuit parameters (capacitances, ADC energy, per-MAC energy) we use
them, mirroring the paper's own validation methodology (Sec. 5).
"""
from .registry import CHIP_REGISTRY, build_chip, chip_ids
from .validation import validate_all, mape, pearson

__all__ = ["CHIP_REGISTRY", "build_chip", "chip_ids", "validate_all",
           "mape", "pearson"]
