# Verbatim copy of src/repro/core/usecases/__init__.py (jax-free model layer).
"""Architectural-exploration use-cases (Sec. 6).

Three complementary studies:
  * in-vs-off sensor (Sec. 6.1, Fig. 9)  — Rhythmic Pixel Regions & Ed-Gaze
  * 2D vs 3D stacking + power density (Sec. 6.2, Tbl. 3)
  * analog vs digital processing (Sec. 6.3, Figs. 10-13) — Ed-Gaze mixed
"""
from .edgaze import EDGAZE_VARIANTS, build_edgaze
from .rhythmic import RHYTHMIC_VARIANTS, build_rhythmic
from .study import power_density, run_study

__all__ = ["build_edgaze", "build_rhythmic", "EDGAZE_VARIANTS",
           "RHYTHMIC_VARIANTS", "run_study", "power_density"]
