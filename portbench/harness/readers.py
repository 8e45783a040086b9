"""What the per-layer readers share: the record of a traced run they
read, and the arithmetic of a share of a peak and of a class's device
time.  A reader returns ``None`` where its run has nothing to read, and
never 0 for a share of a roofline or of a peak."""
from __future__ import annotations

import dataclasses
import statistics
from typing import Callable, Dict, Optional, Tuple

from . import device
from .loop import Window


@dataclasses.dataclass
class Run:
    arch: Dict
    traffic: Dict
    window: Window
    device_kind: str

    @property
    def profile(self) -> Optional[Dict]:
        return self.window.profile


FlopsFn = Callable[[Dict, int, int], int]


def span_ms(run: Run, name: str) -> Optional[float]:
    """Mean CUDA-event ms of a span over the window's units."""
    ms = run.window.spans.get(name)
    return statistics.fmean(ms) if ms else None


def _work(run: Run, flops: FlopsFn) -> float:
    t = run.traffic
    return flops(run.arch, t["batch"], t["seq"]) * run.window.units


def mfu(run: Run, flops: FlopsFn) -> Optional[float]:
    """% of the bf16 peak: the operations the window's units need over
    the window's seconds."""
    peak = device.peaks(run.device_kind)
    if peak is None or run.window.units == 0:
        return None
    return 100.0 * _work(run, flops) / run.window.seconds \
        / peak["bf16_flops"]


def roofline(run: Run, flops: FlopsFn, classes: Tuple[str, ...]
             ) -> Optional[float]:
    """% of the bf16 peak that the classes' kernels reach on the
    operations the units need, over their summed profiled device
    time."""
    peak = device.peaks(run.device_kind)
    prof = run.profile
    if peak is None or prof is None:
        return None
    sec = sum(prof["by_class_s"].get(c, 0.0) for c in classes)
    if not sec:
        return None
    return 100.0 * _work(run, flops) / sec / peak["bf16_flops"]


def class_ms(run: Run, klass: str) -> Optional[float]:
    """Profiled device ms of a kernel class a unit (step or call)."""
    prof = run.profile
    if prof is None or run.window.units == 0 or \
            klass not in prof["by_class_s"]:
        return None
    return 1e3 * prof["by_class_s"][klass] / run.window.units


def idle(run: Run) -> Optional[float]:
    """% of the traced window in which no operation ran on the device."""
    prof = run.profile
    if prof is None:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
