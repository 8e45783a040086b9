# Verbatim copy of src/repro/core/afa.py (jax-free model layer).
"""Analog Functional Arrays (Sec. 3.3).

An AFA is an array of identical A-Components (a pixel array, a column-ADC
bank, a column-parallel MAC array, an analog frame buffer...).  The access
count of each component is Eq. 3:

    Num_access(component) = Num_ops(AFA) / Num_components(AFA)

where Num_ops comes from the software stage(s) mapped onto the AFA.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from .acomponent import AComponent
from .domains import Domain


@dataclasses.dataclass
class AnalogArray:
    name: str
    num_components: int
    component: AComponent = None  # type: ignore[assignment]
    #: (height, width[, channels]) of the input/output signal tile.
    num_input: Tuple[int, ...] = (1, 1)
    num_output: Tuple[int, ...] = (1, 1)
    input_domain: Optional[Domain] = None
    output_domain: Optional[Domain] = None
    #: layer index for stacked designs (0 = pixel layer).
    layer: int = 0
    #: extra components chained inside the array (e.g. column amp before ADC).
    extra_components: List[AComponent] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.component is None:
            raise ValueError(f"AnalogArray {self.name!r} needs a component")
        if self.input_domain is None:
            self.input_domain = self.component.input_domain
        if self.output_domain is None:
            out = (self.extra_components[-1] if self.extra_components
                   else self.component)
            self.output_domain = out.output_domain

    # -- Eq. 3 -----------------------------------------------------------
    def accesses_per_component(self, num_ops: float) -> float:
        if self.num_components <= 0:
            raise ValueError(f"{self.name}: num_components must be positive")
        return num_ops / self.num_components

    def energy_per_frame(self, num_ops: float, stage_delay: float) -> float:
        """Eq. 2 restricted to this AFA: per-access energy x access count.

        ``stage_delay`` is the analog stage budget T_A inferred by the delay
        model (Sec. 4.1).  Every component in the array serially performs
        ``accesses_per_component`` operations within T_A, so the *per-access*
        delay — which sizes bias currents (Eq. 8/10) and ADC sampling rates
        (Eq. 12) — is T_A divided by the per-component access count.
        """
        n_access = self.accesses_per_component(num_ops)
        per_access_delay = stage_delay / max(n_access, 1.0)
        e_access = self.component.energy_per_access(per_access_delay)
        for extra in self.extra_components:
            e_access += extra.energy_per_access(per_access_delay)
        return e_access * n_access * self.num_components

    def add_component(self, component: AComponent) -> "AnalogArray":
        """Chain another A-Component stage inside this array (Fig. 5 API)."""
        self.extra_components.append(component)
        self.output_domain = component.output_domain
        return self
