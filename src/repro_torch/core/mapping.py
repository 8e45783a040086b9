# Verbatim copy of src/repro/core/mapping.py (jax-free model layer).
"""Algorithm -> hardware mapping (Sec. 3.3 ``camj_mapping``).

The mapping is a plain dict from software stage name to a hardware unit name
(an analog array or a digital compute unit).  Decoupling the mapping from
both descriptions is what makes iterating on in-vs-off-sensor or
analog-vs-digital splits a one-line change.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .hw import HWConfig
from .sw import Stage


@dataclasses.dataclass
class Mapping:
    stage_to_unit: Dict[str, str]
    #: stages executed *off* the sensor (on the host SoC); their compute /
    #: memory energy is modeled with the SoC process node and their input
    #: crosses MIPI.
    off_sensor_stages: List[str] = dataclasses.field(default_factory=list)

    def unit_for(self, stage: Stage) -> str:
        try:
            return self.stage_to_unit[stage.name]
        except KeyError:
            raise KeyError(f"stage {stage.name!r} is not mapped to any "
                           f"hardware unit") from None

    def is_off_sensor(self, stage: Stage) -> bool:
        return stage.name in self.off_sensor_stages

    def validate(self, hw: HWConfig, stages: List[Stage]) -> None:
        analog_names = {a.name for a in hw.analog_arrays}
        digital_names = set(hw.digital)
        for s in stages:
            unit = self.unit_for(s)
            if unit not in analog_names and unit not in digital_names:
                raise KeyError(
                    f"stage {s.name!r} mapped to unknown unit {unit!r}; "
                    f"known analog={sorted(analog_names)}, "
                    f"digital={sorted(digital_names)}")
