# Verbatim copy of src/repro/core/domains.py (jax-free model layer).
"""Signal domains for analog functional arrays (Sec. 3.3).

CamJ uses input/output domain declarations to run pre-simulation design
checks: a consumer's input domain must match its producer's output domain,
otherwise a conversion component (with energy implications) is required.
"""
import enum


class Domain(enum.Enum):
    OPTICAL = "optical"    # photons, before the photodiode
    CHARGE = "charge"
    VOLTAGE = "voltage"
    CURRENT = "current"
    TIME = "time"          # pulse-width-modulated signals
    DIGITAL = "digital"

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


#: Conversions that happen "for free" because the consuming circuit's input
#: device performs them inherently (e.g. a source follower converts charge on
#: the floating diffusion to a voltage; a capacitor integrates current).
IMPLICIT_CONVERSIONS = {
    (Domain.OPTICAL, Domain.CHARGE),    # photodiode
    (Domain.CHARGE, Domain.VOLTAGE),    # floating diffusion + SF
    (Domain.CURRENT, Domain.VOLTAGE),   # resistive/capacitive load
    (Domain.VOLTAGE, Domain.TIME),      # PWM ramp comparator
}


def compatible(producer: Domain, consumer: Domain) -> bool:
    """True if ``producer`` output can directly feed ``consumer`` input."""
    if producer == consumer:
        return True
    return (producer, consumer) in IMPLICIT_CONVERSIONS
