# Verbatim copy of src/repro/core/algorithms.py (jax-free model layer).
"""Pluggable algorithm registry: builders become data, not imports.

Before ISSUE 5 the two paper use-cases were a hard-coded ``ALGORITHMS``
dict inside ``core/sweep.py``, so a new pipeline (e.g. the P2M
processing-in-pixel or conv-in-pixel directions from PAPERS.md) meant
editing the sweep engine itself.  The registry inverts that: every sweep
front door (``repro.explore.explore`` and the deprecated ``sweep`` /
``sweep_stream`` shims) resolves algorithm names here, and
:func:`register_algorithm` adds a pipeline at runtime — the PlanBank
already makes its lowered coefficients traced inputs, so a registered
algorithm rides the exact same compiled step executables as the built-ins
(asserted in tests/test_explore.py with the toy pipeline).

A builder has the use-case signature ``build(variant, *, cis_node,
soc_node) -> (hw, stages, mapping, meta)``; ``variants`` is the ordered
tuple of structural variant names it accepts.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Sequence, Tuple

from .usecases.edgaze import EDGAZE_VARIANTS, build_edgaze
from .usecases.rhythmic import RHYTHMIC_VARIANTS, build_rhythmic


class AlgorithmSpec(NamedTuple):
    """One registered pipeline: its builder and structural variants."""
    name: str
    builder: Callable
    variants: Tuple[str, ...]


_REGISTRY: Dict[str, AlgorithmSpec] = {}


def register_algorithm(name: str, builder: Callable,
                       variants: Sequence[str], *,
                       overwrite: bool = False) -> AlgorithmSpec:
    """Register a pipeline builder under ``name``.

    ``variants`` must be non-empty; duplicate names are rejected unless
    ``overwrite=True`` (re-registration is an explicit act, not a silent
    shadow).  Returns the stored :class:`AlgorithmSpec`.
    """
    if not variants:
        raise ValueError(f"algorithm {name!r} needs at least one variant")
    if name in _REGISTRY and not overwrite:
        raise ValueError(
            f"algorithm {name!r} is already registered; pass "
            f"overwrite=True to replace it (registered: "
            f"{sorted(_REGISTRY)})")
    spec = AlgorithmSpec(str(name), builder, tuple(str(v) for v in variants))
    _REGISTRY[spec.name] = spec
    return spec


def unregister_algorithm(name: str) -> None:
    """Remove a registered pipeline (KeyError if unknown)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown algorithm {name!r}; registered: "
                       f"{sorted(_REGISTRY)}")
    del _REGISTRY[name]


def get_algorithm(name: str) -> AlgorithmSpec:
    """Look up a registered pipeline; the error lists registered names."""
    spec = _REGISTRY.get(name)
    if spec is None:
        raise KeyError(f"unknown algorithm {name!r}; registered: "
                       f"{sorted(_REGISTRY)}")
    return spec


def algorithm_names() -> Tuple[str, ...]:
    """Registered algorithm names, registration order."""
    return tuple(_REGISTRY)


# the paper's two use-cases are ordinary registry entries, not special
# cases baked into the sweep engine
register_algorithm("edgaze", build_edgaze, EDGAZE_VARIANTS)
register_algorithm("rhythmic", build_rhythmic, RHYTHMIC_VARIANTS)
