"""The check that the process judged holds none of the JAX reference:
no module whose top-level name (the part before the first dot) is, as a
whole word, one of ``FORBIDDEN``.  ``repro_torch`` is not ``repro``."""
from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded(names: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: the
    modules loaded in this process)."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))
