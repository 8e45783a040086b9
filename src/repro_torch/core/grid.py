"""Grid layer of the port: lazy cartesian grids and variant lowering.

Torch-side counterpart of the reference's ``repro/core/sweep.py:58-228``
(``ChunkedGrid``, ``build_variant``, ``lower_variant``,
``_normalize_grids``, ``variant_grid``, ``axis_tables``), running on the
port's own copy of ``plan.lower``.  Everything here is host-side numpy:
the grids only ever reach the device as the ``(n_axes, V * Lmax)`` f32
axis table the fused megakernel decodes flat indices against.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .algorithms import get_algorithm
from .axes import AXES, _tech_code
from .batch import point_defaults
from .plan import EnergyPlan, _EXTRA_CACHES, count_cache_hit, lower

_REF_CIS_NODE = 65   # structures are built once here and re-scaled per point


def _algorithm(name: str):
    spec = get_algorithm(name)       # KeyError lists registered names
    return spec.builder, spec.variants


class ChunkedGrid:
    """Lazy cartesian product over named axis value lists.

    Equivalent to ``np.meshgrid(*values, indexing="ij")`` flattened in C
    order, but a point is materialized only on request from its flat
    index (``np.unravel_index``): host memory never grows with N.
    """

    def __init__(self, axes: Dict[str, Sequence]):
        self.names: List[str] = list(axes)
        self.values: List[np.ndarray] = [
            np.atleast_1d(np.asarray(v, np.float64)).reshape(-1)
            for v in axes.values()]
        self.shape: Tuple[int, ...] = tuple(len(v) for v in self.values)
        self.n_points: int = int(np.prod(self.shape)) if self.shape else 0

    def __len__(self) -> int:
        return self.n_points

    def point(self, i: int) -> Dict[str, float]:
        """Axis values of one flat grid index."""
        multi = np.unravel_index(int(i), self.shape)
        return {n: float(v[m])
                for n, v, m in zip(self.names, self.values, multi)}


def build_variant(algorithm: str, variant: str, *, cis_node: int = 65,
                  soc_node: int = 22):
    build, variants = _algorithm(algorithm)
    assert variant in variants, (algorithm, variant)
    return build(variant, cis_node=cis_node, soc_node=soc_node)


_VARIANT_CACHE: Dict[tuple, EnergyPlan] = {}
_EXTRA_CACHES.append(_VARIANT_CACHE)     # flushed by lower_cache_clear()


def lower_variant(algorithm: str, variant: str, *,
                  soc_node: int = 22) -> EnergyPlan:
    """Lower one structural variant (cached on ``(algorithm, variant,
    soc_node)``).

    The structure is built at the fixed reference CIS node and the node
    axes are swept numerically by the evaluator, so the cache hits for
    any grid.
    """
    key = (algorithm, variant, int(soc_node))
    plan = _VARIANT_CACHE.get(key)
    if plan is None:
        hw, stages, mapping, _meta = build_variant(
            algorithm, variant, cis_node=_REF_CIS_NODE, soc_node=soc_node)
        plan = _VARIANT_CACHE[key] = lower(hw, stages, mapping)
    else:
        count_cache_hit()
    return plan


def _normalize_grids(algorithm: str, grids: Optional[Dict[str, Sequence]]
                     ) -> Tuple[List[str], Dict[str, Sequence]]:
    """Split the variant axis off and map mem_tech names to codes."""
    grids = dict(grids or {})
    _build, all_variants = _algorithm(algorithm)
    variants = [str(v) for v in grids.pop("variant", all_variants)]
    unknown = set(grids) - set(AXES)
    if unknown:
        raise KeyError(f"unknown sweep axes {sorted(unknown)}; valid: "
                       f"['variant'] + {list(AXES)}")
    if "mem_tech" in grids:
        grids["mem_tech"] = [_tech_code(v) for v in grids["mem_tech"]]
    return variants, grids


def variant_grid(plan: EnergyPlan, grids: Dict[str, Sequence]) -> ChunkedGrid:
    """The :class:`ChunkedGrid` one variant sweeps (defaults fill gaps)."""
    defaults = point_defaults(plan)
    return ChunkedGrid({ax: grids.get(ax, [defaults[ax]]) for ax in AXES})


def axis_tables(grids: List[ChunkedGrid]) -> np.ndarray:
    """Stack per-variant axis values into a ``(V, n_axes, Lmax)`` f32 bank.

    Variants share the grid SHAPE (swept axes come from one ``grids``
    dict) but may differ in the single-value defaults filling unswept
    axes.  Padding entries are never indexed by the decoder.
    """
    assert grids and all(g.shape == grids[0].shape for g in grids), (
        [g.shape for g in grids])
    lmax = max(max(s, 1) for s in grids[0].shape)
    out = np.zeros((len(grids), len(grids[0].names), lmax), np.float32)
    for vi, g in enumerate(grids):
        for a, vals in enumerate(g.values):
            out[vi, a, : len(vals)] = vals.astype(np.float32)
    return out


def fused_table2(tables: np.ndarray) -> np.ndarray:
    """The megakernel's ``(n_axes, V * Lmax)`` f32 layout of the
    ``(V, n_axes, Lmax)`` axis tables (``table2[a, v * Lmax + i]``)."""
    return np.ascontiguousarray(
        np.transpose(tables, (1, 0, 2)).reshape(tables.shape[1], -1),
        np.float32)
