"""DesignSpace of the port: the declarative description of one exploration.

Copy of the reference's ``repro/explore/space.py`` (``DesignSpace`` with
its eager validation and its ``encode`` / ``decode`` flat-index codec),
running on the port's own registries and grid layer.  The codec is the
variant-major layout every engine walks: variant slots are the major
digits, the C-order cartesian product of the numeric/tech axes the minor
digits, so ``decode(flat)`` reproduces the design point the fused engine
scored at stream index ``flat``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.algorithms import get_algorithm
from ..core.axes import AXES, AXES_SPEC, VARIANT_AXIS, Axis
from ..core.grid import (ChunkedGrid, _normalize_grids, lower_variant,
                         variant_grid)


def axis_names() -> Tuple[str, ...]:
    """All sweepable axis names: ``('variant',) +`` the numeric axes."""
    return (VARIANT_AXIS.name,) + AXES


def axis_specs() -> Tuple[Axis, ...]:
    """The declarative :class:`~repro_torch.core.axes.Axis` registry entries."""
    return (VARIANT_AXIS,) + AXES_SPEC


@dataclasses.dataclass
class DesignSpace:
    """A declarative exploration problem over registered algorithms.

    ``algorithms`` — one or more names registered via
    :func:`repro_torch.explore.register_algorithm`; ``grids`` maps axis names
    (``'variant'`` + :func:`axis_names`) to value lists (missing numeric
    axes default to what each variant's structure was built with; a
    missing ``variant`` axis sweeps every variant of each algorithm);
    ``soc_node`` is the host-layer node the structures are built against.

        space = DesignSpace(["edgaze", "rhythmic"],
                            {"cis_node": [130, 65, 28],
                             "frame_rate": [15, 30, 60],
                             "vdd_scale": [0.8, 1.0],
                             "adc_bits": [-1, 8, 12]})
        space.n_points, space.shape
        space.decode(12345)            # -> {"algorithm", "variant", axes...}
    """
    algorithms: Sequence[str]
    grids: Optional[Dict[str, Sequence]] = None
    soc_node: int = 22

    def __post_init__(self):
        if isinstance(self.algorithms, str):
            self.algorithms = (self.algorithms,)
        self.algorithms = tuple(str(a) for a in self.algorithms)
        if not self.algorithms:
            raise ValueError("DesignSpace needs at least one algorithm")
        if len(set(self.algorithms)) != len(self.algorithms):
            raise ValueError(
                f"duplicate algorithms in {list(self.algorithms)}: each "
                f"variant slot would be scored twice and the duplicate "
                f"summaries would collide")
        self.grids = dict(self.grids or {})
        labels: List[Tuple[str, str]] = []
        ngrids = None
        for algo in self.algorithms:
            spec = get_algorithm(algo)      # KeyError lists registered
            variants, ngrids = _normalize_grids(algo, self.grids)
            if not variants:
                raise ValueError(f"algorithm {algo!r} has an empty "
                                 f"variant list")
            unknown = [v for v in variants if v not in spec.variants]
            if unknown:
                raise KeyError(
                    f"unknown variants {unknown} for algorithm {algo!r}; "
                    f"valid: {list(spec.variants)}")
            if len(set(variants)) != len(variants):
                raise ValueError(f"duplicate variants for algorithm "
                                 f"{algo!r}: {variants}")
            labels += [(algo, v) for v in variants]
        for name, vals in self.grids.items():
            if np.size(vals) == 0:
                raise ValueError(f"axis {name!r} has an empty value list")
        # duplicate axis values would double-score points and break the
        # encode(**decode(flat)) == flat round-trip (first match wins)
        for name, vals in ngrids.items():
            arr = np.atleast_1d(np.asarray(vals, np.float64)).reshape(-1)
            if len(np.unique(arr)) != arr.size:
                raise ValueError(f"axis {name!r} has duplicate values: "
                                 f"{arr.tolist()}")
        self._labels = tuple(labels)
        # swept-axis lengths in canonical order (unswept axes are 1-long);
        # per-variant DEFAULT values differ, so full grids resolve lazily
        self._ngrids = ngrids
        self.shape = tuple(len(np.atleast_1d(np.asarray(ngrids[ax])))
                           if ax in ngrids else 1 for ax in AXES)

    # ----- sizes ----------------------------------------------------------
    @property
    def variant_labels(self) -> Tuple[Tuple[str, str], ...]:
        """Ordered ``(algorithm, variant)`` structural slots."""
        return self._labels

    @property
    def n_variants(self) -> int:
        return len(self._labels)

    @property
    def n_var(self) -> int:
        """Design points per structural variant (numeric grid size)."""
        return int(np.prod(self.shape)) if self.shape else 0

    @property
    def n_points(self) -> int:
        return self.n_variants * self.n_var

    def __len__(self) -> int:
        return self.n_points

    def label(self, slot: int) -> str:
        """Summary label of one variant slot (``algo/variant`` when the
        space spans several algorithms, bare ``variant`` otherwise)."""
        algo, variant = self._labels[slot]
        return variant if len(self.algorithms) == 1 else f"{algo}/{variant}"

    # ----- flat-index codec ----------------------------------------------
    def resolved_grid(self, slot: int) -> ChunkedGrid:
        """The slot's fully-resolved numeric grid (defaults filled from
        the variant's lowered plan; memoized)."""
        cache = self.__dict__.setdefault("_grid_cache", {})
        grid = cache.get(slot)
        if grid is None:
            algo, variant = self._labels[slot]
            plan = lower_variant(algo, variant, soc_node=self.soc_node)
            grid = cache[slot] = variant_grid(plan, self._ngrids)
        return grid

    def decode(self, flat: int) -> Dict:
        """The exact design point at variant-major stream index ``flat``."""
        if not 0 <= int(flat) < self.n_points:
            raise IndexError(f"flat index {flat} outside "
                             f"[0, {self.n_points})")
        slot, local = divmod(int(flat), self.n_var)
        algo, variant = self._labels[slot]
        return dict(algorithm=algo, variant=variant,
                    **self.resolved_grid(slot).point(local))

    def encode(self, algorithm: str, variant: str, **values) -> int:
        """Inverse of :meth:`decode`: the flat stream index of a point.

        ``values`` must name every axis of :data:`~repro_torch.core.axes.AXES`
        with a value present in the (resolved) grid; ``mem_tech`` accepts
        technology names or codes.
        """
        from ..core.axes import encode_axis_value
        try:
            slot = self._labels.index((algorithm, variant))
        except ValueError:
            raise KeyError(f"({algorithm!r}, {variant!r}) is not a "
                           f"variant slot of this space: "
                           f"{list(self._labels)}") from None
        grid = self.resolved_grid(slot)
        multi = []
        for ax, vals in zip(grid.names, grid.values):
            if ax not in values:
                raise KeyError(f"encode() missing axis {ax!r}")
            v = float(encode_axis_value(ax, values[ax]))
            hit = np.flatnonzero(vals == v)
            if not len(hit):        # f32 device round-trips land here
                hit = np.flatnonzero(np.isclose(vals, v, rtol=1e-6,
                                                atol=1e-12))
            if not len(hit):
                raise KeyError(f"value {values[ax]!r} not on axis "
                               f"{ax!r}: {vals.tolist()}")
            multi.append(int(hit[0]))
        local = int(np.ravel_multi_index(multi, grid.shape))
        return slot * self.n_var + local
