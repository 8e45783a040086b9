"""Grid engine of the port: parameter grids -> per-plan batches -> full
tables, plus the scalar ``estimate_energy`` oracle.

Torch counterpart of the reference's ``repro/core/sweep.py:101-147,
228-403``: :func:`_sweep_impl` walks each structural variant's
:class:`~repro_torch.core.grid.ChunkedGrid` in chunks on the host, scores
every chunk through the per-plan evaluator, split across the sweep's
mesh (:func:`repro_torch.core.shard_sweep.evaluate_batch_sharded`; a
one-entry mesh is :func:`repro_torch.core.batch.evaluate_batch`, whose
per-category sums ride the ``category_reduce`` kernel), and returns
the full O(N) :class:`SweepResult` tables.  ``explore(engine=
"monolithic" | "chunked")`` is its front door.

:func:`scalar_point` / :func:`scalar_sweep` evaluate single design points
through the scalar model the batched physics is lowered from.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..launch.mesh import resolve_mesh
from .axes import AXES, TECH_DECLARED, _tech_code
from .batch import grid_hooks_active, make_points
from .digital import SystolicArray
from .energy import CATEGORIES, estimate_energy, reference_outputs
from .grid import _normalize_grids, build_variant, lower_variant, variant_grid
from .plan import TECH_INDEX, EnergyPlan
from .shard_sweep import evaluate_batch_sharded


@dataclasses.dataclass
class SweepResult:
    """Full per-point tables of one algorithm's grid sweep."""
    algorithm: str
    params: Dict[str, np.ndarray]        # per-point axis values (+ variant)
    outputs: Dict[str, np.ndarray]       # per-point model outputs
    variant_meta: Dict[str, Dict]        # variant -> plan metadata
    wall_s: float = 0.0                  # total front-door wall time
    compile_s: float = 0.0               # building the plans' evaluators
    eval_s: float = 0.0                  # device evaluation + host copy

    def __len__(self) -> int:
        return len(self.outputs["total_j"])

    def select(self, **filters) -> np.ndarray:
        """Boolean mask of points matching the given param values.

        Numeric axes match with ``np.isclose`` (grid values round-trip
        through f32 on the device); ``variant`` and the categorical
        ``mem_tech`` codes stay exact.
        """
        mask = np.ones(len(self), bool)
        for k, v in filters.items():
            col = self.params[k]
            if k == "mem_tech":
                mask &= col == _tech_code(v)
            elif k == "variant" or not np.issubdtype(col.dtype, np.number):
                mask &= col == v
            else:
                mask &= np.isclose(col.astype(np.float64), float(v),
                                   rtol=1e-6, atol=1e-12)
        return mask

    def row(self, i: int) -> Dict:
        d = {k: v[i] for k, v in self.params.items()}
        d.update({k: v[i] for k, v in self.outputs.items()})
        return d

    def best(self, metric: str = "total_j", feasible_only: bool = True,
             k: int = 1) -> List[Dict]:
        """Top-k rows by ``metric`` (ascending); [] if none qualify."""
        vals = np.asarray(self.outputs[metric], np.float64).copy()
        if feasible_only:
            vals[~self.outputs["feasible"].astype(bool)] = np.inf
        idx = [int(i) for i in np.argsort(vals)[:k]
               if np.isfinite(vals[int(i)])]
        return [self.row(i) for i in idx]


def _variant_meta(plan: EnergyPlan) -> Dict:
    return dict(
        hw_name=plan.hw_name, notes=plan.notes,
        stall_notes=plan.stall_notes,
        categories_present=[CATEGORIES[c]
                            for c in sorted(set(plan.unit_category))],
        num_units=plan.num_units)


def _sweep_impl(algorithm: str = "edgaze",
                grids: Optional[Dict[str, Sequence]] = None, *,
                soc_node: int = 22, strict: bool = False,
                chunk_size: Optional[int] = None, mesh=None,
                device=None) -> SweepResult:
    """Grid engine: score the cartesian product of the parameter grids.

    ``grids`` maps axis names (``variant`` + :data:`AXES`) to value lists;
    missing axes default to the values each variant was built with.  One
    evaluator call (one ``category_reduce`` launch on the card) per
    structural variant per chunk; ``chunk_size=None`` scores each variant
    in one batch.  ``strict`` raises on pipeline stalls and on points
    that cannot meet the frame rate, like the scalar oracle.  Every
    chunk goes through
    :func:`~repro_torch.core.shard_sweep.evaluate_batch_sharded` on
    ``mesh`` (a 1-D ``("batch",)`` mesh,
    :func:`repro_torch.launch.mesh.make_batch_mesh`), split across its
    devices and padded internally to a divisible batch
    (``repro/core/sweep.py:293-313``); without one it runs on a
    one-entry mesh on ``device``, which is ``"cuda"`` unless the caller
    asks for ``"cpu"``: one evaluator call a chunk.
    """
    mesh = resolve_mesh(mesh, device)
    device = mesh.devices[0]
    t0 = time.perf_counter()
    variants, grids = _normalize_grids(algorithm, grids)
    # one sweep-level hook decision: a grid at the hook defaults never
    # runs the hook arithmetic
    hooks = grid_hooks_active(grids)

    params: Dict[str, List] = {k: [] for k in ("variant",) + AXES}
    outputs: Dict[str, List] = {}
    variant_meta: Dict[str, Dict] = {}
    timings = {"compile_s": 0.0, "eval_s": 0.0}

    for variant in variants:
        plan = lower_variant(algorithm, variant, soc_node=soc_node)
        if strict and plan.stall_notes:
            raise ValueError("pipeline stalls detected: "
                             + "; ".join(plan.stall_notes))
        grid = variant_grid(plan, grids)
        for _start, flat in grid.chunks(chunk_size):
            n = len(flat[AXES[0]])
            points = make_points(plan, n, device=device, **flat)
            out = evaluate_batch_sharded(plan, points, mesh=mesh,
                                         timings=timings, hooks=hooks)
            if strict and not bool(out["feasible"].all()):
                bad = int((~out["feasible"].astype(bool)).sum())
                raise ValueError(
                    f"{variant}: {bad}/{n} design points cannot meet the "
                    f"frame rate (T_D >= T_FR, Sec. 4.1)")
            params["variant"].append(np.full(n, variant, object))
            for ax in AXES:
                params[ax].append(flat[ax])
            for k, v in out.items():
                outputs.setdefault(k, []).append(v)
        variant_meta[variant] = _variant_meta(plan)

    return SweepResult(
        algorithm=algorithm,
        params={k: np.concatenate(v) if k != "variant"
                else np.concatenate(v).astype(str)
                for k, v in params.items()},
        outputs={k: np.concatenate(v) for k, v in outputs.items()},
        variant_meta=variant_meta,
        wall_s=time.perf_counter() - t0,
        compile_s=timings["compile_s"], eval_s=timings["eval_s"])


# ---------------------------------------------------------------------------
# Scalar reference oracle (one design point at a time)
# ---------------------------------------------------------------------------
def scalar_point(algorithm: str, variant: str, *,
                 cis_node: float = 65, soc_node: float = 22,
                 mem_tech=None, sys_rows: Optional[float] = None,
                 sys_cols: Optional[float] = None,
                 frame_rate: Optional[float] = None,
                 active_fraction_scale: float = 1.0,
                 pixel_pitch_um: Optional[float] = None,
                 vdd_scale: float = 1.0,
                 adc_bits: float = -1.0) -> Dict[str, float]:
    """Evaluate ONE design point through the scalar ``estimate_energy``.

    Rebuilds the variant at the requested node and patches the remaining
    swept knobs onto the ``HWConfig``; returns the batched output schema.
    The scalar walk prices the declared structure, so the coefficient-
    hook axes (``vdd_scale`` / ``adc_bits``) are only accepted at their
    defaults.
    """
    off_default = []
    if vdd_scale != 1.0:
        off_default.append(f"vdd_scale={vdd_scale!r}")
    if adc_bits is not None and adc_bits >= 0:
        off_default.append(f"adc_bits={adc_bits!r}")
    if off_default:
        raise NotImplementedError(
            "the scalar oracle does not model the coefficient-hook "
            f"axes ({', '.join(off_default)} off default); validate "
            "those axes against explore(..., engine='staged')")
    hw, stages, mapping, _meta = build_variant(
        algorithm, variant, cis_node=int(cis_node), soc_node=int(soc_node))
    if frame_rate is not None:
        hw.frame_rate = float(frame_rate)
    if pixel_pitch_um is not None:
        hw.pixel_pitch_um = float(pixel_pitch_um)
    for binding in hw.digital.values():
        if isinstance(binding.unit, SystolicArray):
            if sys_rows is not None:
                binding.unit.rows = int(sys_rows)
            if sys_cols is not None:
                binding.unit.cols = int(sys_cols)
    tech = _tech_code(mem_tech)
    for mem in hw.memories.values():
        if tech != TECH_DECLARED:
            mem.technology = {v: k for k, v in TECH_INDEX.items()}[tech]
        mem.active_fraction *= active_fraction_scale
    report = estimate_energy(hw, stages, mapping, strict=False)
    return reference_outputs(report, hw)


def scalar_sweep(algorithm: str, result_params: Dict[str, np.ndarray],
                 indices: Sequence[int]) -> List[Dict[str, float]]:
    """Run the scalar oracle over selected points of a sweep's param
    table."""
    rows = []
    for i in indices:
        kwargs = {ax: float(result_params[ax][i]) for ax in AXES}
        kwargs["mem_tech"] = int(result_params["mem_tech"][i])
        rows.append(scalar_point(algorithm,
                                 str(result_params["variant"][i]), **kwargs))
    return rows


def sweep(*_args, **_kwargs):
    """The reference's deprecated ``sweep()`` shim, left out of the port
    on purpose: raises ``NotImplementedError``."""
    raise NotImplementedError(
        "repro_torch does not port the reference's deprecated sweep() shim "
        "(ROADMAP Queue 1, differences kept on purpose); call "
        "repro_torch.explore.explore(DesignSpace(...), engine='monolithic' "
        "or 'chunked') instead")
