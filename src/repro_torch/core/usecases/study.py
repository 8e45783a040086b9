# Verbatim copy of src/repro/core/usecases/study.py (jax-free model layer).
"""Run the Sec. 6 studies: energy tables (Fig. 9/11) + power density (Tbl. 3).

``run_study`` rides the batched energy engine through the declarative
``repro.explore`` front door: each structural variant is lowered once
(``repro.core.plan``) and all requested CIS nodes are scored in a single
compiled device call (``repro.core.batch``) — pass ``chunk_size=`` /
``mesh=`` through to shard the evaluation across devices exactly like
any other exploration.  The scalar walk survives as ``engine="scalar"``
— it is the reference oracle the parity tests hold the batched path
against.
"""
from __future__ import annotations

from typing import Dict, List

from ..energy import estimate_energy


def power_density(hw, report) -> Dict[str, float]:
    """Conservative power-density upper bound (Sec. 6.2).

    Analog area ~ pixel array; digital area ~ SRAM macros.  For 2D designs
    the footprint is the sum; for stacked designs it is the max layer.
    On-sensor power only (the SoC in 2d_off doesn't heat the sensor die).
    """
    power = report.on_sensor_power(hw.frame_rate)
    area = hw.total_area_mm2()
    return dict(power_mw=power * 1e3, area_mm2=area,
                density_mw_mm2=power * 1e3 / max(area, 1e-9))


def _variants(algorithm: str):
    from ..algorithms import get_algorithm
    return get_algorithm(algorithm).variants


def run_study(algorithm: str, cis_nodes=(130, 65), soc_node: int = 22,
              strict: bool = False, engine: str = "batched",
              chunk_size=None, mesh=None) -> List[Dict]:
    """Evaluate every variant x CIS node for one algorithm.

    Returns rows with total energy, category breakdown and power density.
    ``engine="batched"`` (default) scores all cells in one device call per
    variant; ``engine="scalar"`` walks the Python stage objects per cell.
    ``chunk_size``/``mesh`` pass through to ``sweep()`` for chunked /
    device-sharded evaluation (irrelevant at study sizes, but the study
    rides the same code path the mega-sweeps exercise).
    """
    if engine == "scalar":
        return _run_study_scalar(algorithm, cis_nodes, soc_node, strict)

    # local import: the explore layer builds on the use-cases
    from ...explore import DesignSpace, explore
    space = DesignSpace([algorithm],
                        {"variant": list(_variants(algorithm)),
                         "cis_node": list(cis_nodes)},
                        soc_node=soc_node)
    res = explore(space, engine=("chunked" if chunk_size else "monolithic"),
                  chunk_size=chunk_size, mesh=mesh,
                  strict=strict).sweep_results[algorithm]
    rows = []
    for node in cis_nodes:
        for variant in _variants(algorithm):
            mask = res.select(variant=variant, cis_node=float(node))
            (i,) = mask.nonzero()[0][:1]
            r = res.row(int(i))
            present = res.variant_meta[variant]["categories_present"]
            rows.append(dict(
                algorithm=algorithm, variant=variant, cis_node=node,
                total_uj=float(r["total_j"]) * 1e6,
                on_sensor_uj=float(r["on_sensor_j"]) * 1e6,
                breakdown_uj={c: float(r[f"cat_{c}_j"]) * 1e6
                              for c in present},
                power_mw=float(r["power_mw"]),
                area_mm2=float(r["area_mm2"]),
                density_mw_mm2=float(r["density_mw_mm2"])))
    return rows


def _run_study_scalar(algorithm: str, cis_nodes, soc_node: int,
                      strict: bool) -> List[Dict]:
    from ..algorithms import get_algorithm
    build = get_algorithm(algorithm).builder
    rows = []
    for node in cis_nodes:
        for variant in _variants(algorithm):
            hw, stages, mapping, meta = build(variant, cis_node=node,
                                              soc_node=soc_node)
            rep = estimate_energy(hw, stages, mapping, strict=strict)
            rows.append(dict(
                algorithm=algorithm, variant=variant, cis_node=node,
                total_uj=rep.total() * 1e6,
                on_sensor_uj=rep.total(include_off_sensor=False) * 1e6,
                breakdown_uj={k: v * 1e6 for k, v in
                              rep.by_category().items()},
                **power_density(hw, rep)))
    return rows


def find_row(rows: List[Dict], variant: str, node: int) -> Dict:
    for r in rows:
        if r["variant"] == variant and r["cis_node"] == node:
            return r
    raise KeyError((variant, node))
