"""``explore()`` of the port: one front door over every sweep engine.

``explore(space, k=..., metric=...)`` scores a declarative
:class:`~repro_torch.explore.space.DesignSpace` and returns an
:class:`ExploreResult` — top-k rows, per-variant summaries, dispatch /
occupancy accounting and the engine's counters — like the reference's
``repro.explore.explore``, whichever engine ran underneath:

* ``monolithic`` — the grid engine with full O(N) result tables (kept on
  ``ExploreResult.sweep_results``), one evaluator call per variant;
* ``chunked``    — the same tables walked in O(chunk) batches;
* ``fused``      — the streaming engine: one fused decode -> evaluate ->
  reduce megakernel launch per chunk, O(k + V) device state;
* ``staged``     — the staged streaming pipeline (decode, evaluate,
  block stats: the fused engine's parity oracle);
* ``auto`` (default) — the reference's policy: monolithic while full
  tables are cheap (<= 2^15 points, no ``chunk_size``), chunked while
  they still fit on the host (<= 2^21), fused beyond (or whenever
  ``index_range`` asks for a stream slice).

The sweep runs on ``device`` (default ``"cuda"``: the hand-written CUDA
kernels) unless the caller passes ``device="cpu"`` (their plain-torch
twins); without a GPU the default device raises instead of falling back.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.axes import AXES
from ..core.batch import OUT_KEYS
from ..core.plan import lower_cache_info
from ..core.shard_sweep import (StreamResult, _stream_impl,
                                best_by_algorithm_summaries,
                                stream_cache_info)
from ..core.sweep import SweepResult, _sweep_impl
from .space import DesignSpace

#: engine names accepted by :func:`explore` (the reference's set)
ENGINES = ("auto", "monolithic", "chunked", "staged", "fused")

#: ``auto`` thresholds: full tables up to 2^15 points, chunked tables up
#: to 2^21, the bounded streaming engine beyond
AUTO_MONOLITHIC_MAX = 1 << 15
AUTO_CHUNKED_MAX = 1 << 21
_DEFAULT_CHUNK = 1 << 18


@dataclasses.dataclass
class ExploreResult:
    """Unified result of one :func:`explore` call.

    ``topk`` rows (ascending by ``metric``, feasible only) carry the
    owning ``algorithm`` / ``variant``, the variant-local ``index``, the
    exact axis values and every model output; ``summaries`` maps variant
    labels to ``{n, n_feasible, metric_min, metric_mean, argmin_index,
    argmin_point}``.  Grid engines keep the full per-algorithm tables on
    ``sweep_results``; streaming engines expose the raw
    ``stream_result``.  ``cache`` snapshots the lowering cache and the
    streaming engine's counters after the run; ``device`` is where it
    ran.
    """
    space: DesignSpace
    engine: str
    metric: str
    k: int
    n_points: int
    n_feasible: int
    n_variants: int
    n_devices: int
    chunk_size: Optional[int]
    topk: List[Dict]
    summaries: Dict[str, Dict]
    wall_s: float
    compile_s: float
    eval_s: float
    dispatches: int
    superchunk: int
    occupancy: float
    cache: Dict[str, Dict]
    sweep_results: Optional[Dict[str, SweepResult]] = None
    stream_result: Optional[StreamResult] = None
    #: resolved streaming execution backend ("cuda" / "torch"); None for
    #: the grid engines
    backend: Optional[str] = None
    device: str = ""

    def __len__(self) -> int:
        return self.n_points

    @property
    def points_per_sec(self) -> float:
        """Throughput (prep and kernel build excluded)."""
        return self.n_points / max(self.eval_s, 1e-12)

    def best(self, k: Optional[int] = None) -> List[Dict]:
        """Top-k rows by the metric (ascending), feasible only."""
        return self.topk[:k]

    def best_by_algorithm(self) -> Dict[str, Dict]:
        """Per-algorithm best variant by the metric.

        ``{algorithm: {"variant", "summary", "n_feasible"}}`` — every
        algorithm of the space gets a record even when it misses the
        global top-k; ``summary["argmin_point"]`` is None when nothing
        was feasible.
        """
        return best_by_algorithm_summaries(self.summaries,
                                           self.space.algorithms[0])


def _resolve_engine(engine: str, space: DesignSpace, chunk_size,
                    index_range) -> str:
    """The reference's engine policy (``repro/explore/api.py:124``)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; valid: "
                         f"{list(ENGINES)}")
    if engine == "auto":
        if index_range is not None or space.n_points > AUTO_CHUNKED_MAX:
            return "fused"
        if space.n_points <= AUTO_MONOLITHIC_MAX and chunk_size is None:
            return "monolithic"
        return "chunked"
    if engine == "monolithic" and chunk_size is not None:
        return "chunked"
    return engine


def _cache_snapshot() -> Dict[str, Dict]:
    return {"lower": lower_cache_info(), "stream": stream_cache_info()}


def _grid_explore(space: DesignSpace, engine: str, *, k, metric,
                  chunk_size, strict, device) -> ExploreResult:
    """Grid engines: per-algorithm full tables -> unified result."""
    t0 = time.perf_counter()
    chunk = ((chunk_size or _DEFAULT_CHUNK) if engine == "chunked"
             else None)
    sweep_results: Dict[str, SweepResult] = {}
    for algo in space.algorithms:
        sweep_results[algo] = _sweep_impl(
            algo, space.grids, soc_node=space.soc_node, strict=strict,
            chunk_size=chunk, device=device)

    n_var = space.n_var
    # the concatenated per-algorithm tables ARE the variant-major flat
    # index space: algorithms in space order, variants in slot order,
    # n_var C-order rows per variant
    metric_all = np.concatenate(
        [np.asarray(sweep_results[a].outputs[metric], np.float64)
         for a in space.algorithms])
    feas_all = np.concatenate(
        [sweep_results[a].outputs["feasible"].astype(bool)
         for a in space.algorithms])
    if len(metric_all) != space.n_points:
        raise RuntimeError(f"grid tables hold {len(metric_all)} rows for "
                           f"a space of {space.n_points} points")

    # ----- per-variant summaries (label convention == streaming) ----------
    summaries: Dict[str, Dict] = {}
    slot = 0
    for algo in space.algorithms:
        res = sweep_results[algo]
        for v in range(len(res) // n_var):
            sl = slice(v * n_var, (v + 1) * n_var)
            vals = np.asarray(res.outputs[metric], np.float64)[sl]
            feas = res.outputs["feasible"].astype(bool)[sl]
            nf = int(feas.sum())
            if nf:
                amin = int(np.argmin(np.where(feas, vals, np.inf)))
                point = {ax: float(res.params[ax][v * n_var + amin])
                         for ax in AXES}
            else:
                amin, point = -1, None
            summaries[space.label(slot)] = dict(
                n=n_var, n_feasible=nf,
                metric_min=float(vals[feas].min()) if nf
                else float("inf"),
                metric_mean=float(vals[feas].mean()) if nf
                else float("nan"),
                argmin_index=amin, argmin_point=point)
            slot += 1

    # ----- global top-k rows (full output schema from the tables) ---------
    masked = np.where(feas_all, metric_all, np.inf)
    order = np.argsort(masked, kind="stable")[:k]
    algo_rows = np.cumsum([0] + [len(sweep_results[a])
                                 for a in space.algorithms])
    rows: List[Dict] = []
    for gi in order:
        if not np.isfinite(masked[gi]):
            break
        ai = int(np.searchsorted(algo_rows, gi, side="right") - 1)
        algo = space.algorithms[ai]
        r = sweep_results[algo].row(int(gi - algo_rows[ai]))
        row = dict(variant=str(r.pop("variant")), algorithm=algo,
                   index=int(gi) % n_var)
        row.update({ax: float(r[ax]) for ax in AXES})
        row.update({key: float(r[key]) for key in OUT_KEYS})
        rows.append(row)

    chunks_per_variant = (1 if chunk is None
                          else -(-n_var // max(int(chunk), 1)))
    return ExploreResult(
        space=space, engine=engine, metric=metric, k=k,
        n_points=space.n_points, n_feasible=int(feas_all.sum()),
        n_variants=space.n_variants, n_devices=1, chunk_size=chunk,
        topk=rows, summaries=summaries, wall_s=time.perf_counter() - t0,
        compile_s=sum(r.compile_s for r in sweep_results.values()),
        eval_s=sum(r.eval_s for r in sweep_results.values()),
        dispatches=space.n_variants * chunks_per_variant, superchunk=1,
        occupancy=1.0, cache=_cache_snapshot(),
        sweep_results=sweep_results, device=str(device))


def _validate_request(k, chunk_size) -> None:
    """Boundary validation of the request's ``k`` and ``chunk_size``."""
    if isinstance(k, bool) or not isinstance(k, (int, np.integer)):
        raise ValueError(f"k must be an integer >= 1 (the top-k row "
                         f"budget), got {k!r} of type {type(k).__name__}")
    if k < 1:
        raise ValueError(f"k must be >= 1 (at least one top-k row "
                         f"to keep), got {k}")
    if chunk_size is not None:
        if isinstance(chunk_size, bool) \
                or not isinstance(chunk_size, (int, np.integer)):
            raise ValueError(
                f"chunk_size must be an integer >= 1 (points per "
                f"dispatch) or None for the engine default, got "
                f"{chunk_size!r} of type {type(chunk_size).__name__}")
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1 (points per "
                             f"dispatch), got {chunk_size}")


def explore(space: DesignSpace, *, k: int = 16, metric: str = "total_j",
            engine: str = "auto", chunk_size: Optional[int] = None,
            strict: bool = False, block_points: int = 4096,
            progress: Optional[Callable[[int, int], None]] = None,
            index_range: Optional[Tuple[int, int]] = None,
            pipeline_depth: int = 4, superchunk: Optional[int] = None,
            backend: str = "auto", device="cuda", mesh=None,
            checkpoint_dir: Optional[str] = None, campaign=None,
            workers: Optional[int] = None, service=None) -> ExploreResult:
    """Score a :class:`DesignSpace`; one entry point for every engine.

    ``k`` bounds the top-k winner list, ``metric`` is any model output
    key (``total_j``, ``on_sensor_j``, ``density_mw_mm2``, ...), and
    ``engine`` picks the execution strategy (see the module docstring;
    ``"auto"`` sizes it from ``space.n_points``).  ``chunk_size`` bounds
    the per-dispatch batch of the chunked and streaming engines (default
    2^18).  ``strict`` (grid engines) raises on pipeline stalls and
    infeasible points, like the scalar oracle.  ``block_points`` (the
    kernels' reduction block), ``superchunk`` (fused chunk ordinals per
    dispatch), ``index_range=(lo, hi)`` (stream only that slice of the
    flat index space), ``progress`` (called as ``progress(done, span)``
    after every dispatch) and ``pipeline_depth`` (dispatches in flight
    before the host waits for the oldest) tune the streaming engines.

    ``device`` (default ``"cuda"``) is where the sweep runs; ``backend``
    (fused engine) is ``"cuda"`` (the hand-written CUDA kernel),
    ``"torch"`` (its torch twin) or ``"auto"`` (``cuda`` on a CUDA
    device, ``torch`` on the CPU; ``REPRO_TORCH_SWEEP_BACKEND`` overrides
    the auto policy).

    ``mesh``, ``checkpoint_dir``, ``campaign``, ``workers`` and
    ``service`` are the reference's multi-device, campaign and serving
    layers; they raise ``NotImplementedError`` until ported.
    """
    if not isinstance(space, DesignSpace):
        raise TypeError(f"explore() takes a DesignSpace, got "
                        f"{type(space).__name__}; wrap your algorithms + "
                        f"grids in DesignSpace(...)")
    if metric not in OUT_KEYS:
        raise KeyError(f"unknown metric {metric!r}; valid: "
                       f"{sorted(OUT_KEYS)}")
    _validate_request(k, chunk_size)
    for name, val, item in (
            ("mesh", mesh, "P8 (multi-device sweeps)"),
            ("checkpoint_dir", checkpoint_dir, "P9 (campaigns)"),
            ("campaign", campaign, "P9 (campaigns)"),
            ("workers", workers, "P9 (campaigns)"),
            ("service", service, "P10 (serving)")):
        if val is not None:
            raise NotImplementedError(
                f"{name}= is not ported to repro_torch yet (ROADMAP "
                f"{item})")
    engine = _resolve_engine(engine, space, chunk_size, index_range)

    if engine in ("monolithic", "chunked"):
        for name, val, default in (("index_range", index_range, None),
                                   ("progress", progress, None),
                                   ("superchunk", superchunk, None),
                                   ("block_points", block_points, 4096),
                                   ("pipeline_depth", pipeline_depth, 4),
                                   ("backend", backend, "auto")):
            if val != default:
                raise ValueError(f"{name}= requires a streaming engine "
                                 f"('fused' or 'staged'), not {engine!r}")
        return _grid_explore(space, engine, k=k, metric=metric,
                             chunk_size=chunk_size, strict=strict,
                             device=device)

    if strict:
        raise ValueError("strict=True requires a grid engine "
                         "('monolithic' or 'chunked'); the streaming "
                         "engines mask infeasible points instead")
    t0 = time.perf_counter()
    st = _stream_impl(
        list(space.algorithms), space.grids, soc_node=space.soc_node,
        chunk_size=chunk_size or _DEFAULT_CHUNK, metric=metric, k=k,
        block_points=block_points, index_range=index_range,
        superchunk=superchunk, backend=backend, engine=engine,
        device=device, progress=progress, pipeline_depth=pipeline_depth)
    return ExploreResult(
        space=space, engine=st.engine, metric=st.metric, k=st.k,
        n_points=st.n_points, n_feasible=st.n_feasible,
        n_variants=st.n_variants, n_devices=st.n_devices,
        chunk_size=st.chunk_size, topk=st.topk, summaries=st.summaries,
        wall_s=time.perf_counter() - t0, compile_s=st.compile_s,
        eval_s=st.eval_s, dispatches=st.dispatches,
        superchunk=st.superchunk, occupancy=st.occupancy,
        cache=_cache_snapshot(), stream_result=st, backend=st.backend,
        device=str(device))
