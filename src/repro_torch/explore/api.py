"""``explore()`` of the port: the front door over the fused streaming sweep.

``explore(space, k=..., metric=...)`` scores a declarative
:class:`~repro_torch.explore.space.DesignSpace` and returns an
:class:`ExploreResult` — top-k rows, per-variant summaries, dispatch /
occupancy accounting and the engine's counters — like the reference's
``repro.explore.explore``.

Only the ``fused`` engine is ported so far: ``engine="auto"`` resolves
to it at every size, and an explicit ``"monolithic"``, ``"chunked"`` or
``"staged"`` raises ``NotImplementedError`` naming the ROADMAP item that
will port it.  The sweep runs on ``device`` (default ``"cuda"``; the
CUDA megakernel) unless the caller passes ``device="cpu"`` (the
plain-torch twin); without a GPU the default device raises instead of
falling back.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.batch import OUT_KEYS
from ..core.plan import lower_cache_info
from ..core.shard_sweep import StreamResult, _stream_impl, stream_cache_info
from .space import DesignSpace

#: engine names accepted by :func:`explore` (the reference's set)
ENGINES = ("auto", "monolithic", "chunked", "staged", "fused")

#: engines of the reference not ported yet -> the ROADMAP item porting them
_NOT_PORTED = {
    "monolithic": "P6 (per-plan grid engines)",
    "chunked": "P6 (per-plan grid engines)",
    "staged": "P7 (staged parity engine)",
}
_DEFAULT_CHUNK = 1 << 18


@dataclasses.dataclass
class ExploreResult:
    """Unified result of one :func:`explore` call.

    ``topk`` rows (ascending by ``metric``, feasible only) carry the
    owning ``algorithm`` / ``variant``, the variant-local ``index``, the
    exact axis values and every model output; ``summaries`` maps variant
    labels to ``{n, n_feasible, metric_min, metric_mean, argmin_index,
    argmin_point}``.  ``stream_result`` is the engine's raw
    :class:`StreamResult`; ``cache`` snapshots the lowering cache and the
    engine's counters after the run; ``device`` is where it ran.
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
    stream_result: Optional[StreamResult] = None
    #: resolved execution backend ("cuda" / "torch")
    backend: Optional[str] = None
    device: str = ""

    def __len__(self) -> int:
        return self.n_points

    @property
    def points_per_sec(self) -> float:
        """Streaming throughput (prep and kernel build excluded)."""
        return self.n_points / max(self.eval_s, 1e-12)

    def best(self, k: Optional[int] = None) -> List[Dict]:
        """Top-k rows by the metric (ascending), feasible only."""
        return self.topk[:k]


def _resolve_engine(engine: str) -> str:
    """``auto`` -> ``fused`` at every size until the grid engines are
    ported; unported engines raise instead of being rerouted."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; valid: "
                         f"{list(ENGINES)}")
    if engine in _NOT_PORTED:
        raise NotImplementedError(
            f"engine={engine!r} is not ported to repro_torch yet (ROADMAP "
            f"{_NOT_PORTED[engine]}); use engine='fused' or 'auto'")
    return "fused"


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
            block_points: int = 4096,
            index_range: Optional[Tuple[int, int]] = None,
            superchunk: Optional[int] = None, backend: str = "auto",
            device="cuda", mesh=None,
            checkpoint_dir: Optional[str] = None, campaign=None,
            workers: Optional[int] = None, service=None) -> ExploreResult:
    """Score a :class:`DesignSpace` through the fused streaming sweep.

    ``k`` bounds the top-k winner list, ``metric`` is any model output
    key (``total_j``, ``on_sensor_j``, ``density_mw_mm2``, ...).
    ``chunk_size`` (default 2^18) bounds the points per kernel launch,
    ``block_points`` the points per CUDA block, ``superchunk`` the chunk
    ordinals per dispatch; ``index_range=(lo, hi)`` streams only that
    slice of the flat index space.

    ``device`` (default ``"cuda"``) is where the sweep runs; ``backend``
    is ``"cuda"`` (the hand-written CUDA kernel), ``"torch"`` (its torch
    twin) or ``"auto"`` (``cuda`` on a CUDA device, ``torch`` on the CPU;
    ``REPRO_TORCH_SWEEP_BACKEND`` overrides the auto policy).

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
    _resolve_engine(engine)
    t0 = time.perf_counter()
    st = _stream_impl(
        list(space.algorithms), space.grids, soc_node=space.soc_node,
        chunk_size=chunk_size or _DEFAULT_CHUNK, metric=metric, k=k,
        block_points=block_points, index_range=index_range,
        superchunk=superchunk, backend=backend, device=device)
    return ExploreResult(
        space=space, engine=st.engine, metric=st.metric, k=st.k,
        n_points=st.n_points, n_feasible=st.n_feasible,
        n_variants=st.n_variants, n_devices=st.n_devices,
        chunk_size=st.chunk_size, topk=st.topk, summaries=st.summaries,
        wall_s=time.perf_counter() - t0, compile_s=st.compile_s,
        eval_s=st.eval_s, dispatches=st.dispatches,
        superchunk=st.superchunk, occupancy=st.occupancy,
        cache={"lower": lower_cache_info(), "stream": stream_cache_info()},
        stream_result=st, backend=st.backend, device=str(device))
