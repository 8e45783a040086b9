"""Streaming sweep engines of the port: fused (one megakernel launch per
chunk) and staged (decode -> evaluate -> reduce, three passes per chunk).

Torch counterpart of the reference's streaming engines
(``repro/core/shard_sweep.py:284-1168``):

1. **prepare** (:func:`_prepare_stream`) — every variant of every
   algorithm is lowered, packed into ONE ``(V, W)`` PlanBank and one
   ``(n_axes, V * Lmax)`` axis table, both on the sweep's device;
2. **fused loop** (``engine="fused"``) — the variant-major flat index
   space is walked in chunk ordinals (``cpv`` per variant, so every
   chunk is variant-uniform and reads ONE bank row); each dispatch covers
   ``superchunk`` ordinals, and a dead ordinal (past the last live one)
   launches nothing.  Each live chunk runs the fused decode -> evaluate
   -> reduce megakernel (``repro_torch.kernels.fused_sweep``), and its
   ``(G, kk)`` block candidates fold to the chunk's top-kk;
3. **staged loop** (``engine="staged"``, the fused engine's parity
   oracle) — one dispatch per chunk, chunks aligned to variant
   boundaries: the ``grid_decode`` kernel, the banked evaluator
   (:func:`repro_torch.core.batch.build_banked_eval`), the
   ``block_stats`` kernel and the chunk's top-k, with the winners' full
   output rows kept on the device (``topk_out``);
4. **fold** — each chunk's O(k) partials merge into the running top-k
   and per-variant summaries (:func:`_merge_candidates`), all on the
   device: no value comes back to the host per chunk;
5. **finalize** (:func:`_finalize`) — ONE host sync copies the O(k + V)
   state back; the fused engine re-gathers the k winners' full output
   rows through the coefficient-form compute.

On a CUDA device the kernels run; on the CPU their plain-torch twins.
Every top-k ranks in IEEE total order, as the reference's
``lax.top_k(-x)`` does (:func:`~repro_torch.kernels.fused_sweep.
sort_total`: a sign-bit NaN first, a positive NaN after ``+inf``).
Ties break to the lowest flat index everywhere (stable sorts), and flat
indices widen to int64 when ``total + chunk >= 2**31``.  Campaign shards
(``repro_torch.campaign``) and coalesced serve segments
(``repro_torch.serve``) enter through ``_stream_impl(index_range=,
_prepared=)``; the serve layer streams partial top-k through its
``on_partial`` hook.  The shape-only per-sweep state (the coefficient
compute, K1's plan and fixed launch parameters, the staged evaluator) is
built once per shape key (:func:`_step`), the counterpart of the
reference's step-executable cache.

**The batch mesh** (``mesh=``, a :class:`~repro_torch.launch.mesh.
BatchMesh`; a bare ``device=`` is a one-entry mesh): as the reference's
``shard_map`` over its ``("batch",)`` axis, every chunk splits into
``mesh.size`` equal shards and shard *i* runs on ``mesh.devices[i]``
against that device's replica of the tables and the bank.  The chunk is
rounded up to a multiple of the mesh size (it may run past the variant,
the mask decides), each shard keeps its own ``bp`` and ``kk``, and the
shards' O(k) partials move to ``devices[0]`` and merge there in shard
order (:func:`_combine_shards`).  One process drives every shard, and
the sweep keeps its one host sync.  :func:`evaluate_batch_sharded` is
the grid engines' split.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..kernels.cuda_build import sm_count
from ..kernels.fused_sweep import (COUNTS, fused_sweep_block_torch,
                                   kernel_params, load_kernel_library,
                                   reset_counts, sort_total)
from ..kernels.fused_sweep import plan as k1_plan
from ..kernels.fused_sweep import run as k1_run
from ..kernels.grid_decode import grid_decode
from ..kernels.runtime import resolve_backend
from ..kernels.stream_reduce import block_stats
from ..launch.mesh import BatchMesh, make_batch_mesh, resolve_mesh
from ..launch.mesh import device_key as _device_key
from .axes import AXES
from .batch import (OUT_KEYS, DesignPoints, build_banked_eval,
                    build_coeff_compute, evaluate_split,
                    points_from_axis_rows)
from .grid import (_normalize_grids, axis_tables, fused_table2,
                   lower_variant, variant_grid)
from .plan import EnergyPlan
from .plan_bank import PlanBank, build_plan_bank

#: default number of chunk ordinals per dispatch
_DEFAULT_SUPERCHUNK = 16

#: superchunk dispatches, stream preparations (:func:`_prepare_stream`)
#: and step builds (:func:`_step`) since the last :func:`stream_cache_clear`
_STATS = {"dispatches": 0, "preps": 0, "step_builds": 0}
#: shape-keyed step state (:func:`_step`), least recently used first
_STEPS: "OrderedDict[tuple, _Step]" = OrderedDict()
_STEP_LIMIT = 64
#: guards the step cache and ``_STATS``: the serve worker and client
#: threads sweep at once, and must never build one key twice or tear a
#: counter (the reference's ``_STREAM_LOCK``).  Reentrant, as the
#: reference's is.
_STREAM_LOCK = threading.RLock()


def stream_cache_info() -> Dict[str, int]:
    """Counters of the streaming engine since :func:`stream_cache_clear`:
    K1 launches, twin calls, superchunk dispatches, stream preparations
    (lowering, bank and tables; a campaign makes one in its process, or
    one per worker, and hands it to every shard) and step builds (one a
    shape key: the reference's ``step_compiles``)."""
    with _STREAM_LOCK:
        return dict(kernel_launches=COUNTS["kernel_launches"],
                    twin_calls=COUNTS["twin_calls"], **_STATS)


def stream_cache_clear() -> None:
    """Empty the step cache and zero every counter of
    :func:`stream_cache_info`."""
    with _STREAM_LOCK:
        reset_counts()
        _STEPS.clear()
        for key in _STATS:
            _STATS[key] = 0


def _bump(field: str) -> None:
    with _STREAM_LOCK:
        _STATS[field] += 1


@dataclasses.dataclass(frozen=True)
class _Step:
    """What a sweep of one shape key needs beyond its prep.  Fused:
    ``launches[i](table2, row, start, low, limit)`` for shard ``i`` (K1
    under the plan of the shard's device, or the twin) and the
    coefficient-form ``compute`` its finalize re-gathers the winners
    with; staged: ``eval_uniform`` (its state keeps the winners' rows,
    so it needs no compute)."""
    compute: Optional[Callable] = None
    launches: Tuple[Callable, ...] = ()
    eval_uniform: Optional[Callable] = None


def _mesh_key(mesh: BatchMesh):
    """A mesh as a step key names it: the device keys of its shards, in
    order.  A one-entry mesh is its device's key alone, the key a bare
    ``device=`` has always given, so one-device sweeps, campaigns and
    served requests share their steps as before."""
    keys = tuple(_device_key(d) for d in mesh.devices)
    return keys[0] if len(keys) == 1 else keys


def _fused_key(backend: str, mesh: BatchMesh, chunk: int, metric: str,
               k: int, block_points: int, dims, shape: Sequence[int],
               n_var: int, lmax: int, s_len: int, cpv: int,
               wide: bool) -> tuple:
    """The fused engine's step key: the shape-only quantities of the
    reference's ``_fused_exec`` key (``repro/core/shard_sweep.py:639``).
    ``repro_torch.serve.coalesce.compat_key`` is this key, so equal
    compat keys share one step."""
    return ("fused", backend, _mesh_key(mesh), int(chunk), metric,
            int(k), int(block_points), tuple(int(d) for d in dims),
            tuple(int(s) for s in shape), int(n_var), int(lmax), int(s_len),
            int(cpv), "int64" if wide else "int32")


def _step(key: tuple, build: Callable[[], _Step]) -> _Step:
    """The step of ``key``, built by ``build()`` on its first use (counted
    in ``step_builds``) under the lock, so concurrent sweeps of one key
    build it once.  The cache keeps the ``_STEP_LIMIT`` most recently
    used keys."""
    with _STREAM_LOCK:
        step = _STEPS.get(key)
        if step is None:
            step = _STEPS[key] = build()
            _STATS["step_builds"] += 1
            while len(_STEPS) > _STEP_LIMIT:
                _STEPS.popitem(last=False)
        _STEPS.move_to_end(key)
        return step


def _fused_step(backend: str, mesh: BatchMesh, dims, *, metric: str,
                shape: Sequence[int], n_var: int, total: int, shard: int,
                lmax: int, table_cols: int, bp: int, kk: int,
                idx_dtype) -> _Step:
    """Build a fused step: the compute and one launch a shard of
    ``shard`` points.  On the ``cuda`` lane each distinct device gets
    K1's plan for its SMs, with the fixed launch parameters built and
    checked here, so a shape the kernel does not take fails before any
    launch."""
    compute = build_coeff_compute(dims)
    kw = dict(compute=compute, metric=metric, axis_names=AXES, shape=shape,
              n_var=n_var, total=total, chunk=shard, lmax=lmax,
              block_points=bp, kk=kk, idx_dtype=idx_dtype)
    if backend != "cuda":
        twin = functools.partial(fused_sweep_block_torch, **kw)
        return _Step(compute, (twin,) * mesh.size)
    launches = {}
    for dev in mesh.distinct:
        p = k1_plan(bp, kk, shard, sm_count(dev))
        kernel_params(dims, metric=metric, shape=shape, n_var=n_var,
                      total=total, chunk=shard, lmax=lmax,
                      table_cols=table_cols, bp=bp, kk=kk, start=0, low=0,
                      limit=0, p=p)
        launches[dev] = functools.partial(k1_run, p=p, **kw)
    return _Step(compute, tuple(launches[d] for d in mesh.devices))


def _validate_index_range(index_range, total: int) -> Tuple[int, int]:
    """Resolve ``index_range`` against the flat index space ``[0, total)``.

    ``None`` means the whole space.  Bounds must be integers with
    ``0 <= lo <= hi <= total``; an empty range is valid.
    """
    if index_range is None:
        return 0, int(total)
    try:
        lo_raw, hi_raw = index_range
    except (TypeError, ValueError):
        raise ValueError(f"index_range must be a (lo, hi) pair, got "
                         f"{index_range!r}") from None
    try:
        lo, hi = int(lo_raw), int(hi_raw)
    except (TypeError, ValueError):
        raise ValueError(f"index_range bounds must be integers, got "
                         f"({lo_raw!r}, {hi_raw!r})") from None
    if lo > hi:
        raise ValueError(f"index_range ({lo}, {hi}) is reversed "
                         f"(lo > hi); valid flat indices span "
                         f"[0, {total}) with lo <= hi")
    if lo < 0 or hi > total:
        raise ValueError(f"index_range ({lo}, {hi}) outside the flat "
                         f"index space; valid flat indices span "
                         f"[0, {total}) with 0 <= lo <= hi <= {total}")
    return lo, hi


def _init_banked_state(k: int, n_variants: int, idx_dtype, device,
                       with_out: bool = False) -> Dict[str, torch.Tensor]:
    """The running reduction state: global top-k + per-variant stats;
    ``with_out`` adds the winners' full output rows (the staged engine
    keeps them on the device; the fused one re-gathers them at the end).
    """
    f32 = torch.float32
    state = dict(
        topk_v=torch.full((k,), torch.inf, dtype=f32, device=device),
        topk_i=torch.full((k,), -1, dtype=idx_dtype, device=device),
        n_feasible=torch.zeros((n_variants,), dtype=idx_dtype,
                               device=device),
        metric_sum=torch.zeros((n_variants,), dtype=f32, device=device),
        metric_min=torch.full((n_variants,), torch.inf, dtype=f32,
                              device=device),
        argmin=torch.full((n_variants,), -1, dtype=idx_dtype,
                          device=device),
    )
    if with_out:
        state["topk_out"] = torch.zeros((k, len(OUT_KEYS)), dtype=f32,
                                        device=device)
    return state


def _variant_span_counts(lo: int, hi: int, n_var: int, n_variants: int
                         ) -> np.ndarray:
    """How many of the flat indices ``[lo, hi)`` land in each variant
    (pure range arithmetic on the variant-major flat space)."""
    vi = np.arange(n_variants, dtype=np.int64)
    base = vi * n_var
    return np.maximum(
        np.minimum(hi, base + n_var) - np.maximum(lo, base), 0)


def _fold_chunk(cv, cl, sums, counts, s0: int, bp: int, kk: int,
                idx_dtype) -> Dict[str, torch.Tensor]:
    """Fold one chunk's ``(G, kk)`` block candidates to its top-kk and
    its first-minimum block (the reference's shard-level fold)."""
    vals, pos = sort_total(cv.reshape(-1))
    pos = pos[:kk]
    blk = torch.div(pos, kk, rounding_mode="floor").to(idx_dtype)
    cand_i = blk * bp + cl.reshape(-1).index_select(0, pos).to(idx_dtype) \
        + s0
    # first-min block wins; tensor indices only, so nothing syncs
    mins, g = torch.min(cv[:, 0], dim=0)
    amin_i = (g * bp).to(idx_dtype) \
        + cl[:, 0].index_select(0, g.view(1))[0].to(idx_dtype) + s0
    return dict(cand_v=vals[:kk], cand_i=cand_i, mins=mins,
                amin_i=amin_i, sums=torch.sum(sums),
                counts=torch.sum(counts))


def _chunk_geometry(chunk_size: int, n_var: int, ndev: int) -> int:
    """The chunk a sweep on ``ndev`` shards takes
    (``repro/core/shard_sweep.py:952-963``): ``chunk_size`` rounded up to
    a multiple of ``ndev``, clamped to the per-variant span rounded the
    same way.  A chunk may so run past its variant; the mask decides."""
    chunk = -(-max(int(chunk_size), 1) // ndev) * ndev
    return min(chunk, -(-n_var // ndev) * ndev)


def _first_min(x: torch.Tensor) -> torch.Tensor:
    """``jnp.argmin``'s pick over a 1-D tensor, as a 0-d tensor: the first
    NaN if there is one, else the first minimum (not
    :func:`~repro_torch.kernels.fused_sweep.sort_total`'s order, which
    ranks a positive NaN last).  Tensor ops only, so nothing syncs."""
    nan = torch.isnan(x)
    return torch.where(torch.any(nan), torch.argmax(nan.to(torch.int32)),
                       torch.argmin(x))


def _combine_shards(parts: List[Dict[str, torch.Tensor]],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """The ``(ndev,)`` partials of one chunk's shards as one partial on
    ``device``, as the reference's merge reads them
    (``repro/core/shard_sweep.py:349-378``): candidates (and their output
    rows) in shard order, the minimum and its flat index from the shard
    ``jnp.argmin`` picks, sums and counts summed over the shards.  The
    copies to ``device`` are ordered on the streams without a host wait.
    One shard's partial is returned as it is."""
    if len(parts) == 1:
        return parts[0]
    parts = [{key: val.to(device, non_blocking=True)
              for key, val in part.items()} for part in parts]
    mins = torch.stack([part["mins"] for part in parts])
    pick = _first_min(mins).view(1)
    out = {key: torch.cat([part[key] for part in parts])
           for key in ("cand_v", "cand_i", "cand_out") if key in parts[0]}
    out["mins"] = mins.index_select(0, pick)[0]
    out["amin_i"] = torch.stack([part["amin_i"] for part in parts]
                                ).index_select(0, pick)[0]
    for key in ("sums", "counts"):
        out[key] = torch.sum(torch.stack([part[key] for part in parts]))
    return out


def _xla_min(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """XLA's ``min`` (the reference's ``.at[v].min``): a NaN propagates
    and ``-0`` is below ``+0`` whichever operand holds it, where
    ``torch.minimum`` keeps the first of two equal zeros.  Equal values
    OR their bits, which only turns ``+0`` and ``-0`` into ``-0``."""
    both = (a.view(torch.int32) | b.view(torch.int32)).view(torch.float32)
    return torch.where(a == b, both, torch.minimum(a, b))


def _merge_candidates(c: Dict[str, torch.Tensor], v: int,
                      state: Dict[str, torch.Tensor], k: int) -> None:
    """Fold one chunk's O(k) partials into the running state, in place.

    ``v`` is the chunk's variant slot (host arithmetic).  Every update
    is neutral for an all-masked chunk (counts 0, minimum +inf,
    candidates +inf).  On ties the running top-k keeps its entries ahead
    of the chunk's, so equal values keep the lowest flat index.
    """
    merged_v = torch.cat([state["topk_v"], c["cand_v"]])
    vals, sel = sort_total(merged_v)
    sel = sel[:k]
    state["topk_i"] = torch.cat([state["topk_i"], c["cand_i"]])[sel]
    state["topk_v"] = vals[:k]
    if "topk_out" in state:
        state["topk_out"] = torch.cat([state["topk_out"],
                                       c["cand_out"]])[sel]
    nf = state["n_feasible"]
    nf[v] += c["counts"].to(nf.dtype)
    state["metric_sum"][v] += c["sums"]
    old_min = state["metric_min"][v].clone()
    state["metric_min"][v] = _xla_min(old_min, c["mins"])
    state["argmin"][v] = torch.where(c["mins"] < old_min, c["amin_i"],
                                     state["argmin"][v])


def _staged_chunk(prep: "_StreamPrep", eval_uniform, start: int,
                  limit: int, *, chunk: int, bp: int, kk: int, metric: str,
                  idx_dtype, variant: int,
                  replica: Tuple[torch.Tensor, PlanBank]
                  ) -> Dict[str, torch.Tensor]:
    """One staged shard ``[start, start + chunk)`` of ``variant`` (its
    chunk's; a tail shard may start past the variant): decode (K2), the
    banked evaluator against the variant's row, block stats (K3a) and
    the top-kk with their full output rows, on the device of
    ``replica``, the shard's ``(table2, bank)``.  Points at or past
    ``limit`` are masked."""
    table2, bank = replica
    dev = table2.device
    vals, _vid = grid_decode(table2, start, shape=prep.vgrids[0].shape,
                             n_var=prep.n_var, total=prep.total, chunk=chunk,
                             lmax=prep.lmax, idx_dtype=idx_dtype)
    flat = torch.arange(chunk, dtype=idx_dtype, device=dev) + start
    out = eval_uniform(bank, variant, points_from_axis_rows(vals))
    ok = out["feasible"] & (flat < limit)
    metric_v = out[metric].to(torch.float32)
    mins, amins, sums, counts = block_stats(metric_v, ok, block_points=bp)
    # first-min block wins; tensor indices only, so nothing syncs
    g = torch.argmin(mins).view(1)
    amin_i = (g.to(torch.int32) * bp
              + amins.index_select(0, g)).to(idx_dtype)[0] + start
    # ascending in total order, invalid +inf; ties keep the lower index,
    # as the reference's lax.top_k(-x)
    cand_v, pos = sort_total(torch.where(ok, metric_v, torch.inf))
    pos = pos[:kk]
    return dict(
        cand_v=cand_v[:kk], cand_i=flat[pos],
        cand_out=torch.stack([out[key][pos].to(torch.float32)
                              for key in OUT_KEYS], dim=1),
        mins=mins.index_select(0, g)[0], amin_i=amin_i,
        sums=torch.sum(sums), counts=torch.sum(counts))


@dataclasses.dataclass
class _StreamPrep:
    """Lowered, device-resident sweep inputs (see :func:`_prepare_stream`).

    ``table2`` and ``bank`` live on the first device of the mesh the prep
    was made for; ``replicas`` holds what a launch reads (the axis table
    and the bank) once for each distinct device, that one included, so a
    repeated device shares one replica."""
    algos: List[str]
    labels: List[str]
    valgos: List[str]
    vnames: List[str]
    vgrids: List
    n_var: int
    n_variants: int
    total: int
    tables: np.ndarray           # (V, n_axes, Lmax) f32 axis-value bank
    bank: PlanBank
    lmax: int
    table2: torch.Tensor         # (n_axes, V * Lmax) megakernel layout
    replicas: Dict[torch.device, Tuple[torch.Tensor, PlanBank]]

    def shards(self, mesh: BatchMesh
               ) -> List[Tuple[torch.Tensor, PlanBank]]:
        """``(table2, bank)`` for each shard of ``mesh``, copying them
        once to a device the prep holds no replica on yet."""
        with _STREAM_LOCK:
            for dev in mesh.distinct:
                if dev not in self.replicas:
                    arrays = {key: val.to(dev)
                              for key, val in self.bank.arrays.items()}
                    self.replicas[dev] = (self.table2.to(dev),
                                          dataclasses.replace(
                                              self.bank, arrays=arrays))
            return [self.replicas[dev] for dev in mesh.devices]


def _prepare_stream(algorithm: Union[str, Sequence[str]] = "edgaze",
                    grids: Optional[Dict[str, Sequence]] = None, *,
                    soc_node: int = 22, device=None,
                    mesh: Optional[BatchMesh] = None) -> _StreamPrep:
    """Resolve + lower a sweep's variant set once, onto every distinct
    device of ``mesh`` (default: a one-entry mesh on ``device``, which
    is ``cuda`` unless the caller asks for ``"cpu"``)."""
    mesh = resolve_mesh(mesh, device)
    algos = [algorithm] if isinstance(algorithm, str) else list(algorithm)
    labels: List[str] = []
    valgos: List[str] = []
    vnames: List[str] = []
    plans: List[EnergyPlan] = []
    vgrids: List = []
    for algo in algos:
        variants, ngrids = _normalize_grids(algo, grids)
        for variant in variants:
            plans.append(lower_variant(algo, variant, soc_node=soc_node))
            labels.append(variant if len(algos) == 1
                          else f"{algo}/{variant}")
            valgos.append(algo)
            vnames.append(variant)
            vgrids.append(variant_grid(plans[-1], ngrids))
    if not all(g.shape == vgrids[0].shape for g in vgrids):
        raise ValueError(f"variant grids disagree on shape: "
                         f"{[g.shape for g in vgrids]}")
    n_var = len(vgrids[0])
    n_variants = len(plans)
    tables = axis_tables(vgrids)
    _bump("preps")
    device = mesh.devices[0]
    bank = build_plan_bank(plans, device=device)
    table2 = torch.from_numpy(fused_table2(tables)).to(device)
    prep = _StreamPrep(
        algos=algos, labels=labels, valgos=valgos, vnames=vnames,
        vgrids=vgrids, n_var=n_var, n_variants=n_variants,
        total=n_variants * n_var, tables=tables, bank=bank,
        lmax=int(tables.shape[2]), table2=table2,
        replicas={device: (table2, bank)})
    prep.shards(mesh)
    return prep


def best_by_algorithm_summaries(summaries: Dict[str, Dict],
                                default_algo: str) -> Dict[str, Dict]:
    """Per-algorithm best variant from a summaries table.

    Shared by :class:`StreamResult` and ``repro_torch.explore.
    ExploreResult`` (same ``variant`` / ``algo/variant`` label
    convention), so the grouping and tie handling cannot drift.
    """
    groups: Dict[str, Dict[str, Dict]] = {}
    for label, summ in summaries.items():
        algo, _, variant = label.rpartition("/")
        groups.setdefault(algo or default_algo, {})[variant] = summ
    out: Dict[str, Dict] = {}
    for algo, subs in groups.items():
        variant, summ = min(subs.items(),
                            key=lambda kv: kv[1]["metric_min"])
        out[algo] = dict(variant=variant, summary=summ,
                         n_feasible=sum(v["n_feasible"]
                                        for v in subs.values()))
    return out


@dataclasses.dataclass
class StreamResult:
    """Bounded result of a streaming sweep (same fields as the
    reference's ``StreamResult``).

    ``topk`` rows are ascending by the stream metric and carry the exact
    grid axis values (f64, reconstructed from the flat index) plus every
    model output (f32) and the owning ``algorithm`` / ``variant``;
    ``index`` is the variant-local grid index.  ``summaries`` maps variant
    label to ``{n, n_feasible, metric_min, metric_mean, argmin_index,
    argmin_point}`` (mean over feasible points only).  ``dispatches``
    counts superchunk dispatches; ``occupancy`` is valid points /
    dispatched points.  ``backend`` is ``"cuda"`` or ``"torch"``.
    """
    algorithm: str
    metric: str
    k: int
    n_points: int
    n_feasible: int
    n_devices: int
    chunk_size: int
    topk: List[Dict]
    summaries: Dict[str, Dict]
    wall_s: float = 0.0
    compile_s: float = 0.0
    eval_s: float = 0.0
    n_variants: int = 0
    index_lo: int = 0
    index_hi: int = 0
    engine: str = "fused"
    dispatches: int = 0
    superchunk: int = 1
    occupancy: float = 1.0
    n_var: int = 0          # points per variant (flat = slot*n_var + local)
    backend: str = "cuda"
    kernel_mode: str = ""

    def to_payload(self) -> Dict:
        """JSON-serializable form; :meth:`from_payload` round-trips it."""
        out = {f.name: getattr(self, f.name)
               for f in dataclasses.fields(self)}
        out["topk"] = [dict(r) for r in self.topk]
        out["summaries"] = {
            label: dict(sm, argmin_point=(dict(sm["argmin_point"])
                                          if sm["argmin_point"] is not None
                                          else None))
            for label, sm in self.summaries.items()}
        return out

    @classmethod
    def from_payload(cls, payload: Dict) -> "StreamResult":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in payload.items() if k in fields})

    @property
    def points_per_sec(self) -> float:
        """Streaming throughput (prep and kernel build excluded)."""
        return self.n_points / max(self.eval_s, 1e-12)

    def best(self, k: Optional[int] = None) -> List[Dict]:
        """Top-k rows by the stream metric (ascending), feasible only."""
        return self.topk[:k]

    def best_by_algorithm(self) -> Dict[str, Dict]:
        """Per-algorithm best variant by the stream metric:
        ``{algorithm: {"variant", "summary", "n_feasible"}}``; every
        algorithm gets a record (``summary["argmin_point"]`` is None when
        nothing was feasible)."""
        return best_by_algorithm_summaries(self.summaries, self.algorithm)


def _regather_rows(prep: _StreamPrep, win: List[Tuple[int, int]],
                   compute, device) -> np.ndarray:
    """Full output rows ``(n_win, len(OUT_KEYS))`` of the winners,
    through the same coefficient-form compute, one call per variant."""
    out = np.zeros((len(win), len(OUT_KEYS)), np.float32)
    for vi in dict.fromkeys(v for v, _ in win):
        which = [j for j, (v, _) in enumerate(win) if v == vi]
        points = [prep.vgrids[vi].point(win[j][1]) for j in which]
        vals = torch.tensor([[p[ax] for p in points] for ax in AXES],
                            dtype=torch.float32).to(device)
        res = compute(prep.bank.fused[vi], dict(zip(AXES, vals)))
        cols = torch.stack([res[key].to(torch.float32) for key in OUT_KEYS],
                           dim=1)
        out[which] = cols.cpu().numpy()
    return out


def _finalize(prep: _StreamPrep, host: Dict[str, np.ndarray], compute,
              k: int, lo: int, hi: int, device
              ) -> Tuple[int, Dict[str, Dict], List[Dict]]:
    """Materialize the host copy of the reduction state: ``(n_feasible,
    summaries, top-k rows)``.  Per-variant ``n`` is range arithmetic on
    the flat space; the winners' full output rows come from the state's
    ``topk_out`` (staged) or are re-gathered (fused)."""
    n_var = prep.n_var
    n_seen = _variant_span_counts(lo, hi, n_var, prep.n_variants)
    summaries: Dict[str, Dict] = {}
    n_feasible = 0
    for vi, label in enumerate(prep.labels):
        nf = int(host["n_feasible"][vi])
        n_feasible += nf
        amin = int(host["argmin"][vi])
        summaries[label] = dict(
            n=int(n_seen[vi]), n_feasible=nf,
            metric_min=float(host["metric_min"][vi]),
            metric_mean=(float(host["metric_sum"][vi]) / nf if nf
                         else float("nan")),
            argmin_index=amin % n_var if amin >= 0 else -1,
            argmin_point=(prep.vgrids[vi].point(amin % n_var)
                          if amin >= 0 else None))

    n_win = 0
    while n_win < k and np.isfinite(host["topk_v"][n_win]):
        n_win += 1                         # fewer than k feasible points
    win = [divmod(int(host["topk_i"][j]), n_var) for j in range(n_win)]
    topk_out = (host["topk_out"] if "topk_out" in host
                else _regather_rows(prep, win, compute, device))
    rows: List[Dict] = []
    for j, (vi, local) in enumerate(win):
        row = dict(variant=prep.vnames[vi], algorithm=prep.valgos[vi],
                   index=local, **prep.vgrids[vi].point(local))
        row.update({key: float(topk_out[j][c])
                    for c, key in enumerate(OUT_KEYS)})
        rows.append(row)
    return n_feasible, summaries, rows


class _Pacer:
    """Bounds the dispatches in flight on CUDA devices: after each one an
    event is recorded on the current stream of every device in
    ``devices`` (the mesh's distinct devices), and the host waits on the
    oldest dispatch's events once more than ``depth`` are pending (the
    reference blocks on the oldest dispatch's counts,
    ``repro/core/shard_sweep.py:1097-1101``).  On the CPU every dispatch
    has finished when it returns, so nothing is recorded."""

    def __init__(self, devices: Sequence[torch.device], depth: int):
        self.devices = list(devices)
        self.on_cuda = self.devices[0].type == "cuda"
        self.depth = int(depth)
        self.inflight: List[List[torch.cuda.Event]] = []

    def dispatched(self) -> None:
        if not self.on_cuda:
            return
        events = []
        for dev in self.devices:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            events.append(ev)
        self.inflight.append(events)
        if len(self.inflight) > self.depth:
            for ev in self.inflight.pop(0):
                ev.synchronize()


def _stream_impl(algorithm: Union[str, Sequence[str]] = "edgaze",
                 grids: Optional[Dict[str, Sequence]] = None, *,
                 soc_node: int = 22, chunk_size: int = 1 << 18,
                 metric: str = "total_j", k: int = 16,
                 block_points: int = 4096,
                 index_range: Optional[Tuple[int, int]] = None,
                 superchunk: Optional[int] = None, backend: str = "auto",
                 engine: str = "fused", device=None,
                 mesh: Optional[BatchMesh] = None,
                 progress: Optional[Callable[[int, int], None]] = None,
                 pipeline_depth: int = 4,
                 on_partial: Optional[
                     Callable[[int, int, Callable[[], StreamResult]],
                              None]] = None,
                 _prepared: Optional[_StreamPrep] = None) -> StreamResult:
    """Stream a cartesian sweep of any size through the fused megakernel
    (``engine="fused"``) or the staged pipeline (``engine="staged"``).

    ``algorithm`` may be a list: every variant of every algorithm is
    stacked into one PlanBank and interleaved in one variant-major flat
    index space.  ``chunk_size`` is rounded up to a multiple of the mesh
    size and clamped to the per-variant span (so rounded).
    ``index_range=(lo, hi)`` streams only that slice of the flat index
    space.  ``block_points`` is the kernels' reduction block.

    ``mesh`` (a :class:`~repro_torch.launch.mesh.BatchMesh`) splits every
    chunk into ``mesh.size`` shards, shard *i* on ``mesh.devices[i]``;
    without it the sweep runs on ``device`` (default ``"cuda"``) alone.
    A ``device`` beside a ``mesh`` must name the mesh's first device,
    where the state lives.

    Fused: each dispatch covers ``superchunk`` chunk ordinals (default:
    all of them, capped at 16) and launches the megakernel once per LIVE
    ordinal (once a shard: ``mesh.size`` launches); ``backend`` is
    ``"cuda"`` (the CUDA kernel), ``"torch"``
    (the twin) or ``"auto"`` (``cuda`` on a CUDA device, ``torch`` on the
    CPU).  Staged: one dispatch per chunk, chunks aligned to variant
    boundaries; the kernels of the device run (twins on the CPU), so
    ``backend`` must stay ``"auto"``.

    ``progress(done, span)`` fires after every dispatch with the points
    covered so far, computed on the host from the chunk bounds.  On a
    CUDA device each dispatch records an event, and the host waits on
    the oldest once more than ``pipeline_depth`` are in flight, so it
    never runs unboundedly ahead of the card (a wait copies no data).

    ``on_partial(done, span, snapshot)`` is the serve layer's partial
    top-k hook (the reference's, ``repro/core/shard_sweep.py:886-901``):
    it fires alongside ``progress`` after every dispatch, and the zero-arg
    ``snapshot()`` returns the state so far as a :class:`StreamResult`
    (``n_points = done``; top-k rows, summaries, dispatches and occupancy
    as of that dispatch).  A snapshot is a host sync plus the winners'
    re-gather, so callers throttle it; the state is folded in place, so
    ``snapshot()`` works only inside the hook call (later it raises).
    Without a hook the sweep keeps its one host sync.

    ``_prepared`` is the campaign runner's hoist hook: a
    :class:`_StreamPrep` built once (for the mesh) for the SAME
    ``(algorithm, grids, soc_node)`` skips the per-call lowering, bank
    build and table transpose (callers are responsible for that match).
    """
    t_start = time.perf_counter()
    if engine not in ("fused", "staged"):
        raise ValueError(f"unknown engine {engine!r}; "
                         f"valid: ['fused', 'staged']")
    mesh = resolve_mesh(mesh, device)
    device, ndev = mesh.devices[0], mesh.size
    if engine == "staged":
        if backend not in (None, "auto"):
            raise ValueError(
                f"backend={backend!r} requires engine='fused'; the staged "
                f"engine runs the kernels of its device (their twins on "
                f"the CPU)")
        backend = "cuda" if device.type == "cuda" else "torch"
    else:
        backend = resolve_backend(backend, device)
    if metric not in OUT_KEYS:
        raise KeyError(f"unknown stream metric {metric!r}; valid: "
                       f"{list(OUT_KEYS)}")

    t0 = time.perf_counter()
    prep = (_prepared if _prepared is not None
            else _prepare_stream(algorithm, grids, soc_node=soc_node,
                                 mesh=mesh))
    if engine == "fused" and backend == "cuda":
        load_kernel_library()          # first use builds it: set-up time
    n_var, n_variants, total = prep.n_var, prep.n_variants, prep.total
    bank, lmax, table2 = prep.bank, prep.lmax, prep.table2
    shards = prep.shards(mesh)            # (table2, bank) a shard
    chunk = _chunk_geometry(chunk_size, n_var, ndev)
    shard = chunk // ndev
    lo, hi = _validate_index_range(index_range, total)
    # int32 must hold start + chunk - 1 BEFORE tail clamping/masking
    wide = total + chunk >= 2 ** 31
    idx_dtype = torch.int64 if wide else torch.int32

    # a shard keeps its own block and candidates: it holds `shard` points
    bp = max(min(block_points, shard), 1)
    kk = min(k, shard)
    shape = prep.vgrids[0].shape
    state = _init_banked_state(k, n_variants, idx_dtype, device,
                               with_out=engine == "staged")
    dispatches = 0
    s_len = 1

    def result(n_dispatches: int, covered: int) -> StreamResult:
        """The state so far as a StreamResult: the host copy (the sweep's
        one host sync), then O(k + V) host work.  ``covered`` points have
        been reduced; per-variant ``n`` describes the whole ``[lo, hi)``
        the state converges to, as the reference's ``_finalize``."""
        host = {key: val.cpu().numpy() for key, val in state.items()}
        eval_s = time.perf_counter() - t0
        n_feasible, summaries, rows = _finalize(prep, host, step.compute, k,
                                                lo, hi, device)
        dispatched = n_dispatches * s_len * chunk
        return StreamResult(
            algorithm="+".join(prep.algos), metric=metric, k=k,
            n_points=covered, n_feasible=n_feasible, n_devices=ndev,
            chunk_size=chunk, topk=rows, summaries=summaries,
            wall_s=time.perf_counter() - t_start, compile_s=compile_s,
            eval_s=eval_s, n_variants=n_variants, index_lo=lo, index_hi=hi,
            engine=engine, dispatches=n_dispatches, superchunk=s_len,
            occupancy=(covered / dispatched if dispatched else 1.0),
            n_var=n_var, backend=backend, kernel_mode=backend)

    def snapshot(n_dispatches: int, covered: int
                 ) -> Callable[[], StreamResult]:
        """``on_partial``'s snapshot: the state is folded in place, so it
        is read when called, and only before the next dispatch."""
        def take() -> StreamResult:
            if dispatches != n_dispatches:
                raise RuntimeError(
                    "an on_partial snapshot is valid only inside its hook "
                    "call (the next dispatch has folded into the state)")
            return result(n_dispatches, covered)
        return take

    if engine == "fused":
        # chunk ordinals: cpv slots per variant; [c_lo, c_hi) intersect
        # [lo, hi)
        cpv = -(-n_var // chunk)

        def _ordinal(f: int) -> int:
            vi, r = divmod(f, n_var)
            return vi * cpv + r // chunk

        c_lo = _ordinal(lo)
        c_hi = _ordinal(hi - 1) + 1 if hi > lo else c_lo
        n_chunks = max(c_hi - c_lo, 0)
        s_len = (max(1, int(superchunk)) if superchunk
                 else min(max(n_chunks, 1), _DEFAULT_SUPERCHUNK))
        step = _step(
            _fused_key(backend, mesh, chunk, metric, k, block_points,
                       bank.dims, shape, n_var, lmax, s_len, cpv, wide),
            lambda: _fused_step(backend, mesh, bank.dims, metric=metric,
                                shape=shape, n_var=n_var, total=total,
                                shard=shard, lmax=lmax,
                                table_cols=table2.shape[1], bp=bp, kk=kk,
                                idx_dtype=idx_dtype))
        compile_s = time.perf_counter() - t0
        launches = tuple(zip(step.launches, shards))

        t0 = time.perf_counter()
        pace = _Pacer(mesh.distinct, pipeline_depth)
        for d0 in range(c_lo, c_hi, s_len):
            for c in range(d0, min(d0 + s_len, c_hi)):   # dead: nothing
                vi, r = divmod(c, cpv)
                start = vi * n_var + r * chunk
                limit = min(hi, (vi + 1) * n_var)
                # every shard of a live chunk launches, an all-masked
                # tail shard too, as shard_map runs them all
                parts = []
                for i, (launch, (t2, bk)) in enumerate(launches):
                    s0 = start + i * shard
                    cv, cl, sums, counts = launch(t2, bk.fused[vi], s0, lo,
                                                  limit)
                    parts.append(_fold_chunk(cv, cl, sums, counts, s0, bp,
                                             kk, idx_dtype))
                _merge_candidates(_combine_shards(parts, device), vi, state,
                                  k)
            dispatches += 1
            _bump("dispatches")
            pace.dispatched()
            if progress is not None or on_partial is not None:
                vi_l, r_l = divmod(min(d0 + s_len, c_hi) - 1, cpv)
                end = min(vi_l * n_var + (r_l + 1) * chunk,
                          (vi_l + 1) * n_var, hi)
                done = max(end - lo, 0)
                if progress is not None:
                    progress(done, hi - lo)
                if on_partial is not None:
                    on_partial(done, hi - lo, snapshot(dispatches, done))
    else:
        step = _step(
            ("staged", backend, _mesh_key(mesh), chunk, metric, k,
             block_points, tuple(int(d) for d in bank.dims), tuple(shape),
             n_var, lmax, "int64" if wide else "int32"),
            lambda: _Step(eval_uniform=build_banked_eval(bank.dims)[1]))
        compile_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        pace = _Pacer(mesh.distinct, pipeline_depth)
        done = 0
        # chunks are aligned to variant boundaries so each one is
        # variant-uniform (the evaluator reads one coefficient row);
        # `limit` masks both the variant's end and the index_range end
        for vi in range(n_variants):
            vlo = max(lo, vi * n_var)
            vhi = min(hi, (vi + 1) * n_var)
            for start in range(vlo, vhi, chunk):
                parts = [_staged_chunk(
                    prep, step.eval_uniform, start + i * shard, vhi,
                    chunk=shard, bp=bp, kk=kk, metric=metric,
                    idx_dtype=idx_dtype, variant=vi, replica=replica)
                    for i, replica in enumerate(shards)]
                _merge_candidates(_combine_shards(parts, device), vi, state,
                                  k)
                dispatches += 1
                _bump("dispatches")
                pace.dispatched()
                done += min(start + chunk, vhi) - start
                if progress is not None:
                    progress(done, hi - lo)
                if on_partial is not None:
                    on_partial(done, hi - lo, snapshot(dispatches, done))

    return result(dispatches, hi - lo)


def sweep_stream(*_args, **_kwargs):
    """The reference's deprecated ``sweep_stream()`` shim, left out of the
    port on purpose: raises ``NotImplementedError``."""
    raise NotImplementedError(
        "repro_torch does not port the reference's deprecated "
        "sweep_stream() shim (ROADMAP Queue 1, differences kept on "
        "purpose); call repro_torch.explore.explore(DesignSpace(...), "
        "engine='fused' or 'staged') instead")


def pad_points(points: DesignPoints, multiple: int
               ) -> Tuple[DesignPoints, int]:
    """Pad the batch axis up to a multiple by repeating the last point
    (``repro/core/shard_sweep.py:146-159``); returns ``(padded,
    original_batch)``, and callers slice the outputs back."""
    b = points.batch
    pad = (-b) % max(int(multiple), 1)
    if pad == 0:
        return points, b
    return DesignPoints(*(torch.cat([x, x[-1:].expand(pad)])
                          for x in points)), b


def evaluate_batch_sharded(plan: EnergyPlan, points: DesignPoints, *,
                           mesh: Optional[BatchMesh] = None,
                           keep_unit_energies: bool = False,
                           timings: Optional[Dict[str, float]] = None,
                           hooks: Optional[bool] = None
                           ) -> Dict[str, np.ndarray]:
    """``evaluate_batch`` with the batch axis split across a mesh
    (``repro/core/shard_sweep.py:162-188``; default
    :func:`~repro_torch.launch.mesh.make_batch_mesh`, every visible GPU).

    The batch is padded to a multiple of the mesh size and split into
    equal shards, shard *i* scored on ``mesh.devices[i]`` (K4 on a CUDA
    device; :func:`~repro_torch.core.batch.evaluate_split`), and the
    outputs are sliced back to the batch.  Each point's outputs do not
    depend on its shard, so the result equals ``evaluate_batch``'s, and
    a one-entry mesh is ``evaluate_batch`` itself.  ``timings``
    accumulates ``compile_s``/``eval_s`` like ``evaluate_batch``.
    """
    if mesh is None:
        mesh = make_batch_mesh()
    padded, b = pad_points(points, mesh.size)
    out = evaluate_split(plan, padded, mesh.devices,
                         keep_unit_energies=keep_unit_energies,
                         timings=timings, hooks=hooks)
    return {key: val[:b] for key, val in out.items()}
