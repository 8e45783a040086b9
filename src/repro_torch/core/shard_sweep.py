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
Ties break to the lowest flat index everywhere (stable sorts), and flat
indices widen to int64 when ``total + chunk >= 2**31``.  There is no
device mesh and no campaign layer yet (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..kernels.fused_sweep import (COUNTS, fused_sweep_block,
                                   fused_sweep_block_torch,
                                   load_kernel_library, reset_counts)
from ..kernels.grid_decode import grid_decode
from ..kernels.runtime import resolve_backend, resolve_device
from ..kernels.stream_reduce import block_stats
from .axes import AXES
from .batch import (OUT_KEYS, build_banked_eval, build_coeff_compute,
                    points_from_axis_rows)
from .grid import (_normalize_grids, axis_tables, fused_table2,
                   lower_variant, variant_grid)
from .plan import EnergyPlan
from .plan_bank import PlanBank, build_plan_bank

#: default number of chunk ordinals per dispatch
_DEFAULT_SUPERCHUNK = 16

#: superchunk dispatches since the last :func:`stream_cache_clear`
_STATS = {"dispatches": 0}


def stream_cache_info() -> Dict[str, int]:
    """Counters of the streaming engine: CUDA kernel launches, torch-twin
    calls and superchunk dispatches since :func:`stream_cache_clear`."""
    return dict(kernel_launches=COUNTS["kernel_launches"],
                twin_calls=COUNTS["twin_calls"],
                dispatches=_STATS["dispatches"])


def stream_cache_clear() -> None:
    """Zero every counter of :func:`stream_cache_info`."""
    reset_counts()
    _STATS["dispatches"] = 0


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
    vals, pos = torch.sort(cv.reshape(-1), stable=True)
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


def _merge_candidates(c: Dict[str, torch.Tensor], v: int,
                      state: Dict[str, torch.Tensor], k: int) -> None:
    """Fold one chunk's O(k) partials into the running state, in place.

    ``v`` is the chunk's variant slot (host arithmetic).  Every update
    is neutral for an all-masked chunk (counts 0, minimum +inf,
    candidates +inf).  On ties the running top-k keeps its entries ahead
    of the chunk's, so equal values keep the lowest flat index.
    """
    merged_v = torch.cat([state["topk_v"], c["cand_v"]])
    vals, sel = torch.sort(merged_v, stable=True)
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
    state["metric_min"][v] = torch.minimum(old_min, c["mins"])
    state["argmin"][v] = torch.where(c["mins"] < old_min, c["amin_i"],
                                     state["argmin"][v])


def _staged_chunk(prep: "_StreamPrep", eval_uniform, start: int,
                  limit: int, *, chunk: int, bp: int, kk: int, metric: str,
                  idx_dtype) -> Dict[str, torch.Tensor]:
    """One staged chunk ``[start, start + chunk)`` of variant
    ``start // n_var``: decode (K2), the banked evaluator against the
    variant's row, block stats (K3a) and the chunk's top-kk with their
    full output rows.  Points at or past ``limit`` are masked."""
    dev = prep.table2.device
    vals, _vid = grid_decode(prep.table2, start, shape=prep.vgrids[0].shape,
                             n_var=prep.n_var, total=prep.total, chunk=chunk,
                             lmax=prep.lmax, idx_dtype=idx_dtype)
    flat = torch.arange(chunk, dtype=idx_dtype, device=dev) + start
    out = eval_uniform(prep.bank, start // prep.n_var,
                       points_from_axis_rows(vals))
    ok = out["feasible"] & (flat < limit)
    metric_v = out[metric].to(torch.float32)
    mins, amins, sums, counts = block_stats(metric_v, ok, block_points=bp)
    # first-min block wins; tensor indices only, so nothing syncs
    g = torch.argmin(mins).view(1)
    amin_i = (g.to(torch.int32) * bp
              + amins.index_select(0, g)).to(idx_dtype)[0] + start
    # ascending, invalid +inf; the stable sort keeps the lower index on
    # ties, as the reference's lax.top_k
    cand_v, pos = torch.sort(torch.where(ok, metric_v, torch.inf),
                             stable=True)
    pos = pos[:kk]
    return dict(
        cand_v=cand_v[:kk], cand_i=flat[pos],
        cand_out=torch.stack([out[key][pos].to(torch.float32)
                              for key in OUT_KEYS], dim=1),
        mins=mins.index_select(0, g)[0], amin_i=amin_i,
        sums=torch.sum(sums), counts=torch.sum(counts))


@dataclasses.dataclass
class _StreamPrep:
    """Lowered, device-resident sweep inputs (see :func:`_prepare_stream`)."""
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


def _prepare_stream(algorithm: Union[str, Sequence[str]] = "edgaze",
                    grids: Optional[Dict[str, Sequence]] = None, *,
                    soc_node: int = 22, device="cuda") -> _StreamPrep:
    """Resolve + lower a sweep's variant set once, onto ``device``
    (``cuda`` unless the caller asks for ``"cpu"``)."""
    device = resolve_device(device)
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
    return _StreamPrep(
        algos=algos, labels=labels, valgos=valgos, vnames=vnames,
        vgrids=vgrids, n_var=n_var, n_variants=n_variants,
        total=n_variants * n_var, tables=tables,
        bank=build_plan_bank(plans, device=device),
        lmax=int(tables.shape[2]),
        table2=torch.from_numpy(fused_table2(tables)).to(device))


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
    """Bounds the dispatches in flight on a CUDA device: one event is
    recorded after each, and the host waits on the oldest once more than
    ``depth`` are pending (the reference blocks on the oldest dispatch's
    counts, ``repro/core/shard_sweep.py:1097-1101``).  On the CPU every
    dispatch has finished when it returns, so nothing is recorded."""

    def __init__(self, device: torch.device, depth: int):
        self.on_cuda = device.type == "cuda"
        self.depth = int(depth)
        self.device = device
        self.inflight: List[torch.cuda.Event] = []

    def dispatched(self) -> None:
        if not self.on_cuda:
            return
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self.inflight.append(ev)
        if len(self.inflight) > self.depth:
            self.inflight.pop(0).synchronize()


def _stream_impl(algorithm: Union[str, Sequence[str]] = "edgaze",
                 grids: Optional[Dict[str, Sequence]] = None, *,
                 soc_node: int = 22, chunk_size: int = 1 << 18,
                 metric: str = "total_j", k: int = 16,
                 block_points: int = 4096,
                 index_range: Optional[Tuple[int, int]] = None,
                 superchunk: Optional[int] = None, backend: str = "auto",
                 engine: str = "fused", device="cuda",
                 progress: Optional[Callable[[int, int], None]] = None,
                 pipeline_depth: int = 4) -> StreamResult:
    """Stream a cartesian sweep of any size through the fused megakernel
    (``engine="fused"``) or the staged pipeline (``engine="staged"``).

    ``algorithm`` may be a list: every variant of every algorithm is
    stacked into one PlanBank and interleaved in one variant-major flat
    index space.  ``chunk_size`` is clamped to the per-variant span.
    ``index_range=(lo, hi)`` streams only that slice of the flat index
    space.  ``block_points`` is the kernels' reduction block.

    Fused: each dispatch covers ``superchunk`` chunk ordinals (default:
    all of them, capped at 16) and launches the megakernel once per LIVE
    ordinal; ``backend`` is ``"cuda"`` (the CUDA kernel), ``"torch"``
    (the twin) or ``"auto"`` (``cuda`` on a CUDA device, ``torch`` on the
    CPU).  Staged: one dispatch per chunk, chunks aligned to variant
    boundaries; the kernels of the device run (twins on the CPU), so
    ``backend`` must stay ``"auto"``.

    ``progress(done, span)`` fires after every dispatch with the points
    covered so far, computed on the host from the chunk bounds.  On a
    CUDA device each dispatch records an event, and the host waits on
    the oldest once more than ``pipeline_depth`` are in flight, so it
    never runs unboundedly ahead of the card (a wait copies no data).
    """
    t_start = time.perf_counter()
    if engine not in ("fused", "staged"):
        raise ValueError(f"unknown engine {engine!r}; "
                         f"valid: ['fused', 'staged']")
    device = resolve_device(device)
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
    prep = _prepare_stream(algorithm, grids, soc_node=soc_node,
                           device=device)
    if engine == "fused" and backend == "cuda":
        load_kernel_library()          # first use builds it: set-up time
    n_var, n_variants, total = prep.n_var, prep.n_variants, prep.total
    bank, lmax, table2 = prep.bank, prep.lmax, prep.table2
    chunk = min(max(int(chunk_size), 1), n_var)
    lo, hi = _validate_index_range(index_range, total)
    # int32 must hold start + chunk - 1 BEFORE tail clamping/masking
    wide = total + chunk >= 2 ** 31
    idx_dtype = torch.int64 if wide else torch.int32

    compute = build_coeff_compute(bank.dims)
    bp = max(min(block_points, chunk), 1)
    kk = min(k, chunk)
    state = _init_banked_state(k, n_variants, idx_dtype, device,
                               with_out=engine == "staged")
    dispatches = 0
    if engine == "fused":
        kernel = fused_sweep_block if backend == "cuda" \
            else fused_sweep_block_torch
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
        compile_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        pace = _Pacer(device, pipeline_depth)
        for d0 in range(c_lo, c_hi, s_len):
            for c in range(d0, min(d0 + s_len, c_hi)):   # dead: nothing
                vi, r = divmod(c, cpv)
                start = vi * n_var + r * chunk
                limit = min(hi, (vi + 1) * n_var)
                cv, cl, sums, counts = kernel(
                    table2, bank.fused[vi], start, lo, limit,
                    compute=compute, metric=metric, axis_names=AXES,
                    shape=prep.vgrids[0].shape, n_var=n_var, total=total,
                    chunk=chunk, lmax=lmax, block_points=bp, kk=kk,
                    idx_dtype=idx_dtype)
                _merge_candidates(_fold_chunk(cv, cl, sums, counts, start,
                                              bp, kk, idx_dtype),
                                  vi, state, k)
            dispatches += 1
            _STATS["dispatches"] += 1
            pace.dispatched()
            if progress is not None:
                vi_l, r_l = divmod(min(d0 + s_len, c_hi) - 1, cpv)
                end = min(vi_l * n_var + (r_l + 1) * chunk,
                          (vi_l + 1) * n_var, hi)
                progress(max(end - lo, 0), hi - lo)
    else:
        s_len = 1
        _, eval_uniform = build_banked_eval(bank.dims)
        compile_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        pace = _Pacer(device, pipeline_depth)
        done = 0
        # chunks are aligned to variant boundaries so each one is
        # variant-uniform (the evaluator reads one coefficient row);
        # `limit` masks both the variant's end and the index_range end
        for vi in range(n_variants):
            vlo = max(lo, vi * n_var)
            vhi = min(hi, (vi + 1) * n_var)
            for start in range(vlo, vhi, chunk):
                _merge_candidates(_staged_chunk(
                    prep, eval_uniform, start, vhi, chunk=chunk, bp=bp,
                    kk=kk, metric=metric, idx_dtype=idx_dtype),
                    vi, state, k)
                dispatches += 1
                _STATS["dispatches"] += 1
                pace.dispatched()
                done += min(start + chunk, vhi) - start
                if progress is not None:
                    progress(done, hi - lo)

    # ----- the sweep's one host sync, then O(k + V) host work -------------
    host = {key: val.cpu().numpy() for key, val in state.items()}
    eval_s = time.perf_counter() - t0
    n_feasible, summaries, rows = _finalize(prep, host, compute, k, lo, hi,
                                            device)

    dispatched = dispatches * s_len * chunk
    return StreamResult(
        algorithm="+".join(prep.algos), metric=metric, k=k,
        n_points=hi - lo, n_feasible=n_feasible, n_devices=1,
        chunk_size=chunk, topk=rows, summaries=summaries,
        wall_s=time.perf_counter() - t_start, compile_s=compile_s,
        eval_s=eval_s, n_variants=n_variants, index_lo=lo, index_hi=hi,
        engine=engine, dispatches=dispatches, superchunk=s_len,
        occupancy=((hi - lo) / dispatched if dispatched else 1.0),
        n_var=n_var, backend=backend, kernel_mode=backend)


def sweep_stream(*_args, **_kwargs):
    """The reference's deprecated ``sweep_stream()`` shim, left out of the
    port on purpose: raises ``NotImplementedError``."""
    raise NotImplementedError(
        "repro_torch does not port the reference's deprecated "
        "sweep_stream() shim (ROADMAP Queue 1, differences kept on "
        "purpose); call repro_torch.explore.explore(DesignSpace(...), "
        "engine='fused' or 'staged') instead")


def evaluate_batch_sharded(*_args, **_kwargs):
    """The reference's multi-device batch evaluator: not ported yet."""
    raise NotImplementedError(
        "evaluate_batch_sharded is not ported to repro_torch yet (ROADMAP "
        "P8, multi-device sweeps); evaluate_batch runs on one device")
