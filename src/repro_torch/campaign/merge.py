# Verbatim copy of src/repro/campaign/merge.py (loads no jax).
"""Associative merge of sharded StreamResults.

Each campaign shard runs ``explore(space, index_range=(lo, hi))`` and
checkpoints an O(k + V) :class:`~repro.core.shard_sweep.StreamResult`
payload.  This module folds any set of DISJOINT shard results back into
one result equal (rel 1e-6, same guarantees as the engine parity chain)
to the unsharded sweep:

* **top-k** — the global top-k of a union is contained in the union of
  per-shard top-ks (fewer than k points beat a global winner anywhere,
  so fewer than k beat it inside its own shard); merging concatenates
  candidate rows, orders by ``(metric, flat index)`` and truncates.
  The flat index makes tie ordering deterministic and
  partition-independent.
* **summaries** — per-variant ``n`` / ``n_feasible`` are sums,
  ``metric_min`` a min, ``metric_mean`` re-weighted from per-shard
  feasible counts, and the argmin taken from the shard owning the
  smallest min (first shard in index order on exact ties).
* **accounting** — dispatches / wall / compile / eval times sum;
  occupancy re-derives from summed valid vs dispatched points.

The fold is associative and order-independent (results are sorted by
``index_lo`` first), which is what lets a resumed campaign merge
checkpointed shards from a previous process with freshly-computed ones.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..core.shard_sweep import StreamResult


def _check_disjoint(shards: Sequence[StreamResult]) -> None:
    spans = sorted((s.index_lo, s.index_hi) for s in shards)
    for (alo, ahi), (blo, bhi) in zip(spans, spans[1:]):
        if blo < ahi:
            raise ValueError(
                f"shard index ranges overlap: [{alo}, {ahi}) and "
                f"[{blo}, {bhi}) — points would be double-counted; "
                f"merge only disjoint index_range results")


def _dedupe_redelivered(shards: Sequence[StreamResult]
                        ) -> List[StreamResult]:
    """Drop exact-duplicate index ranges, keeping the first in sort
    order.

    A parallel campaign can redeliver a COMPLETED shard (a worker dies
    after finishing, the retry completes again, then the original
    result is salvaged from the dead worker's pipe).  Shard execution
    is deterministic — two completions of the same ``[lo, hi)`` carry
    the same data — so redelivery is idempotent and safe to fold.
    Partially-overlapping ranges are still an error
    (:func:`_check_disjoint`): those points really would double-count.
    """
    seen = set()
    out: List[StreamResult] = []
    for s in shards:
        key = (s.index_lo, s.index_hi)
        if key in seen:
            continue
        seen.add(key)
        out.append(s)
    return out


def merged_coverage(shards: Sequence[StreamResult]
                    ) -> List[Tuple[int, int]]:
    """Sorted union of the shards' covered index ranges."""
    merged: List[List[int]] = []
    for lo, hi in sorted((s.index_lo, s.index_hi) for s in shards):
        if hi <= lo:
            continue
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [(lo, hi) for lo, hi in merged]


def merge_stream_results(shards: Sequence[StreamResult], *,
                         k: Optional[int] = None) -> StreamResult:
    """Fold disjoint shard results into one :class:`StreamResult`.

    ``k`` bounds the merged top-k (default: the shards' k).  Shards must
    agree on metric and variant labels — they come from the same
    campaign plan, which guarantees it.
    """
    if not shards:
        raise ValueError("merge_stream_results needs at least one shard")
    shards = _dedupe_redelivered(
        sorted(shards, key=lambda s: (s.index_lo, s.index_hi)))
    _check_disjoint(shards)
    first = shards[0]
    k = int(k or first.k)
    metrics = {s.metric for s in shards}
    if len(metrics) != 1:
        raise ValueError(f"shards disagree on metric: {sorted(metrics)}")
    labels = list(first.summaries)
    for s in shards[1:]:
        if list(s.summaries) != labels:
            raise ValueError(
                f"shards disagree on variant labels: {labels} vs "
                f"{list(s.summaries)} — not the same design space")

    # summaries insertion order IS the variant-major slot order; a row's
    # flat stream index is slot * n_var + local index.  Single-algorithm
    # sweeps label summaries by bare variant (rows still carry the
    # algorithm), multi-algorithm ones by "algo/variant".
    n_var = max((int(s.n_var) for s in shards), default=0)
    slot_of: Dict[Tuple[str, str], int] = {}
    for i, label in enumerate(labels):
        algo, _, variant = label.rpartition("/")
        slot_of[(algo or first.algorithm, variant)] = i

    # ----- top-k ----------------------------------------------------------
    cand: List[Tuple[float, int, Dict]] = []
    for s in shards:
        for row in s.topk:
            slot = slot_of[(row["algorithm"], row["variant"])]
            flat = slot * n_var + int(row["index"])
            cand.append((float(row[s.metric]), flat, dict(row)))
    cand.sort(key=lambda t: (t[0], t[1]))
    topk = [row for _, _, row in cand[:k]]

    # ----- summaries ------------------------------------------------------
    summaries: Dict[str, Dict] = {}
    for label in labels:
        subs = [(s, s.summaries[label]) for s in shards]
        n = sum(int(sm["n"]) for _, sm in subs)
        nf = sum(int(sm["n_feasible"]) for _, sm in subs)
        msum = sum(float(sm["metric_mean"]) * int(sm["n_feasible"])
                   for _, sm in subs if int(sm["n_feasible"]))
        best = min(subs, key=lambda t: (float(t[1]["metric_min"]),
                                        t[0].index_lo))[1]
        summaries[label] = dict(
            n=n, n_feasible=nf,
            metric_min=float(best["metric_min"]),
            metric_mean=(msum / nf) if nf else float("nan"),
            argmin_index=best["argmin_index"],
            argmin_point=(dict(best["argmin_point"])
                          if best["argmin_point"] is not None else None))

    # ----- accounting -----------------------------------------------------
    n_points = sum(s.n_points for s in shards)
    dispatched = sum((s.n_points / s.occupancy) if s.occupancy else 0.0
                    for s in shards)
    return StreamResult(
        algorithm=first.algorithm, metric=first.metric, k=k,
        n_points=n_points,
        n_feasible=sum(s.n_feasible for s in shards),
        n_devices=first.n_devices, chunk_size=first.chunk_size,
        topk=topk, summaries=summaries,
        wall_s=sum(s.wall_s for s in shards),
        compile_s=sum(s.compile_s for s in shards),
        eval_s=sum(s.eval_s for s in shards),
        n_variants=first.n_variants,
        index_lo=min(s.index_lo for s in shards),
        index_hi=max(s.index_hi for s in shards),
        engine=first.engine,
        dispatches=sum(s.dispatches for s in shards),
        superchunk=max(s.superchunk for s in shards),
        occupancy=(n_points / dispatched) if dispatched else 1.0,
        n_var=n_var, backend=first.backend,
        kernel_mode=first.kernel_mode)
