# Port of src/repro/campaign/runner.py: campaigns run on a torch device
# or a BatchMesh, record the port's lanes ("cuda" / "torch") and refuse
# the reference's.
"""The campaign runner: durable, fault-tolerant mega-sweep execution.

``run_campaign(space, checkpoint_dir)`` turns one ``explore()`` call
into a campaign that survives process death:

1. **Plan** — on first run, a :class:`CampaignManifest` records the
   resolved design-space + plan-bank signatures, provenance (git SHA,
   torch/device fingerprint) and a deterministic split of the flat index
   space into ``index_range`` shards.  On a later run against the same
   directory, the manifest is verified against the provided space and
   only the not-yet-completed ranges are dispatched.
2. **Execute** — shards run ``explore(space, index_range=(lo, hi),
   engine='fused')`` with a FIXED ``superchunk`` through a pluggable
   executor (:mod:`repro_torch.campaign.executor`): ``workers=1``
   (default) dispatches in-process against one shared ``_StreamPrep``,
   bit-identical to straight sweeps of the same ranges, while
   ``workers=N`` feeds the shard queue to N persistent worker processes,
   each with its own CUDA context and ONE stream preparation, folding
   results in arrival order.  The parent builds the kernel libraries
   before it spawns them, so N workers do not run ``nvcc`` at once.
   Completed shards checkpoint through a bounded background writer
   (atomic tmp + fsync + rename, checksummed) so serialization never
   sits between two dispatches; the writer is flushed-and-barriered
   before the merge and ``report.json``.  Failures are classified
   (:func:`classify_failure`): transient -> bounded retry with
   exponential backoff; OOM -> split the shard in half and retry the
   halves; deterministic -> quarantine and continue; a dead WORKER is a
   transient failure of its in-flight shard, never a campaign abort.
3. **Merge** — checkpointed + freshly-computed shard results fold
   through :func:`merge_stream_results` into one result bit-compatible
   (rel 1e-6) with the unsharded sweep, and a ``report.json`` records
   what ran, retried, split and quarantined, plus the parallel/overlap
   accounting (``workers``, ``dispatch_wait_s``, ``io_overlap_frac``).

``resume(manifest_path)`` rebuilds the space from the manifest payload
and re-enters the same machinery — it dispatches ONLY the missing
ranges.  Both entry points refuse (``CampaignMismatchError``) when the
space or bank layout no longer matches the manifest.
"""
from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..ckpt import atomic_write_json
from ..core.shard_sweep import (_DEFAULT_SUPERCHUNK, StreamResult,
                                _prepare_stream)
from ..kernels.runtime import (explicit_backend, load_sweep_kernels,
                               resolve_backend)
from ..launch.mesh import resolve_mesh
from .executor import (CheckpointWriter, ProcessShardExecutor,
                       SerialShardExecutor, ShardTask, _dispatch,
                       resolve_workers)
from .faults import FaultSchedule, KillWorker, classify_failure
from .manifest import (REPORT_NAME, CampaignIntegrityError,
                       CampaignManifest, CampaignMismatchError,
                       completed_shards, missing_ranges, read_shard,
                       shard_path)
from .merge import merge_stream_results, merged_coverage

_DEFAULT_CHUNK = 1 << 18

__all__ = ["CampaignOptions", "run_campaign", "resume", "_dispatch"]


@dataclasses.dataclass
class CampaignOptions:
    """Fault-handling + parallelism knobs for :func:`run_campaign`.

    ``shard_points`` sets the planned shard width (default: four chunks,
    so a shard is a handful of dispatches); ``max_retries`` bounds
    attempts per shard for transient failures, backed off exponentially
    from ``backoff_s``; ``timeout_s`` aborts a shard dispatch that runs
    too long (classified transient); OOM splits recurse down to
    ``min_shard_points`` before quarantining.  ``workers`` sets the
    shard-executor width (None: the ``REPRO_TORCH_CAMPAIGN_WORKERS``
    environment variable, else 1 = serial in-process execution);
    ``workers > 1`` runs shards on persistent worker processes.
    ``faults`` injects a deterministic :class:`FaultSchedule` at shard
    boundaries (tests / drills); ``sleep`` is injectable so backoff is
    testable without wall-clock waits.
    """
    shard_points: Optional[int] = None
    max_retries: int = 3
    backoff_s: float = 0.5
    timeout_s: Optional[float] = None
    min_shard_points: int = 1
    workers: Optional[int] = None
    faults: Optional[FaultSchedule] = None
    sleep: Callable[[float], None] = time.sleep


def _quarantine(directory: str, lo: int, hi: int, *, kind: str,
                error: str, attempts: int) -> Dict:
    entry = {"lo": int(lo), "hi": int(hi), "kind": kind,
             "error": error, "attempts": int(attempts)}
    atomic_write_json(shard_path(directory, lo, hi, quarantined=True),
                      entry)
    return entry


def run_campaign(space, checkpoint_dir: str, *, k: int = 16,
                 metric: str = "total_j", engine: str = "fused",
                 chunk_size: Optional[int] = None,
                 superchunk: Optional[int] = None,
                 block_points: int = 4096, mesh=None,
                 backend: str = "auto",
                 workers: Optional[int] = None,
                 options: Optional[CampaignOptions] = None,
                 on_corrupt: str = "refuse", device=None):
    """Run (or resume) a durable sharded sweep campaign on ``device``
    (``"cuda"`` unless the caller asks for ``"cpu"``), or on ``mesh``
    (a :class:`repro_torch.launch.BatchMesh`: every chunk of every shard
    split across its devices, as the reference's ``mesh=``).

    Returns the same :class:`~repro_torch.explore.api.ExploreResult` an
    unsharded ``explore()`` call would, with the campaign report on
    ``result.campaign``.  Idempotent against ``checkpoint_dir``: a
    directory holding a finished campaign verifies + merges without
    dispatching anything; a partial one dispatches only the missing
    index ranges.  Sweep parameters (``k``/``metric``/``engine``/...)
    are recorded in the manifest on first run and REUSED on resume —
    changing them mid-campaign would make shards unmergeable.  The
    resolved lane is likewise recorded: the fused engine's ``backend``
    (``"cuda"``: the CUDA kernel, ``"torch"``: its twin), the staged
    engine's device lane.  A resume under an explicitly different
    backend (argument or ``REPRO_TORCH_SWEEP_BACKEND``), a staged resume
    on the other lane, and a manifest the reference wrote (``"pallas"``
    / ``"xla"`` or no backend) raise :class:`CampaignMismatchError`
    instead of merging shards computed by different code;
    ``backend="auto"`` on resume reuses the recorded lane.  The mesh's
    size is recorded in the manifest (``torch.n_devices``) and on the
    merged result (``n_devices``); like the worker count it is an
    execution property, so a resume may run on another mesh.

    ``workers`` widens shard execution across that many persistent
    worker processes (argument > ``options.workers`` >
    ``REPRO_TORCH_CAMPAIGN_WORKERS`` env > 1).  The worker count is an
    EXECUTION property, not a campaign property: it is not recorded in
    the manifest, and a serial campaign may be resumed parallel (or
    vice versa) — the merge algebra is partition- and order-independent.

    ``on_corrupt``: ``'refuse'`` (default) raises
    :class:`CampaignIntegrityError` on a checksum-failing shard file;
    ``'redispatch'`` discards it and re-runs that range.
    """
    from ..explore.api import _stream_to_explore
    mesh = resolve_mesh(mesh, device)
    device = mesh.devices[0]
    lane = "cuda" if device.type == "cuda" else "torch"
    if on_corrupt not in ("refuse", "redispatch"):
        raise ValueError(f"on_corrupt must be 'refuse' or 'redispatch', "
                         f"got {on_corrupt!r}")
    opts = options or CampaignOptions()
    if workers is not None and opts.workers is not None \
            and int(workers) != int(opts.workers):
        raise ValueError(
            f"conflicting worker counts: workers={workers} vs "
            f"CampaignOptions.workers={opts.workers} — set one")
    n_workers = resolve_workers(
        workers if workers is not None else opts.workers)
    t0 = time.perf_counter()

    # ----- plan: create or verify the manifest ----------------------------
    resumed = os.path.exists(os.path.join(checkpoint_dir, "manifest.json"))
    if resumed:
        manifest = CampaignManifest.load(checkpoint_dir)
        manifest.verify_space(space)
        manifest.verify_bank(space)
        sweep = manifest.sweep
        # cross-backend resume refusal: shards checkpointed by one lane
        # must not merge with shards computed by the other (parity is
        # rel 1e-6, but campaign merges are asserted bit-compatible),
        # nor with the reference's.  An EXPLICIT request (argument or
        # env) that contradicts the manifest refuses; "auto" reuses the
        # record.
        recorded = sweep.get("backend")
        if recorded not in ("cuda", "torch"):
            raise CampaignMismatchError(
                f"campaign at {checkpoint_dir!r} was recorded with "
                f"backend={recorded!r}, not a lane of repro_torch "
                f"('cuda' / 'torch'): its shards were computed by "
                f"another package and cannot merge with this one's — "
                f"resume it there, or start a fresh checkpoint_dir")
        if sweep["engine"] == "fused":
            requested = explicit_backend(backend)
            if requested not in (None, recorded):
                raise CampaignMismatchError(
                    f"campaign at {checkpoint_dir!r} was recorded with "
                    f"backend={recorded!r} but this resume requests "
                    f"backend={requested!r}; resuming would mix kernels "
                    f"across shards — resume with backend='auto'/"
                    f"{recorded!r}, or start a fresh checkpoint_dir")
            resolve_backend(recorded, device)   # a CPU device refuses cuda
        elif recorded != lane:
            raise CampaignMismatchError(
                f"staged campaign at {checkpoint_dir!r} was recorded on "
                f"the {recorded!r} lane but this resume runs on "
                f"device={str(device)!r} (lane {lane!r}); resuming would "
                f"mix kernels across shards — resume on the recorded "
                f"lane, or start a fresh checkpoint_dir")
    else:
        if engine == "auto":
            engine = "fused"
        if engine not in ("fused", "staged"):
            raise ValueError(f"campaigns need a streaming engine ('fused' "
                             f"or 'staged'), got {engine!r}")
        if engine == "staged":
            if backend not in (None, "auto"):
                raise ValueError(
                    f"backend={backend!r} requires engine='fused'; the "
                    f"staged engine runs the kernels of its device")
            resolved_backend = lane
        else:
            resolved_backend = resolve_backend(backend, device)
        chunk = int(chunk_size or _DEFAULT_CHUNK)
        sweep = {"k": int(k), "metric": metric, "engine": engine,
                 "chunk_size": chunk,
                 # FIXED superchunk: the default would shrink with the
                 # shard's chunk count — pinning it keeps every shard
                 # (including OOM half-shards) on the same dispatches
                 "superchunk": int(superchunk or _DEFAULT_SUPERCHUNK),
                 "block_points": int(block_points),
                 # resolved lane, not "auto": the manifest records what
                 # actually ran so resume can refuse a cross-backend mix
                 "backend": resolved_backend}
        shard_points = int(opts.shard_points or 4 * chunk)
        manifest = CampaignManifest.create(space, sweep=sweep,
                                           shard_points=shard_points,
                                           mesh=mesh)
        manifest.save(checkpoint_dir)

    # ----- load completed shards (verified), derive the work queue --------
    results: List[StreamResult] = []
    loaded: List[Tuple[int, int]] = []
    for (lo, hi), path in sorted(completed_shards(checkpoint_dir).items()):
        try:
            payload = read_shard(path)
        except CampaignIntegrityError:
            if on_corrupt == "refuse":
                raise
            os.remove(path)            # redispatch: range back to queue
            continue
        results.append(StreamResult.from_payload(payload["result"]))
        loaded.append((lo, hi))
    pending = deque(ShardTask(lo, hi) for lo, hi in
                    missing_ranges(manifest.shards, loaded))

    # ----- execute --------------------------------------------------------
    if n_workers > 1 and pending:
        # parallel lane: the parent builds the kernels (one nvcc per
        # source, here, not one per worker) and schedules; workers load
        # them, prepare once each and dispatch
        if device.type == "cuda":
            load_sweep_kernels(sweep["engine"], sweep["backend"])
        executor = ProcessShardExecutor(
            directory=checkpoint_dir, space_sig=manifest.space_sig,
            sweep=sweep, workers=min(n_workers, len(pending)),
            mesh=mesh, timeout_s=opts.timeout_s)
    else:
        # serial lane: one lowering/bank/table build for the WHOLE
        # campaign — every shard (and every OOM half-shard) dispatches
        # against this shared prep, so per-shard fixed cost drops to
        # the O(k) finalization
        prep = (_prepare_stream(list(space.algorithms), space.grids,
                                soc_node=space.soc_node, mesh=mesh)
                if pending else None)
        executor = SerialShardExecutor(space, sweep, mesh, prep,
                                       opts.timeout_s)
    writer = CheckpointWriter(checkpoint_dir)
    executed: List[Dict] = []
    quarantined: List[Dict] = []
    n_retries = n_splits = n_completed = 0
    dispatch_wait_s = 0.0
    done_ranges: Set[Tuple[int, int]] = set()
    graceful = True

    def fail(task: ShardTask, kind: str, error: str) -> None:
        nonlocal n_retries, n_splits
        if kind == "oom" and task.hi - task.lo >= max(
                2, 2 * max(int(opts.min_shard_points), 1)):
            mid = task.lo + (task.hi - task.lo) // 2
            n_splits += 1
            pending.appendleft(ShardTask(mid, task.hi, 1,
                                         task.splits + 1))
            pending.appendleft(ShardTask(task.lo, mid, 1,
                                         task.splits + 1))
        elif kind == "transient" and task.attempt < int(opts.max_retries):
            n_retries += 1
            opts.sleep(float(opts.backoff_s) * 2 ** (task.attempt - 1))
            pending.appendleft(dataclasses.replace(
                task, attempt=task.attempt + 1))
        else:
            quarantined.append(_quarantine(
                checkpoint_dir, task.lo, task.hi, kind=kind, error=error,
                attempts=task.attempt))

    try:
        while pending or executor.n_inflight:
            while pending and executor.idle():
                task = pending.popleft()
                die = False
                if opts.faults is not None:
                    try:
                        opts.faults.check(task.lo, task.hi, task.attempt,
                                          n_completed=n_completed)
                    except BaseException as exc:  # noqa: BLE001
                        kind = classify_failure(exc)
                        if isinstance(exc, KillWorker) \
                                and executor.can_kill_worker:
                            # submit with the die flag: the TARGET worker
                            # SIGKILLs itself with this shard in flight,
                            # exercising the real death/respawn path
                            die = True
                        else:
                            executed.append({
                                "lo": task.lo, "hi": task.hi,
                                "attempt": task.attempt,
                                "status": "fault", "kind": kind,
                                "error": str(exc)})
                            if kind == "kill":
                                raise   # simulated SIGKILL: no cleanup
                            fail(task, kind, str(exc))
                            continue
                executor.submit(task, die=die)
            if executor.n_inflight == 0:
                continue                # every submission faulted
            t0_wait = time.perf_counter()
            out = executor.wait_any()
            dispatch_wait_s += time.perf_counter() - t0_wait
            task = out.task
            if out.ok:
                entry = {"lo": task.lo, "hi": task.hi,
                         "attempt": task.attempt, "status": "ok"}
                if out.worker is not None:
                    entry["worker"] = out.worker
                if (task.lo, task.hi) in done_ranges:
                    # duplicate redelivery (a retried shard whose first
                    # completion was salvaged from a dying worker):
                    # merging is dedup-safe, but don't double-checkpoint
                    entry["duplicate"] = True
                    executed.append(entry)
                    continue
                done_ranges.add((task.lo, task.hi))
                writer.submit(task.lo, task.hi, out.payload,
                              attempts=task.attempt, splits=task.splits)
                results.append(out.result)
                executed.append(entry)
                n_completed += 1
            else:
                entry = {"lo": task.lo, "hi": task.hi,
                         "attempt": task.attempt, "status": "fault",
                         "kind": out.kind, "error": out.error}
                if out.worker is not None:
                    entry["worker"] = out.worker
                executed.append(entry)
                if out.kind == "kill":
                    raise out.exc       # simulated SIGKILL: no cleanup
                fail(task, out.kind, out.error)
    except BaseException as exc:  # noqa: BLE001 - re-raised below
        if classify_failure(exc) == "kill":
            # abrupt teardown: workers are killed, not drained — but the
            # writer still publishes shards that COMPLETED before the
            # kill point, so the drill's on-disk state is deterministic
            graceful = False
        raise
    finally:
        executor.close(graceful=graceful)
        writer.close()                  # flush-and-barrier (never raises)
    writer.raise_if_failed()

    # ----- merge + report -------------------------------------------------
    if not results:
        raise RuntimeError(
            f"campaign produced no completed shards — all "
            f"{len(quarantined)} dispatched ranges quarantined; see "
            f"{os.path.join(checkpoint_dir, 'quarantine')} for errors")
    merged = merge_stream_results(results, k=int(sweep["k"]))
    coverage = merged_coverage(results)
    missing = missing_ranges(manifest.shards, coverage)
    report = {
        "schema": 1, "resumed": resumed,
        "n_planned": len(manifest.shards),
        "n_loaded": len(loaded), "n_executed": len(executed),
        "n_completed": len(results), "n_retries": n_retries,
        "n_splits": n_splits, "executed": executed,
        "quarantined": quarantined,
        "coverage": [[lo, hi] for lo, hi in coverage],
        "missing": [[lo, hi] for lo, hi in missing],
        "partial": bool(missing), "wall_s": time.perf_counter() - t0,
        "workers": n_workers,
        "dispatch_wait_s": round(dispatch_wait_s, 6),
        "io_s": round(writer.io_s, 6),
        "io_overlap_frac": round(writer.io_overlap_frac, 6),
        "worker_startup_s": round(getattr(executor, "startup_s", 0.0), 6),
        # the last stream_cache_info() of each worker (cumulative over
        # its life): one prep a worker, and its kernel launches
        "worker_preps": sorted(
            c["preps"] for c in
            getattr(executor, "worker_counters", {}).values()),
        "worker_counters": {
            str(pid): c for pid, c in
            getattr(executor, "worker_counters", {}).items()},
        # jax / repro modules a worker had loaded (the port loads none)
        "worker_modules": {
            str(pid): mods for pid, mods in
            getattr(executor, "worker_modules", {}).items()},
    }
    atomic_write_json(os.path.join(checkpoint_dir, REPORT_NAME), report)
    return _stream_to_explore(space, merged, campaign=report,
                              device=device)


def resume(manifest_path: str, *, space=None, mesh=None,
           backend: str = "auto", workers: Optional[int] = None,
           options: Optional[CampaignOptions] = None,
           on_corrupt: str = "refuse", device=None):
    """Resume a campaign from its manifest (path or directory).

    Rebuilds the :class:`DesignSpace` from the manifest payload when
    ``space`` is not given, verifies signatures, re-dispatches ONLY the
    index ranges without a verified shard checkpoint, and returns the
    merged result, on ``device`` or ``mesh`` as :func:`run_campaign`.  Raises :class:`CampaignMismatchError` when the
    current code resolves the space or plan-bank layout differently
    from the manifest.
    """
    directory = (manifest_path if os.path.isdir(manifest_path)
                 else os.path.dirname(os.path.abspath(manifest_path)))
    manifest = CampaignManifest.load(manifest_path)
    if space is None:
        space = manifest.rebuild_space()
    return run_campaign(space, directory, mesh=mesh, backend=backend,
                        workers=workers, options=options,
                        on_corrupt=on_corrupt, device=device)
