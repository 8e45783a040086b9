# Port of src/repro/campaign/executor.py: shards run on a BatchMesh;
# workers set up CUDA and load the built kernels themselves.
"""Shard executors: serial, multi-process, and overlapped checkpoint I/O.

The campaign runner (:mod:`repro_torch.campaign.runner`) is a scheduler
over three seams defined here:

* :class:`SerialShardExecutor` — ``workers=1`` (the default): shards
  dispatch in-process against the campaign's shared
  :class:`~repro_torch.core.shard_sweep._StreamPrep`, bit-identical to
  straight sweeps of the same ranges.
* :class:`ProcessShardExecutor` — ``workers=N``: N persistent worker
  processes (``spawn``: CUDA cannot cross a ``fork``; each worker sets
  its CUDA device, loads the kernel libraries the parent built and
  prepares the stream once), each fed ``(lo, hi)`` index ranges over a
  pipe and replying with the O(k + V) ``StreamResult`` payload and its
  :func:`~repro_torch.core.shard_sweep.stream_cache_info` counters.  A
  dead worker (real crash or the
  :class:`~repro_torch.campaign.faults.KillWorker` drill) surfaces as a
  *transient* failure of its in-flight shard — the runner's
  retry/split/quarantine machinery handles it and the pool respawns a
  replacement; worker death is never a campaign abort.
* :class:`CheckpointWriter` — a bounded background thread that runs
  ``write_shard`` (tmp + fsync + rename, checksummed — the atomicity
  contract is untouched) off the dispatch path, so checkpoint
  serialization never sits between two shard dispatches.  ``close()``
  is the flush-and-barrier the runner calls before merging and writing
  ``report.json``.

Workers receive the campaign *directory* plus the manifest's space
signature: each worker re-loads the manifest from disk, refuses on a
signature mismatch, rebuilds the space, and prepares once — so every
worker process makes exactly ONE stream preparation for its whole life
(its ``preps`` counter, reported back with every completed shard and
asserted in the parallel drill).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import signal
import sys
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import torch

from ..core.shard_sweep import StreamResult, _stream_impl
from ..launch.mesh import BatchMesh
from .faults import ShardTimeout, classify_failure
from .manifest import shard_path, write_shard

#: environment override for the default worker count (explore()/
#: CampaignOptions arguments win over the environment)
WORKERS_ENV = "REPRO_TORCH_CAMPAIGN_WORKERS"


def resolve_workers(value=None) -> int:
    """Resolve the worker count: argument > ``REPRO_TORCH_CAMPAIGN_WORKERS``
    > 1."""
    if value is None:
        value = os.environ.get(WORKERS_ENV) or 1
    try:
        n = int(value)
    except (TypeError, ValueError):
        raise ValueError(
            f"workers must be a positive integer, got {value!r} "
            f"(set workers=/CampaignOptions.workers or the "
            f"{WORKERS_ENV} environment variable)") from None
    if n < 1:
        raise ValueError(f"workers must be >= 1, got {n}")
    return n


class _TimeoutRunner:
    """Per-campaign wall-clock budget enforcement for shard dispatches.

    One persistent single-thread pool serves every budgeted dispatch (the
    old per-dispatch ``ThreadPoolExecutor`` leaked its thread whenever a
    timeout abandoned it mid-run).  The pool is replaced only when a
    timeout actually fires — the hung dispatch keeps the old pool's
    thread, which a genuinely stuck sweep would have leaked either way —
    and ``close()`` shuts the current pool down at campaign end.
    """

    def __init__(self):
        self._pool = None

    def run(self, fn, timeout_s: Optional[float], lo: int, hi: int):
        if timeout_s is None:
            return fn()
        import concurrent.futures
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1)
        fut = self._pool.submit(fn)
        try:
            return fut.result(timeout=timeout_s)
        except concurrent.futures.TimeoutError:
            # the worker thread is stuck inside fn(): abandon this pool
            # (a fresh one serves the next dispatch) instead of queueing
            # behind a hung shard
            pool, self._pool = self._pool, None
            pool.shutdown(wait=False, cancel_futures=True)
            raise ShardTimeout(
                f"shard [{lo}, {hi}) exceeded timeout_s={timeout_s}"
            ) from None

    def close(self, wait: bool = True) -> None:
        if self._pool is not None:
            pool, self._pool = self._pool, None
            pool.shutdown(wait=wait)


def _dispatch(space, lo: int, hi: int, sweep: Dict, mesh: BatchMesh,
              timeout_s: Optional[float], prep=None,
              timeouts: Optional[_TimeoutRunner] = None) -> StreamResult:
    """Run one shard's sweep on ``mesh``, optionally under a wall-clock
    budget.

    Goes straight to ``_stream_impl`` (the space was validated when the
    manifest was planned) with the campaign's shared ``_StreamPrep``, so
    a shard dispatch does no variant re-lowering, bank rebuild or table
    transpose: per-shard fixed cost is the O(k) finalization.  The fused
    engine runs the recorded backend (``"cuda"`` or ``"torch"``); the
    staged one the kernels of its device.  A budgeted shard runs on
    another host thread, whose current CUDA device is its own, so the
    shard sets it first (the mesh's first device, where the state
    lives).
    """
    device = mesh.devices[0]
    index = device.index if device.type == "cuda" else None

    def run() -> StreamResult:
        if index is not None:
            torch.cuda.set_device(index)
        return _stream_impl(
            list(space.algorithms), space.grids, soc_node=space.soc_node,
            chunk_size=int(sweep["chunk_size"]), metric=sweep["metric"],
            k=int(sweep["k"]), block_points=int(sweep["block_points"]),
            index_range=(lo, hi), engine=sweep["engine"],
            superchunk=int(sweep["superchunk"]),
            backend=(sweep["backend"] if sweep["engine"] == "fused"
                     else "auto"),
            mesh=mesh, _prepared=prep)

    if timeout_s is None:
        return run()
    if timeouts is None:
        timeouts = _TimeoutRunner()
        try:
            return timeouts.run(run, timeout_s, lo, hi)
        finally:
            timeouts.close(wait=False)
    return timeouts.run(run, timeout_s, lo, hi)


@dataclasses.dataclass(frozen=True)
class ShardTask:
    """One unit of campaign work: ``[lo, hi)`` on its ``attempt``-th try."""
    lo: int
    hi: int
    attempt: int = 1
    splits: int = 0


@dataclasses.dataclass
class ShardOutcome:
    """What came back for one submitted :class:`ShardTask`."""
    task: ShardTask
    ok: bool
    result: Optional[StreamResult] = None   # serial path: the live object
    payload: Optional[Dict] = None          # to_payload form (checkpoint)
    kind: Optional[str] = None              # failure class (classify_failure)
    error: Optional[str] = None
    exc: Optional[BaseException] = None     # serial path only (kill re-raise)
    counters: Optional[Dict] = None         # worker's stream_cache_info()
    worker: Optional[int] = None            # worker pid (parallel only)


# ---------------------------------------------------------------------------
# Overlapped checkpoint I/O
# ---------------------------------------------------------------------------
class CheckpointWriter:
    """Bounded background shard-checkpoint writer.

    ``submit()`` enqueues one completed shard's payload; a single daemon
    thread runs :func:`~repro_torch.campaign.manifest.write_shard` (atomic
    tmp + fsync + rename, checksummed — unchanged) so serialization and
    fsync latency overlap the next dispatch instead of serializing the
    campaign.  The queue is bounded: a slow disk backpressures the
    scheduler rather than buffering unbounded payloads.

    Write failures are captured, surfaced on the next ``submit()`` /
    ``raise_if_failed()``, and never deadlock the flush.  ``close()``
    is idempotent, never raises, and is the campaign-end barrier: after
    it returns, every accepted write has been published (or recorded as
    failed) — call ``raise_if_failed()`` afterwards on the success path.
    """

    def __init__(self, directory: str, *, capacity: int = 8):
        self.directory = directory
        self._q: "queue.Queue" = queue.Queue(max(int(capacity), 1))
        self._error: Optional[BaseException] = None
        self.n_writes = 0
        self.io_s = 0.0          # thread time spent inside write_shard
        self.blocked_s = 0.0     # scheduler time lost to the writer
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, name="campaign-ckpt-writer", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            lo, hi, payload, attempts, splits = item
            t0 = time.perf_counter()
            try:
                write_shard(self.directory, lo, hi, payload,
                            attempts=attempts, splits=splits)
                self.n_writes += 1
                qpath = shard_path(self.directory, lo, hi,
                                   quarantined=True)
                if os.path.exists(qpath):   # range recovered on this run
                    os.remove(qpath)
            except BaseException as exc:  # noqa: BLE001 - surfaced on flush
                if self._error is None:
                    self._error = exc
            finally:
                self.io_s += time.perf_counter() - t0
                self._q.task_done()

    def submit(self, lo: int, hi: int, payload: Dict, *,
               attempts: int = 1, splits: int = 0) -> None:
        self.raise_if_failed()
        if self._closed:
            raise RuntimeError("CheckpointWriter is closed")
        t0 = time.perf_counter()
        self._q.put((int(lo), int(hi), payload, int(attempts),
                     int(splits)))
        # a put that blocked on the bounded queue is I/O the campaign
        # did NOT overlap — counted against io_overlap_frac
        self.blocked_s += time.perf_counter() - t0

    def flush(self) -> None:
        """Barrier: block until every accepted write has completed."""
        t0 = time.perf_counter()
        self._q.join()
        self.blocked_s += time.perf_counter() - t0

    def close(self) -> None:
        """Flush + stop the writer thread.  Idempotent; never raises."""
        if self._closed:
            return
        self._closed = True
        self.flush()
        self._q.put(None)
        self._thread.join()

    def raise_if_failed(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    @property
    def io_overlap_frac(self) -> float:
        """Fraction of checkpoint I/O time hidden behind dispatch."""
        if self.io_s <= 0.0:
            return 1.0
        return max(0.0, min(1.0, 1.0 - self.blocked_s / self.io_s))


# ---------------------------------------------------------------------------
# Serial executor (workers=1 — the default, pre-parallel code path)
# ---------------------------------------------------------------------------
class SerialShardExecutor:
    """In-process shard execution: ``submit()`` runs the dispatch
    synchronously (so the scheduler's ``wait_any`` accounting measures
    genuine idle time, which is zero here) and ``wait_any()`` hands the
    stored outcome back."""

    can_kill_worker = False

    def __init__(self, space, sweep: Dict, mesh: BatchMesh, prep,
                 timeout_s: Optional[float]):
        self._space, self._sweep, self._mesh = space, sweep, mesh
        self._prep, self._timeout_s = prep, timeout_s
        self._timeouts = _TimeoutRunner()
        self._done: Deque[ShardOutcome] = deque()

    @property
    def n_inflight(self) -> int:
        return len(self._done)

    def idle(self) -> bool:
        return not self._done

    def submit(self, task: ShardTask, *, die: bool = False) -> None:
        try:
            st = _dispatch(self._space, task.lo, task.hi, self._sweep,
                           self._mesh, self._timeout_s, prep=self._prep,
                           timeouts=self._timeouts)
        except BaseException as exc:  # noqa: BLE001 - classified for the runner
            self._done.append(ShardOutcome(
                task=task, ok=False, kind=classify_failure(exc),
                error=str(exc), exc=exc))
        else:
            self._done.append(ShardOutcome(
                task=task, ok=True, result=st, payload=st.to_payload()))

    def wait_any(self) -> ShardOutcome:
        return self._done.popleft()

    def close(self, graceful: bool = True) -> None:
        self._timeouts.close(wait=graceful)


# ---------------------------------------------------------------------------
# Multi-process executor
# ---------------------------------------------------------------------------
def _worker_main(conn, init: Dict) -> None:
    """Worker-process entry point (spawned: no CUDA state inherited).

    Sets up its device (:func:`~repro_torch.kernels.runtime.
    init_worker_process`: the mesh's first CUDA device, the kernel
    libraries; a CUDA device without a GPU fails the start-up), rebuilds
    the campaign's mesh from its devices, loads the
    campaign manifest from disk, refuses if its space signature differs from the
    one the parent planned against, prepares the stream ONCE, then
    serves ``("run", lo, hi, die)`` requests until ``("stop",)``.
    ``die=True`` SIGKILLs the process on receipt — the deterministic
    stand-in for a worker crashing with the shard in flight (see
    :class:`~repro_torch.campaign.faults.KillWorker`).  The ready
    message lists the ``jax*`` / ``repro*`` modules the worker loaded
    (none: the port stands alone).
    """
    try:
        from ..core.shard_sweep import _prepare_stream, stream_cache_info
        from ..kernels.runtime import init_worker_process
        from .manifest import CampaignManifest, CampaignMismatchError
        sweep = dict(init["sweep"])
        init_worker_process(init["devices"][0], sweep["engine"],
                            sweep["backend"])
        mesh = BatchMesh(init["devices"])
        manifest = CampaignManifest.load(init["directory"])
        if manifest.space_sig != init["space_sig"]:
            raise CampaignMismatchError(
                f"worker loaded a manifest with space signature "
                f"{manifest.space_sig[:12]}… but the campaign scheduler "
                f"planned {init['space_sig'][:12]}… — the manifest on "
                f"disk changed under the running campaign")
        space = manifest.rebuild_space()
        manifest.verify_space(space)
        prep = _prepare_stream(list(space.algorithms), space.grids,
                               soc_node=space.soc_node, mesh=mesh)
        timeouts = _TimeoutRunner()
    except BaseException as exc:  # noqa: BLE001 - reported to the parent
        try:
            conn.send(("init-error",
                       f"{type(exc).__name__}: {exc}"))
        finally:
            return
    conn.send(("ready", os.getpid(),
               sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "repro"))))
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            break
        if msg[0] == "stop":
            break
        _, lo, hi, die = msg
        if die:
            os.kill(os.getpid(), signal.SIGKILL)
        try:
            st = _dispatch(space, lo, hi, sweep, mesh,
                           init["timeout_s"], prep=prep,
                           timeouts=timeouts)
        except BaseException as exc:  # noqa: BLE001 - classified here
            conn.send(("err", lo, hi, classify_failure(exc),
                       f"{type(exc).__name__}: {exc}"))
            continue
        conn.send(("ok", lo, hi, st.to_payload(), stream_cache_info()))
    timeouts.close(wait=False)


@contextlib.contextmanager
def _suppress_child_main_reimport():
    """Keep spawned workers from re-importing the parent's ``__main__``.

    ``multiprocessing``'s spawn preparation records the parent's main
    module (by spec name or file path) and re-runs it in the child
    before unpickling the target.  Our worker target is a module-level
    function resolved by import path — the child never needs the
    parent's main — so that re-import is pure startup cost at best and
    a hard failure at worst (a ``python - <<EOF`` / REPL parent has no
    re-runnable main file).  Hiding ``__spec__``/``__file__`` for the
    duration of ``Process.start()`` makes spawn skip the fixup.
    """
    main = sys.modules.get("__main__")
    if main is None:
        yield
        return
    # spawn reads __spec__ unconditionally (must stay present, None
    # means "no module spec") but __file__ through a getattr default
    had_spec = hasattr(main, "__spec__")
    saved_spec = getattr(main, "__spec__", None)
    had_file = hasattr(main, "__file__")
    saved_file = getattr(main, "__file__", None)
    main.__spec__ = None
    if had_file:
        del main.__file__
    try:
        yield
    finally:
        if had_spec:
            main.__spec__ = saved_spec
        elif hasattr(main, "__spec__"):
            del main.__spec__
        if had_file:
            main.__file__ = saved_file


class _WorkerHandle:
    __slots__ = ("proc", "conn", "task", "ready")

    def __init__(self, proc, conn):
        self.proc, self.conn = proc, conn
        self.task: Optional[ShardTask] = None
        self.ready = False


class ProcessShardExecutor:
    """N persistent worker processes fed shards over pipes.

    The parent never blocks on a specific worker: ``wait_any`` multiplexes
    every worker pipe plus every process sentinel, returns completions in
    ARRIVAL order, and turns a dead worker into a transient failure of
    its in-flight shard (salvaging any result it managed to send first)
    while respawning a replacement.  Repeated deaths *during startup*
    (before any worker ever reported ready) abort — that is a broken
    environment, not a transient fault.
    """

    can_kill_worker = True

    def __init__(self, *, directory: str, space_sig: str, sweep: Dict,
                 workers: int, mesh: BatchMesh,
                 timeout_s: Optional[float] = None):
        import multiprocessing
        self._ctx = multiprocessing.get_context("spawn")
        self._init = {
            "directory": os.path.abspath(directory),
            "space_sig": space_sig,
            "sweep": dict(sweep),
            # the reference sends the mesh's size and rebuilds the mesh
            # over the worker's first devices; the port sends the mesh's
            # devices, so a mesh that repeats a device crosses too
            "devices": [str(d) for d in mesh.devices],
            "timeout_s": timeout_s,
        }
        self._workers: List[_WorkerHandle] = []
        self._pending: Deque[ShardOutcome] = deque()
        self._early_deaths = 0
        self._any_ready = False
        #: the last stream_cache_info() counters each worker pid reported
        #: (cumulative over the worker's life: its ``preps`` stays 1)
        self.worker_counters: Dict[int, Dict] = {}
        #: jax / repro modules each worker had loaded when it reported
        #: ready
        self.worker_modules: Dict[int, List[str]] = {}
        #: wall time from pool creation until the LAST initial worker
        #: reported ready (fresh interpreter + torch + CUDA set-up +
        #: kernel load + prep per worker) — a per-campaign constant that
        #: amortizes over campaign length; reported so benches can
        #: separate steady-state shard throughput from pool spin-up
        self.startup_s = 0.0
        self._n_initial = max(int(workers), 1)
        self._n_ready = 0
        self._t_created = time.perf_counter()
        for _ in range(self._n_initial):
            self._spawn_one()

    # ----- pool management ------------------------------------------------
    def _spawn_one(self) -> _WorkerHandle:
        parent_conn, child_conn = self._ctx.Pipe()
        proc = self._ctx.Process(target=_worker_main,
                                 args=(child_conn, self._init),
                                 daemon=True)
        with _suppress_child_main_reimport():
            proc.start()
        child_conn.close()
        w = _WorkerHandle(proc, parent_conn)
        self._workers.append(w)
        return w

    @property
    def n_inflight(self) -> int:
        return (sum(1 for w in self._workers if w.task is not None)
                + len(self._pending))

    def idle(self) -> bool:
        return any(w.task is None for w in self._workers)

    # ----- submission -----------------------------------------------------
    def submit(self, task: ShardTask, *, die: bool = False) -> None:
        for w in self._workers:
            if w.task is None:
                w.task = task
                try:
                    w.conn.send(("run", int(task.lo), int(task.hi),
                                 bool(die)))
                except (BrokenPipeError, OSError):
                    self._reap(w)       # died before the send: retryable
                return
        raise RuntimeError("submit() called with no idle worker")

    # ----- completion -----------------------------------------------------
    def wait_any(self) -> ShardOutcome:
        from multiprocessing import connection as mpc
        while True:
            if self._pending:
                return self._pending.popleft()
            handles = []
            by_handle = {}
            for w in self._workers:
                handles.append(w.conn)
                by_handle[w.conn] = w
                handles.append(w.proc.sentinel)
                by_handle[w.proc.sentinel] = w
            ready = mpc.wait(handles)
            # drain messages before acting on sentinels: a worker that
            # completed its shard and then died still delivers the result
            seen = []
            for h in ready:
                w = by_handle[h]
                if w in seen:
                    continue
                seen.append(w)
                if w.conn.poll():
                    try:
                        msg = w.conn.recv()
                    except (EOFError, OSError):
                        self._reap(w)
                        continue
                    self._on_message(w, msg)
                elif not w.proc.is_alive():
                    self._reap(w)

    def _on_message(self, w: _WorkerHandle, msg) -> None:
        tag = msg[0]
        if tag == "ready":
            self.worker_modules[msg[1]] = msg[2]
            w.ready = True
            self._any_ready = True
            self._early_deaths = 0
            if self._n_ready < self._n_initial:
                self._n_ready += 1
                self.startup_s = time.perf_counter() - self._t_created
            return
        if tag == "init-error":
            raise RuntimeError(
                f"campaign worker failed to initialize: {msg[1]}")
        _, lo, hi, *rest = msg
        task, w.task = w.task, None
        if tag == "ok":
            payload, counters = rest
            pid = w.proc.pid
            self.worker_counters[pid] = dict(counters)
            self._pending.append(ShardOutcome(
                task=task, ok=True,
                result=StreamResult.from_payload(payload),
                payload=payload, counters=dict(counters), worker=pid))
        else:  # "err"
            kind, error = rest
            self._pending.append(ShardOutcome(
                task=task, ok=False, kind=kind, error=error,
                worker=w.proc.pid))

    def _reap(self, w: _WorkerHandle) -> None:
        """Handle a dead worker: salvage, classify the loss, respawn."""
        if w not in self._workers:
            return
        # salvage any complete message the worker sent before dying
        try:
            while w.conn.poll():
                self._on_message(w, w.conn.recv())
        except (EOFError, OSError):
            pass
        self._workers.remove(w)
        w.proc.join(timeout=5)
        w.conn.close()
        if w.task is not None:
            self._pending.append(ShardOutcome(
                task=w.task, ok=False, kind="transient",
                error=(f"worker pid {w.proc.pid} died "
                       f"(exit {w.proc.exitcode}) with shard "
                       f"[{w.task.lo}, {w.task.hi}) in flight"),
                worker=w.proc.pid))
        elif not w.ready and not self._any_ready:
            self._early_deaths += 1
            if self._early_deaths > len(self._workers) + 2:
                raise RuntimeError(
                    f"campaign workers keep dying during startup (last "
                    f"exit {w.proc.exitcode}) — the worker environment "
                    f"cannot run the sweep; run with workers=1 to see "
                    f"the underlying error inline")
        self._spawn_one()

    # ----- teardown -------------------------------------------------------
    def close(self, graceful: bool = True) -> None:
        workers, self._workers = self._workers, []
        for w in workers:
            if graceful and w.proc.is_alive():
                try:
                    w.conn.send(("stop",))
                except (BrokenPipeError, OSError):
                    pass
        for w in workers:
            w.proc.join(timeout=10 if graceful else 0.1)
            if w.proc.is_alive():
                w.proc.kill()
                w.proc.join(timeout=5)
            w.conn.close()

