"""Exploration-as-a-service: a long-lived multi-tenant explore() front.

:class:`ExploreService` owns one dispatch worker thread, a bounded
request queue, a result cache and the coalescing scheduler, and serves
concurrent ``explore()``-shaped requests on ONE device (``cuda`` unless
the caller asks for ``cpu``) or on one
:class:`~repro_torch.launch.mesh.BatchMesh` (``mesh=``; the state of
each request lives on the mesh's first device), as the reference's
``repro.serve.ExploreService`` does on its mesh:

* **submit** (:meth:`submit` / :meth:`asubmit`) is non-blocking: it
  validates the request, resolves the lane (``"cuda"``: the hand-written
  kernels; ``"torch"``: their twins), and enqueues a
  :class:`ServeHandle` — or refuses with :class:`QueueFull` when the
  bounded queue is at capacity (backpressure, never silent loss);
* the worker drains the queue in batches (a short **coalesce window**
  gathers whatever arrives together), probes the **result cache**,
  dedupes identical in-flight requests, groups the rest by dispatch
  compatibility (:func:`repro_torch.serve.coalesce.compat_key`) and runs
  each group through ONE shared step on K1 — incompatible requests fall
  back to solo dispatch, never an error; ``staged`` and the grid engines
  run as one inline ``explore()`` on the worker (K2 and K3a, or K4);
* tenants either **block** for the final :class:`ExploreResult`
  (:meth:`ServeHandle.result`, or the drop-in
  ``explore(space, service=svc)`` path) or **stream** converging top-k
  snapshots as their superchunks land (:meth:`ServeHandle.partials` /
  :meth:`apartials`);
* :meth:`close` stops intake immediately and, by default, **drains**
  every queued request before the worker exits; ``drain=False`` fails
  the backlog with :class:`ServiceClosed` instead.

The worker is a host thread, and a host thread's current CUDA device is
its own: the worker makes the service's device current before its first
dispatch.  A kernel is built at its first use; if that fails, the
request fails (there is no fallback to the twins or to the CPU).  The
asyncio front end (:meth:`aexplore` & co.) adapts the same worker via
executor threads, so an async gateway can multiplex tenants without a
second scheduler.
"""
from __future__ import annotations

import asyncio
import dataclasses
import functools
import queue
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch

from ..explore.api import (ENGINES, ExploreResult, _stream_to_explore,
                           _validate_request, explore)
from ..explore.space import DesignSpace
from ..kernels.runtime import resolve_backend
from ..launch.mesh import BatchMesh, resolve_mesh
from .cache import ResultCache, result_cache_key
from .coalesce import GroupMember, compat_key, prepare_request, run_group, \
    run_solo
from .errors import QueueFull, RequestTimeout, ServiceClosed
from .metrics import ServiceMetrics, TenantMetrics
from .stream import PartialEmitter, PartialUpdate, TenantStream

__all__ = ["ExploreService", "ServeHandle"]

#: engines the coalescing scheduler handles natively; anything else goes
#: through the direct solo fallback (one inline explore() in the worker)
_STREAMING = ("auto", "fused")


@dataclasses.dataclass
class ServeHandle:
    """One submitted request: its parameters, stream, and outcome."""
    request_id: int
    space: DesignSpace
    k: int
    metric: str
    engine: str
    chunk_size: Optional[int]
    block_points: int
    superchunk: Optional[int]
    backend: str                       #: resolved lane
    stream: TenantStream
    want_stream: bool
    #: absolute ``time.perf_counter()`` deadline, or None
    deadline: Optional[float]
    t_submit: float
    _wait_s: float = 0.0               #: queue wait, stamped at drain
    _event: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    _result: Optional[ExploreResult] = None
    _error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> ExploreResult:
        """Block for the final result (re-raises service-side failures;
        :class:`RequestTimeout` if ``timeout`` elapses first)."""
        if not self._event.wait(timeout):
            raise RequestTimeout(
                f"request {self.request_id} not complete within "
                f"{timeout}s (still queued or dispatching)")
        if self._error is not None:
            raise self._error
        return self._result

    def partials(self) -> Iterator[PartialUpdate]:
        """Iterate streamed partial top-k updates until the final one
        (present exactly once even for non-streaming submits)."""
        return iter(self.stream)


class ExploreService:
    """Multi-tenant exploration service (see module docstring).

    Parameters
    ----------
    max_queue:
        Bound on queued (not-yet-draining) requests; submits beyond it
        raise :class:`QueueFull`.
    coalesce_window_s:
        How long the worker waits, after the first request of a batch,
        for more requests to coalesce with.  Latency floor for cold
        requests; 0 disables batching across submit gaps.
    max_batch:
        Largest batch drained per window.
    cache_capacity / cache_ttl_s:
        Result-cache bounds (LRU entries / seconds; ``ttl_s=None`` means
        no aging).
    default_timeout_s:
        Deadline applied to requests that don't pass ``timeout_s``.
    partial_interval_s:
        Minimum seconds between streamed partial updates per tenant
        (snapshots are host syncs; this is the throttle).
    device:
        Where every request runs (default ``"cuda"``; ``"cpu"`` runs the
        twins).  Without a GPU a CUDA service raises.
    mesh:
        A :class:`~repro_torch.launch.mesh.BatchMesh` every request's
        chunks split across, in place of ``device`` (which may then be
        left out or name the mesh's first device).
    """

    _SHUTDOWN = object()

    def __init__(self, *, max_queue: int = 64,
                 coalesce_window_s: float = 0.01, max_batch: int = 32,
                 cache_capacity: int = 128,
                 cache_ttl_s: Optional[float] = None,
                 default_timeout_s: Optional[float] = None,
                 partial_interval_s: float = 0.05, device=None,
                 mesh: Optional[BatchMesh] = None):
        if int(max_queue) < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self._mesh = resolve_mesh(mesh, device)
        self._device = self._mesh.devices[0]
        self._queue: "queue.Queue" = queue.Queue(maxsize=int(max_queue))
        self._window = max(float(coalesce_window_s), 0.0)
        self._max_batch = max(int(max_batch), 1)
        self._default_timeout_s = default_timeout_s
        self._partial_interval_s = float(partial_interval_s)
        self.cache = ResultCache(capacity=cache_capacity,
                                 ttl_s=cache_ttl_s)
        self.metrics_ = ServiceMetrics()
        self._closed = False
        self._aborted = False
        self._lock = threading.Lock()
        self._next_id = 0
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="repro-torch-serve-worker")
        self._worker.start()

    # ----- lifecycle ------------------------------------------------------
    def __enter__(self) -> "ExploreService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def device(self) -> torch.device:
        """The device every request's state lives on (a CUDA device with
        its index): the mesh's first."""
        return self._device

    @property
    def mesh(self) -> BatchMesh:
        """The mesh every request runs on (one entry without ``mesh=``)."""
        return self._mesh

    def close(self, *, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop intake; by default finish every queued request first.

        ``drain=False`` fails the backlog with :class:`ServiceClosed`
        instead of running it.  Idempotent; blocks until the worker
        exits (or ``timeout``).
        """
        with self._lock:
            first = not self._closed
            self._closed = True
            if not drain:
                self._aborted = True
        if first:
            self._queue.put(self._SHUTDOWN)
        self._worker.join(timeout)

    # ----- front end ------------------------------------------------------
    def _lane(self, engine: str, backend: str) -> str:
        """The request's resolved lane (the cache key's).  The staged
        engine runs the kernels of its device, so it takes no explicit
        lane, as ``explore(engine="staged")`` takes none."""
        if engine != "staged":
            return resolve_backend(backend, self._device)
        if backend not in (None, "auto"):
            raise ValueError(
                f"backend={backend!r} requires engine='fused'; the staged "
                f"engine runs the kernels of its device (their twins on "
                f"the CPU)")
        return "cuda" if self._device.type == "cuda" else "torch"

    def submit(self, space: DesignSpace, *, k: int = 16,
               metric: str = "total_j", engine: str = "auto",
               chunk_size: Optional[int] = None,
               block_points: int = 4096,
               superchunk: Optional[int] = None, backend: str = "auto",
               timeout_s: Optional[float] = None,
               stream: bool = False) -> ServeHandle:
        """Enqueue a request; returns immediately with its handle.

        ``stream=True`` turns on partial top-k updates on
        ``handle.partials()`` (throttled to ``partial_interval_s``);
        otherwise the stream carries just the single final update.
        """
        if not isinstance(space, DesignSpace):
            raise TypeError(f"submit() takes a DesignSpace, got "
                            f"{type(space).__name__}")
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; valid: "
                             f"{list(ENGINES)}")
        _validate_request(k, chunk_size)
        if timeout_s is None:
            timeout_s = self._default_timeout_s
        if timeout_s is not None and float(timeout_s) <= 0:
            raise ValueError(f"timeout_s must be > 0 or None, "
                             f"got {timeout_s}")
        if self._closed:
            raise ServiceClosed("service is closed; not accepting "
                                "requests")
        lane = self._lane(engine, backend)
        now = time.perf_counter()
        with self._lock:
            rid = self._next_id
            self._next_id += 1
        handle = ServeHandle(
            request_id=rid, space=space, k=int(k), metric=metric,
            engine=engine, chunk_size=chunk_size,
            block_points=int(block_points), superchunk=superchunk,
            backend=lane, stream=TenantStream(), want_stream=bool(stream),
            deadline=None if timeout_s is None
            else now + float(timeout_s), t_submit=now)
        try:
            self._queue.put_nowait(handle)
        except queue.Full:
            self.metrics_.bump("rejected")
            raise QueueFull(
                f"request queue at capacity "
                f"({self._queue.maxsize}); retry later or raise "
                f"max_queue") from None
        self.metrics_.bump("submitted")
        return handle

    def explore(self, space: DesignSpace, **kw) -> ExploreResult:
        """Blocking request/response — the ``explore(service=svc)``
        delegate.  Accepts :meth:`submit` keywords."""
        return self.submit(space, **kw).result()

    def metrics(self) -> Dict:
        """Service-wide counter snapshot (+ cache stats, queue depth)."""
        return self.metrics_.snapshot(cache=self.cache.stats(),
                                      queue_depth=self._queue.qsize())

    # ----- asyncio front end ---------------------------------------------
    async def aexplore(self, space: DesignSpace, **kw) -> ExploreResult:
        """``await``-able :meth:`explore` (executor-threaded wait)."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, functools.partial(self.explore, space, **kw))

    async def asubmit(self, space: DesignSpace, **kw) -> ServeHandle:
        """``await``-able :meth:`submit` (already non-blocking; kept
        async for a uniform gateway surface)."""
        return self.submit(space, **kw)

    async def aresult(self, handle: ServeHandle,
                      timeout: Optional[float] = None) -> ExploreResult:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, functools.partial(handle.result, timeout))

    async def apartials(self, handle: ServeHandle):
        """Async generator over a handle's partial updates."""
        loop = asyncio.get_running_loop()
        while True:
            item = await loop.run_in_executor(None, handle.stream.get)
            if item is TenantStream._DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    # ----- worker side ----------------------------------------------------
    def _run(self) -> None:
        if self._device.type == "cuda":
            # this thread's current device is its own: without this the
            # kernels' launch path would switch devices on every call
            torch.cuda.set_device(self._device.index)
        while True:
            item = self._queue.get()
            if item is self._SHUTDOWN:
                return
            if self._aborted:
                self._fail(item, ServiceClosed(
                    "service closed before this request was served"))
                continue
            batch: List[ServeHandle] = [item]
            stop = False
            t_end = time.monotonic() + self._window
            while len(batch) < self._max_batch:
                rem = t_end - time.monotonic()
                if rem <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=rem)
                except queue.Empty:
                    break
                if nxt is self._SHUTDOWN:
                    stop = True
                    break
                batch.append(nxt)
            try:
                self._process_batch(batch)
            except Exception as exc:  # noqa: BLE001 - fail, don't die
                for req in batch:
                    self._fail(req, exc)
            if stop:
                return

    def _process_batch(self, batch: List[ServeHandle]) -> None:
        self.metrics_.bump("batches")
        t_drain = time.perf_counter()
        if self._aborted:
            for req in batch:
                self._fail(req, ServiceClosed(
                    "service closed before this request was served"))
            return

        # --- cache probe + in-batch dedup (identical live requests) -------
        leaders: Dict[tuple, ServeHandle] = {}
        twins: List[tuple] = []                # (request, leader) pairs
        runnable: List[ServeHandle] = []
        for req in batch:
            req._wait_s = max(t_drain - req.t_submit, 0.0)
            self.metrics_.observe_wait(req._wait_s)
            if req.deadline is not None and t_drain > req.deadline:
                self.metrics_.bump("expired")
                self._fail(req, RequestTimeout(
                    f"deadline expired after {req._wait_s:.3f}s in "
                    f"the queue"), counted=True)
                continue
            key = result_cache_key(req.space, k=req.k, metric=req.metric,
                                   backend=req.backend)
            cached = self.cache.get(key)
            if cached is not None:
                self._finish(req, dataclasses.replace(
                    cached, serve=self._tenant_metrics(
                        req, len(batch), cache_hit=True,
                        occupancy=cached.occupancy).to_dict()))
                continue
            if req.engine in _STREAMING and key in leaders:
                twins.append((req, leaders[key]))
                continue
            if req.engine in _STREAMING:
                leaders[key] = req
            runnable.append(req)

        # --- group runnable leaders by dispatch compatibility --------------
        groups: Dict[tuple, List[ServeHandle]] = {}
        direct: List[ServeHandle] = []
        members: Dict[int, GroupMember] = {}
        for req in runnable:
            if req.engine not in _STREAMING:
                direct.append(req)
                continue
            pr = prepare_request(
                req.space, k=req.k, metric=req.metric,
                backend=req.backend, chunk_size=req.chunk_size,
                block_points=req.block_points,
                superchunk=req.superchunk, mesh=self._mesh)
            emitter = (PartialEmitter(
                req.stream, min_interval_s=self._partial_interval_s)
                if req.want_stream else None)
            members[req.request_id] = GroupMember(
                pr=pr, emitter=emitter, deadline=req.deadline)
            groups.setdefault(compat_key(pr, self._mesh),
                              []).append(req)

        for group in groups.values():
            self.metrics_.observe_group(len(group))
            gm = [members[r.request_id] for r in group]
            if len(gm) >= 2:
                run_group(gm, mesh=self._mesh)
            else:
                run_solo(gm[0], mesh=self._mesh)
            total = sum(m.dispatches for m in gm) or 1
            self.metrics_.bump("dispatches",
                               sum(m.dispatches for m in gm))
            for req, m in zip(group, gm):
                if m.error is not None:
                    if isinstance(m.error, RequestTimeout):
                        self.metrics_.bump("expired")
                        self._fail(req, m.error, counted=True)
                    else:
                        self._fail(req, m.error)
                    continue
                res = _stream_to_explore(req.space, m.result,
                                         device=self._device)
                self.cache.put(
                    result_cache_key(req.space, k=req.k,
                                     metric=req.metric,
                                     backend=req.backend),
                    dataclasses.replace(res, serve=None))
                tm = self._tenant_metrics(
                    req, len(batch), group=len(group),
                    segments=m.segments, dispatches=m.dispatches,
                    share=m.dispatches / total,
                    partials=m.emitter.seq if m.emitter else 0,
                    occupancy=res.occupancy)
                res.serve = tm.to_dict()
                self._finish(req, res)

        for req in direct:
            self._run_direct(req, len(batch))

        # twins ride their leader's (now settled) outcome
        for req, leader in twins:
            if leader._error is not None:
                self._fail(req, leader._error)
                continue
            self.metrics_.bump("deduped")
            self._finish(req, dataclasses.replace(
                leader._result, serve=self._tenant_metrics(
                    req, len(batch), deduped=True,
                    group=(leader._result.serve or {}).get(
                        "coalesce_group", 1),
                    occupancy=leader._result.occupancy).to_dict()))

    def _run_direct(self, req: ServeHandle, batch_size: int) -> None:
        """Solo fallback for non-coalescable engines ('staged' and the
        grid engines): one inline explore() on the worker thread."""
        self.metrics_.observe_group(1)
        kw = dict(k=req.k, metric=req.metric, engine=req.engine,
                  chunk_size=req.chunk_size, mesh=self._mesh)
        if req.engine == "staged":
            kw.update(block_points=req.block_points,
                      superchunk=req.superchunk)
        try:
            res = explore(req.space, **kw)
        except Exception as exc:  # noqa: BLE001 - contained per request
            self._fail(req, exc)
            return
        self.metrics_.bump("dispatches", res.dispatches)
        res.serve = self._tenant_metrics(
            req, batch_size, dispatches=res.dispatches, share=1.0,
            occupancy=res.occupancy).to_dict()
        self._finish(req, res)

    def _tenant_metrics(self, req: ServeHandle, batch_size: int, *,
                        group: int = 1, segments: int = 0,
                        dispatches: int = 0, share: float = 0.0,
                        cache_hit: bool = False, deduped: bool = False,
                        partials: int = 0,
                        occupancy: float = 1.0) -> TenantMetrics:
        now = time.perf_counter()
        return TenantMetrics(
            request_id=req.request_id, queue_wait_s=req._wait_s,
            service_s=now - req.t_submit, coalesce_group=group,
            segments=segments, dispatches=dispatches,
            dispatch_share=share, cache_hit=cache_hit, deduped=deduped,
            partial_updates=partials + 1,   # + the final update
            occupancy=occupancy, batch_size=batch_size)

    def _finish(self, req: ServeHandle, result: ExploreResult) -> None:
        if req._event.is_set():
            return
        req._result = result
        self.metrics_.bump("completed")
        serve = result.serve or {}
        n_updates = int(serve.get("partial_updates", 1))
        self.metrics_.bump("partial_updates", n_updates)
        req.stream.push(PartialUpdate(
            seq=n_updates - 1, done=result.n_points,
            span=result.n_points, n_feasible=result.n_feasible,
            topk=[dict(r) for r in result.topk], final=True))
        req._event.set()

    def _fail(self, req: ServeHandle, error: BaseException, *,
              counted: bool = False) -> None:
        if req._event.is_set():
            return
        req._error = error
        if not counted:
            self.metrics_.bump("failed")
        req.stream.fail(error)
        req._event.set()
