# Copy of src/repro/serve/stream.py (no jax); docstrings name repro_torch.
"""Streaming partial top-k: the tenant-facing update channel.

Each request handle owns a :class:`TenantStream` — a thread-safe queue
of :class:`PartialUpdate` snapshots the dispatch side pushes as the
tenant's superchunks complete (riding the ``on_partial`` hook of
``_stream_impl`` for solo requests, and per-segment merges for
coalesced ones).  The stream always ends with exactly one terminal
update: ``final=True`` carrying the completed top-k, or an error that
re-raises on the consumer side.  Consuming is pull-based and lazy —
a tenant that never iterates costs nothing beyond the queued snapshots.

:class:`PartialEmitter` is the dispatch-side throttle: materializing a
partial snapshot drains the device pipeline, so updates are rate-limited
to ``min_interval_s`` (the final update always goes through).
"""
from __future__ import annotations

import dataclasses
import queue
import time
from typing import Dict, Iterator, List, Optional

__all__ = ["PartialEmitter", "PartialUpdate", "TenantStream"]


@dataclasses.dataclass
class PartialUpdate:
    """One streamed snapshot of a tenant's converging result."""
    seq: int                 #: 0-based update ordinal for this tenant
    done: int                #: flat points reduced so far
    span: int                #: total flat points of the request
    n_feasible: int          #: feasible points seen so far
    topk: List[Dict]         #: best-so-far rows (ascending by metric)
    final: bool = False      #: True exactly once, on the last update

    @property
    def frac(self) -> float:
        return self.done / self.span if self.span else 1.0


class TenantStream:
    """Thread-safe stream of :class:`PartialUpdate` for one tenant."""

    _DONE = object()

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False

    # ----- producer side (service worker thread) --------------------------
    def push(self, update: PartialUpdate) -> None:
        if not self._closed:
            self._q.put(update)
            if update.final:
                self._closed = True
                self._q.put(self._DONE)

    def fail(self, error: BaseException) -> None:
        """Terminate the stream with an error (re-raised on iteration)."""
        if not self._closed:
            self._closed = True
            self._q.put(error)
            self._q.put(self._DONE)

    # ----- consumer side (tenant threads / async front end) ---------------
    def get(self, timeout: Optional[float] = None):
        """Next update, the DONE sentinel, or a terminal exception
        instance (not raised here — :meth:`__iter__` raises)."""
        return self._q.get(timeout=timeout)

    def __iter__(self) -> Iterator[PartialUpdate]:
        while True:
            item = self._q.get()
            if item is self._DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item


class PartialEmitter:
    """Dispatch-side throttle pushing snapshots into a tenant stream."""

    def __init__(self, stream: TenantStream, *,
                 min_interval_s: float = 0.05,
                 clock=time.perf_counter):
        self.stream = stream
        self.min_interval_s = float(min_interval_s)
        self._clock = clock
        self._last: Optional[float] = None
        self.seq = 0

    def want(self) -> bool:
        """Should the caller pay for materializing a snapshot now?"""
        return (self._last is None
                or self._clock() - self._last >= self.min_interval_s)

    def emit(self, done: int, span: int, n_feasible: int,
             topk: List[Dict], *, final: bool = False) -> None:
        self._last = self._clock()
        self.stream.push(PartialUpdate(
            seq=self.seq, done=int(done), span=int(span),
            n_feasible=int(n_feasible),
            topk=[dict(r) for r in topk], final=final))
        self.seq += 1

    def emit_stream_result(self, st, done: int, span: int, *,
                           final: bool = False) -> None:
        """Emit from a (partial or merged) ``StreamResult``."""
        self.emit(done, span, st.n_feasible, st.topk, final=final)
