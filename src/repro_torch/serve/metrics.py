# Copy of src/repro/serve/metrics.py (no jax); docstrings name repro_torch.
"""Serving metrics: per-tenant and service-level accounting.

Every request that passes through :class:`~repro_torch.serve.ExploreService`
gets a :class:`TenantMetrics` record (exported on
``ExploreResult.serve`` and on the request's handle) answering the
questions a tenant can't derive from the result itself: how long it
queued, how many tenants shared its dispatch group, what share of the
group's dispatches were its own, and whether it was served from the
result cache instead of dispatching at all.

:class:`ServiceMetrics` is the service-wide counter surface (thread-safe
— the worker thread and any number of client threads touch it) backing
``ExploreService.metrics()`` and the ``serve_bench`` BENCH columns
(``clients`` / ``coalesced_groups`` / ``cache_hit_rate``).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional


@dataclasses.dataclass
class TenantMetrics:
    """One request's serving record (see module docstring)."""
    request_id: int
    #: submit -> dispatch start (queue + coalesce-window time)
    queue_wait_s: float = 0.0
    #: submit -> completion
    service_s: float = 0.0
    #: requests in this tenant's dispatch group (1 = solo fallback)
    coalesce_group: int = 1
    #: segment dispatches issued for this tenant
    segments: int = 0
    #: step-executable invocations issued for this tenant
    dispatches: int = 0
    #: this tenant's dispatches / its group's total dispatches
    dispatch_share: float = 0.0
    #: served from the result cache (no dispatch at all)
    cache_hit: bool = False
    #: duplicate of another in-flight request in the same batch (served
    #: from the twin's fresh result, no dispatch of its own)
    deduped: bool = False
    #: partial top-k updates streamed to the tenant (final included)
    partial_updates: int = 0
    #: valid points / dispatched points over the tenant's sweep
    occupancy: float = 1.0
    #: size of the batch the request was drained with
    batch_size: int = 1

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


class ServiceMetrics:
    """Thread-safe service-wide counters (``ExploreService.metrics()``)."""

    _FIELDS = ("submitted", "completed", "failed", "expired", "rejected",
               "deduped", "batches", "coalesced_groups", "solo_runs",
               "dispatches", "partial_updates")

    def __init__(self):
        self._lock = threading.Lock()
        self._n = dict.fromkeys(self._FIELDS, 0)
        self._max_group = 0
        self._queue_wait_s = 0.0

    def bump(self, field: str, by: int = 1) -> None:
        with self._lock:
            self._n[field] += by

    def observe_group(self, size: int) -> None:
        with self._lock:
            self._max_group = max(self._max_group, int(size))
            if size >= 2:
                self._n["coalesced_groups"] += 1
            else:
                self._n["solo_runs"] += 1

    def observe_wait(self, wait_s: float) -> None:
        with self._lock:
            self._queue_wait_s += float(wait_s)

    def snapshot(self, *, cache: Optional[Dict] = None,
                 queue_depth: int = 0) -> Dict:
        with self._lock:
            out = dict(self._n, max_group=self._max_group,
                       queue_wait_s=round(self._queue_wait_s, 6),
                       queue_depth=int(queue_depth))
        out["cache"] = dict(cache) if cache is not None else None
        return out
