"""Exploration-as-a-service of the port: multi-tenant ``explore()``.

A long-lived in-process service front over the streaming sweep engines
(the reference's ``repro.serve``, on one device): concurrent tenants
submit :class:`~repro_torch.explore.DesignSpace` requests and the
service coalesces compatible ones onto ONE shared step (one K1 plan and
compute, built once), replays repeats from a TTL+LRU result cache, and
streams converging partial top-k snapshots per tenant.  Start with::

    from repro_torch.serve import ExploreService
    with ExploreService() as svc:            # device="cpu": the twins
        res = svc.explore(space, k=8)            # blocking, like explore()
        res = explore(space, k=8, service=svc)   # same, via the front door
        h = svc.submit(space, k=8, stream=True)  # non-blocking + partials
        for update in h.partials():
            print(update.frac, update.topk[0])

See :mod:`repro_torch.serve.service` for the scheduling model,
:mod:`repro_torch.serve.coalesce` for the one-step compatibility rules,
and :mod:`repro_torch.serve.cache` for the replay-identity key.
"""
from .cache import ResultCache, result_cache_key
from .errors import QueueFull, RequestTimeout, ServeError, ServiceClosed
from .metrics import ServiceMetrics, TenantMetrics
from .service import ExploreService, ServeHandle
from .stream import PartialUpdate, TenantStream

__all__ = [
    "ExploreService",
    "PartialUpdate",
    "QueueFull",
    "RequestTimeout",
    "ResultCache",
    "ServeError",
    "ServeHandle",
    "ServiceClosed",
    "ServiceMetrics",
    "TenantMetrics",
    "TenantStream",
    "result_cache_key",
]
