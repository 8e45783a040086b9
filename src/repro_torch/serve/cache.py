# Port of src/repro/serve/cache.py: keys carry the port's lanes.
"""TTL + LRU result cache keyed on the campaign space signature.

A serve request is fully identified by ``(space_signature(space), k,
metric, resolved backend)`` — the signature (shared with campaign
manifests via :mod:`repro_torch.signatures`, so the two layers cannot
drift)
covers everything that maps a flat stream index to a design point, and
``k`` / ``metric`` / ``backend`` cover everything else that shapes the
result.  Execution geometry (``chunk_size`` / ``superchunk`` /
``block_points``) deliberately does NOT join the key: it changes how the
sweep is dispatched, not what it computes (the engine-parity tests pin
that), so tenants asking the same question with different batching still
share one cached answer.

Entries are bounded two ways: ``capacity`` (LRU — the stalest entry is
evicted first) and ``ttl_s`` (an entry older than the TTL is expired on
lookup; ``None`` disables aging).  ``stats()`` exposes
hit/miss/eviction/expiration counters.  All operations are thread-safe:
client threads probe while the service worker inserts.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, Optional, Tuple

from ..signatures import space_signature

__all__ = ["ResultCache", "result_cache_key"]


def result_cache_key(space, *, k: int, metric: str,
                     backend: str) -> Tuple[str, int, str, str]:
    """The replay-identity key (see module docstring).  ``backend`` must
    be the RESOLVED lane ("cuda"/"torch"), not "auto" — the service
    resolves before keying so an "auto" and an explicit request for the
    same lane share an entry."""
    return (space_signature(space), int(k), str(metric), str(backend))


class ResultCache:
    """Bounded ``ExploreResult`` replay cache (TTL + LRU, counters)."""

    def __init__(self, *, capacity: int = 128,
                 ttl_s: Optional[float] = None,
                 clock=time.monotonic):
        if int(capacity) < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if ttl_s is not None and float(ttl_s) <= 0:
            raise ValueError(f"ttl_s must be > 0 or None (no aging), "
                             f"got {ttl_s}")
        self.capacity = int(capacity)
        self.ttl_s = None if ttl_s is None else float(ttl_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._stats = {"hits": 0, "misses": 0, "evictions": 0,
                       "expirations": 0, "inserts": 0}

    def key(self, space, *, k: int, metric: str, backend: str) -> tuple:
        return result_cache_key(space, k=k, metric=metric,
                                backend=backend)

    def get(self, key: tuple):
        """The cached result, or None (miss / expired)."""
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                self._stats["misses"] += 1
                return None
            result, stamp = hit
            if self.ttl_s is not None \
                    and self._clock() - stamp > self.ttl_s:
                del self._entries[key]
                self._stats["expirations"] += 1
                self._stats["misses"] += 1
                return None
            self._entries.move_to_end(key)
            self._stats["hits"] += 1
            return result

    def put(self, key: tuple, result) -> None:
        with self._lock:
            self._entries[key] = (result, self._clock())
            self._entries.move_to_end(key)
            self._stats["inserts"] += 1
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self._stats["evictions"] += 1

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            for key in self._stats:
                self._stats[key] = 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._stats, size=len(self._entries),
                        capacity=self.capacity, ttl_s=self.ttl_s)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
