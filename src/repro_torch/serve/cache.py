"""Versioned read-through serve-cost cache for the serving front end.

Exactness argument (why a cache cannot change a single trace bit): every
serving-layout change in a matrix-backed backend — activating a swap,
advancing or completing an incremental migration, composing an ingest
delta — goes through ``_install_serving_meta``, which re-registers the
serving shadow row in the tenant's :class:`~repro_torch.engine.StateMatrix`
and therefore **bumps the plane version**.  Keying entries on
``(tenant, plane_version, query_bounds)`` means a hit is only possible
while the serving zone maps are bit-identical to when the entry was
filled, so the cached cost equals what ``serve()`` would recompute.
Candidate prepare/evict churn also bumps the version; that only causes
conservative misses, never a stale hit.

The frontend consumes hits by priming the backend's single-slot serve
memo (identity-keyed on the query object), so a swap landing *mid-step*
still clears the primed value before it could be served stale.
"""
from __future__ import annotations

import collections
from typing import Optional, Tuple

from repro_torch.core import workload as wl

#: (tenant_id, plane_version, lo_bytes, hi_bytes)
CacheKey = Tuple[str, int, bytes, bytes]


def cache_key(tenant_id: str, version: int, query: wl.Query) -> CacheKey:
    """Key a query's serve cost on the tenant's serving-plane version."""
    return (tenant_id, int(version), query.lo.tobytes(), query.hi.tobytes())


class VersionedResultCache:
    """Bounded LRU mapping :func:`cache_key` → realized serve cost."""

    def __init__(self, max_entries: int = 4096):
        if max_entries <= 0:
            raise ValueError(f"max_entries must be > 0, got {max_entries!r}")
        self.max_entries = int(max_entries)
        self._data: "collections.OrderedDict[CacheKey, float]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: CacheKey) -> Optional[float]:
        """Look up a serve cost; None (and a miss) when absent."""
        cost = self._data.get(key)
        if cost is None:
            self.misses += 1
            return None
        self._data.move_to_end(key)
        self.hits += 1
        return cost

    def put(self, key: CacheKey, cost: float) -> None:
        """Fill one entry, evicting the least-recently-used past capacity."""
        self._data[key] = float(cost)
        self._data.move_to_end(key)
        while len(self._data) > self.max_entries:
            self._data.popitem(last=False)
            self.evictions += 1

    def stats(self) -> dict:
        return {"entries": len(self._data), "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions}
