"""Tenant placement for the sharded fleet: ring, directory, load meter.

The routing plane (:class:`repro_torch.engine.router.FleetRouter`) decides
which :class:`~repro_torch.engine.fleet.FleetEngine` shard owns each tenant
with three small, deterministic pieces:

* :class:`HashRing` — consistent hashing with virtual nodes.  Placement
  is a pure function of (tenant id, shard set): adding or removing a
  shard relocates only the tenants whose arc the change touches —
  ~1/N of them — never reshuffles the rest (the classic property the
  partitioning patterns in PAPERS.md's *Distributed Data Placement via
  Graph Partitioning* build on).
* :class:`PartitionDirectory` — explicit tenant → shard overrides
  layered over the ring.  A lookup is a pure function of
  ``(ring, overrides)``; live migrations record their destination here
  so placement survives ring arithmetic and restarts alike.
* :class:`ShardLoadMeter` — per-shard load accounting (events per
  window + queue depth) with a hysteresis trigger: past
  ``high`` imbalance it suggests moving the hottest tenant off the
  hottest shard, then re-arms only after imbalance falls below ``low``
  so a borderline fleet does not thrash tenants back and forth.

Everything here is clocked by event counters, never wall time, so
placement decisions are deterministic and replayable.  This is host code,
line for line the reference package's: the ring's blake2b positions place
every tenant on the same shard in both packages.
"""
from __future__ import annotations

import bisect
import dataclasses
import hashlib
from typing import Dict, Iterable, List, Mapping, Optional, Tuple


def _stable_hash(key: str) -> int:
    """64-bit position on the ring; stable across processes and runs.

    Python's builtin ``hash`` is salted per process (PYTHONHASHSEED), so
    a directory computed in the router process would disagree with one
    computed inside a shard worker — blake2b is not.
    """
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big")


class HashRing:
    """Consistent-hash ring over shard ids with virtual nodes.

    Each shard owns ``replicas`` points on a 64-bit ring; a key maps to
    the shard owning the first point clockwise from the key's hash.
    More replicas smooth the arc lengths (64 per shard keeps the
    largest/mean tenant-count ratio low at fleet sizes we run).
    """

    def __init__(self, shard_ids: Iterable[str] = (), replicas: int = 64):
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        self.replicas = int(replicas)
        self._points: List[Tuple[int, str]] = []   # sorted (hash, shard)
        self._shards: Dict[str, List[int]] = {}
        for sid in shard_ids:
            self.add_shard(sid)

    @property
    def shard_ids(self) -> List[str]:
        return sorted(self._shards)

    def __len__(self) -> int:
        return len(self._shards)

    def add_shard(self, shard_id: str) -> None:
        if shard_id in self._shards:
            raise ValueError(f"shard {shard_id!r} already on the ring")
        hashes = [_stable_hash(f"{shard_id}#{i}")
                  for i in range(self.replicas)]
        self._shards[shard_id] = hashes
        for h in hashes:
            bisect.insort(self._points, (h, shard_id))

    def remove_shard(self, shard_id: str) -> None:
        self._shards.pop(shard_id)   # KeyError for unknown shards
        self._points = [(h, s) for h, s in self._points if s != shard_id]

    def lookup(self, key: str) -> str:
        """The shard owning ``key`` — pure in (key, shard set, replicas)."""
        if not self._points:
            raise ValueError("ring has no shards")
        h = _stable_hash(key)
        # (h,) sorts before every (h, shard) tuple, so a key hashing
        # exactly onto a virtual node maps to that node.
        idx = bisect.bisect_right(self._points, (h,))
        if idx == len(self._points):
            idx = 0                                 # wrap past 2**64
        return self._points[idx][1]


class PartitionDirectory:
    """Tenant → shard lookups: explicit overrides over the hash ring.

    The ring gives every tenant a default home; :meth:`assign` pins a
    tenant elsewhere (live migration, rebalancing).  ``lookup`` is a
    pure function of ``(ring, overrides)`` — no hidden state, so two
    directories built from the same parts agree on every tenant.
    """

    def __init__(self, ring: HashRing,
                 overrides: Optional[Mapping[str, str]] = None):
        self.ring = ring
        self._overrides: Dict[str, str] = dict(overrides or {})

    @property
    def overrides(self) -> Dict[str, str]:
        return dict(self._overrides)

    def lookup(self, tenant_id: str) -> str:
        override = self._overrides.get(tenant_id)
        if override is not None:
            return override
        return self.ring.lookup(tenant_id)

    def assign(self, tenant_id: str, shard_id: str) -> None:
        """Pin ``tenant_id`` to ``shard_id`` (drops a redundant pin)."""
        if self.ring.lookup(tenant_id) == shard_id:
            self._overrides.pop(tenant_id, None)
        else:
            self._overrides[tenant_id] = shard_id

    def clear(self, tenant_id: str) -> None:
        self._overrides.pop(tenant_id, None)

    def placement(self, tenant_ids: Iterable[str]) -> Dict[str, str]:
        return {tid: self.lookup(tid) for tid in tenant_ids}


@dataclasses.dataclass
class RebalanceConfig:
    """Hysteresis knobs for :class:`ShardLoadMeter`."""

    #: Events per evaluation window (the meter's clock).
    window: int = 512
    #: Trigger a move when max/mean shard load exceeds this ...
    high: float = 1.5
    #: ... and re-arm only once it falls back below this.
    low: float = 1.1
    #: Queue-depth weight relative to one window event.
    queue_weight: float = 1.0

    def __post_init__(self) -> None:
        if self.window < 1:
            raise ValueError("window must be >= 1")
        if not self.high > self.low >= 1.0:
            raise ValueError("need high > low >= 1.0 for hysteresis")


class ShardLoadMeter:
    """Per-shard load windows with a hysteresis rebalance trigger.

    Feed it one :meth:`observe` per routed event and the per-shard queue
    depths at evaluation time; every ``window`` events it computes the
    imbalance ``max(load) / mean(load)`` and, while armed and above
    ``high``, :meth:`suggest`\\ s moving the hottest tenant off the
    hottest shard onto the coldest.  After suggesting it disarms until
    imbalance falls below ``low`` — one genuine skew produces one burst
    of moves, borderline oscillation produces none.
    """

    def __init__(self, shard_ids: Iterable[str],
                 config: Optional[RebalanceConfig] = None):
        self.config = config or RebalanceConfig()
        self._events: Dict[str, int] = {sid: 0 for sid in shard_ids}
        self._tenant_events: Dict[str, Dict[str, int]] = {
            sid: {} for sid in self._events}
        self._depths: Dict[str, int] = {sid: 0 for sid in self._events}
        self._window_count = 0
        self.armed = True
        self.windows_evaluated = 0
        self.moves_suggested = 0

    def add_shard(self, shard_id: str) -> None:
        self._events.setdefault(shard_id, 0)
        self._tenant_events.setdefault(shard_id, {})
        self._depths.setdefault(shard_id, 0)

    def observe(self, shard_id: str, tenant_id: str) -> None:
        """Account one event routed to ``shard_id`` for ``tenant_id``."""
        self._events[shard_id] += 1
        per = self._tenant_events[shard_id]
        per[tenant_id] = per.get(tenant_id, 0) + 1
        self._window_count += 1

    def note_queue_depth(self, shard_id: str, depth: int) -> None:
        self._depths[shard_id] = int(depth)

    @property
    def window_complete(self) -> bool:
        return self._window_count >= self.config.window

    def loads(self) -> Dict[str, float]:
        w = self.config.queue_weight
        return {sid: self._events[sid] + w * self._depths[sid]
                for sid in self._events}

    def imbalance(self) -> float:
        loads = list(self.loads().values())
        if not loads:
            return 1.0
        mean = sum(loads) / len(loads)
        if mean <= 0:
            return 1.0
        return max(loads) / mean

    def suggest(self) -> Optional[Tuple[str, str, str]]:
        """``(tenant_id, from_shard, to_shard)`` or None.

        Evaluated once per completed window; resets the window either
        way.  Only the hysteresis-armed, above-``high`` case suggests,
        and only a move that actually helps: the hottest shard's hottest
        tenant whose load fits in the gap to the mean (moving a tenant
        hotter than the whole skew would just relocate the hotspot).
        """
        if not self.window_complete:
            return None
        self.windows_evaluated += 1
        imbalance = self.imbalance()
        loads = self.loads()
        suggestion = None
        if not self.armed and imbalance < self.config.low:
            self.armed = True
        if self.armed and imbalance > self.config.high and len(loads) > 1:
            hot = max(sorted(loads), key=lambda s: loads[s])
            cold = min(sorted(loads), key=lambda s: loads[s])
            mean = sum(loads.values()) / len(loads)
            headroom = mean - loads[cold]
            per = self._tenant_events[hot]
            movable = [t for t in sorted(per) if per[t] <= headroom]
            if movable:
                tenant = max(movable, key=lambda t: per[t])
                suggestion = (tenant, hot, cold)
                self.moves_suggested += 1
                self.armed = False
        self._reset_window()
        return suggestion

    def _reset_window(self) -> None:
        self._window_count = 0
        for sid in self._events:
            self._events[sid] = 0
            self._tenant_events[sid] = {}

    def stats(self) -> dict:
        return {
            "imbalance": float(self.imbalance()),
            "loads": self.loads(),
            "armed": self.armed,
            "windows_evaluated": self.windows_evaluated,
            "moves_suggested": self.moves_suggested,
        }


__all__ = ["HashRing", "PartitionDirectory", "RebalanceConfig",
           "ShardLoadMeter"]
