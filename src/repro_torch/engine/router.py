"""Sharded fleet-of-fleets: consistent-hash routing over FleetEngine shards.

One :class:`~repro_torch.engine.fleet.FleetEngine` scales a process to T=64
tenants; the ROADMAP's millions-of-users target needs many such shards
behind a routing plane.  :class:`FleetRouter` owns N shards and routes
typed :data:`repro_torch.core.workload.Event` traffic to them through a
:class:`~repro_torch.engine.placement.PartitionDirectory` (consistent-hash
ring + explicit overrides), presenting the same
:class:`repro_torch.engine.EventSink` surface as a single fleet — submit /
drain / stats — so the serving tier (:class:`repro_torch.serve.ServeFrontend`)
sits over either unchanged, and at one shard the router is trace-bitwise
invisible.

The three routing-plane capabilities:

* **Live tenant migration** (:meth:`FleetRouter.migrate_tenant`): the
  tenant's queued events are taken from the source shard's inbox, its
  engine detached via :meth:`FleetEngine.remove_tenant` (grants
  released, in-flight incremental migrations transplanted with their
  partially-summed charge ledgers — or finished, closing the ledger
  bitwise on α), re-attached on the target via
  :meth:`FleetEngine.add_tenant`, and the events replayed there.  α is
  charged at decision time (paper §VI-D5) and the StateMatrix plane,
  pending deltas and micro-move ledger all live on the engine object
  that moves, so per-tenant charge ledgers — and, under unlimited
  schedulers, full traces — are bitwise identical to an unsharded run.
* **Load-skew rebalancing**: with a
  :class:`~repro_torch.engine.placement.RebalanceConfig`, a
  :class:`~repro_torch.engine.placement.ShardLoadMeter` tracks events/window
  and queue depth per shard and, past the hysteresis threshold, moves
  the hottest movable tenant onto the coldest shard via the same
  migration path, recording the new home as a directory override.
* **Parallel shard execution**: shards share no mutable state — each
  has its own scheduler (built per shard from a
  :class:`~repro_torch.engine.scheduler.SchedulerSpec`), its own packed
  plane, its own inbox — so they drain independently.
  :class:`repro_torch.launch.shard_host.ProcessShardSet` runs the same
  placement over one OS process per shard.

The routing is host code, line for line the reference package's.  What
runs on the device is each shard's fleet: ``drain`` takes the port's
fleet lanes (:data:`repro_torch.engine.compute.BACKENDS`, default
``"decision_fused"``) and refuses any other name.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional

from repro_torch.core import workload as wl

from .compute import BACKENDS
from .core import LayoutEngine
from .fleet import FleetEngine, FleetResult, FleetStepResult
from .placement import (HashRing, PartitionDirectory, RebalanceConfig,
                        ShardLoadMeter)
from .scheduler import SchedulerSpec, as_scheduler_spec


def shard_ids_for(num_shards: int) -> List[str]:
    """The canonical shard-id set ``["s0", ..., s{N-1}]``.

    Shard ids are placement keys on the hash ring, deliberately
    independent of the router's display name so two routers (or a
    router and a :class:`~repro_torch.launch.shard_host.ProcessShardSet`)
    with the same shard count agree on every tenant's home.
    """
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    return [f"s{i}" for i in range(num_shards)]


class FleetRouter:
    """Routes tenant traffic across N independent FleetEngine shards.

    ``tenants`` maps tenant id → a fresh :class:`LayoutEngine`, exactly
    as for :class:`FleetEngine`; the router places each tenant on a
    shard via the consistent-hash directory and builds one fleet per
    shard, each with its own scheduler from ``scheduler``
    (a :class:`SchedulerSpec`; a bare instance is accepted through the
    single-use deprecation shim, which necessarily refuses more than
    one shard).  ``rebalance`` opts into load-skew rebalancing,
    evaluated at drain boundaries so behaviour stays deterministic and
    replayable.
    """

    def __init__(self, tenants: Mapping[str, LayoutEngine],
                 num_shards: int = 1,
                 scheduler=None,
                 name: str = "router",
                 replicas: int = 64,
                 incremental: Optional[bool] = None,
                 rebalance: Optional[RebalanceConfig] = None):
        if not tenants:
            raise ValueError("a router needs at least one tenant")
        self.name = name
        spec = (SchedulerSpec.unlimited() if scheduler is None
                else as_scheduler_spec(scheduler))
        self.scheduler_spec = spec
        modes = {tid: e.incremental for tid, e in tenants.items()}
        if incremental is None:
            if len(set(modes.values())) > 1:
                raise ValueError(
                    f"tenants mix incremental and atomic engines: {modes}")
            incremental = next(iter(modes.values()))
        self.incremental = bool(incremental)
        self.ring = HashRing(shard_ids_for(num_shards), replicas=replicas)
        self.directory = PartitionDirectory(self.ring)
        by_shard: Dict[str, Dict[str, LayoutEngine]] = {
            sid: {} for sid in self.ring.shard_ids}
        for tid, engine in tenants.items():
            by_shard[self.directory.lookup(tid)][tid] = engine
        self._shards: Dict[str, FleetEngine] = {
            sid: FleetEngine(by_shard[sid], spec.build(),
                             name=f"{name}/{sid}",
                             incremental=self.incremental)
            for sid in self.ring.shard_ids}
        self._known = set(tenants)
        self._meter = (None if rebalance is None
                       else ShardLoadMeter(self.ring.shard_ids, rebalance))
        self.migrations = 0

    # ------------------------------------------------------------------
    # Topology accessors
    # ------------------------------------------------------------------
    @property
    def shard_ids(self) -> List[str]:
        return self.ring.shard_ids

    @property
    def num_shards(self) -> int:
        return len(self._shards)

    def shard(self, shard_id: str) -> FleetEngine:
        return self._shards[shard_id]

    def shard_fleets(self) -> List[FleetEngine]:
        """Every shard's fleet, in shard-id order (EventSink surface)."""
        return [self._shards[sid] for sid in self.ring.shard_ids]

    def shard_of(self, tenant_id: str) -> str:
        if tenant_id not in self._known:
            raise KeyError(f"unknown tenant {tenant_id!r}")
        return self.directory.lookup(tenant_id)

    def tenant(self, tenant_id: str) -> LayoutEngine:
        return self._shards[self.shard_of(tenant_id)].tenant(tenant_id)

    @property
    def tenant_ids(self) -> List[str]:
        return sorted(self._known)

    def placement(self) -> Dict[str, str]:
        return self.directory.placement(sorted(self._known))

    # ------------------------------------------------------------------
    # EventSink: submit / drain / stats
    # ------------------------------------------------------------------
    def submit(self, event) -> None:
        """Route one event to its tenant's shard (nothing runs yet)."""
        ev = wl.as_event(event)
        shard_id = self.shard_of(ev.tenant_id)
        self._shards[shard_id].submit(ev)
        if self._meter is not None:
            self._meter.observe(shard_id, ev.tenant_id)

    @property
    def queue_depth(self) -> int:
        return sum(f.queue_depth for f in self._shards.values())

    def drain(self, *, batched: bool = False,
              compute: str = "decision_fused",
              frames_per_pass: Optional[int] = None,
              collect: bool = False):
        """Drain every shard, in shard-id order.

        Same contract as :meth:`FleetEngine.drain` per shard; the
        default returns the total events processed, ``collect=True``
        concatenates the shards' :class:`FleetStepResult` lists (events
        stay in submission order within each tenant — cross-shard
        interleaving is inherently shard-local).  Inline shards drain
        sequentially in this process; see
        :class:`repro_torch.launch.shard_host.ProcessShardSet` for draining
        the same placement over parallel worker processes.  A completed
        drain is a rebalancing boundary: with a meter configured, full
        load windows are evaluated here (and only here).
        """
        if compute not in BACKENDS:
            raise ValueError(f"unknown compute lane {compute!r} (expected "
                             f"one of {BACKENDS})")
        meter = self._meter
        if meter is not None:
            for sid in self.ring.shard_ids:
                meter.note_queue_depth(sid, self._shards[sid].queue_depth)
        if collect:
            out: List[FleetStepResult] = []
            for sid in self.ring.shard_ids:
                out.extend(self._shards[sid].drain(collect=True))
            self.maybe_rebalance()
            return out
        n = 0
        for sid in self.ring.shard_ids:
            n += self._shards[sid].drain(batched=batched, compute=compute,
                                         frames_per_pass=frames_per_pass)
        self.maybe_rebalance()
        return n

    def stats(self) -> dict:
        return {
            "name": self.name,
            "num_shards": self.num_shards,
            "tenants": len(self._known),
            "queue_depth": self.queue_depth,
            "migrations": self.migrations,
            "overrides": len(self.directory.overrides),
            "shards": {sid: self._shards[sid].stats()
                       for sid in self.ring.shard_ids},
            "rebalancer": (None if self._meter is None
                           else self._meter.stats()),
        }

    # ------------------------------------------------------------------
    # run / run_batched (same shapes as FleetEngine's)
    # ------------------------------------------------------------------
    def run(self, events: Iterable[wl.Event],
            name: Optional[str] = None) -> FleetResult:
        for event in events:
            self.submit(event)
        self.drain()
        return self.result(name)

    def run_batched(self, events: Iterable[wl.Event],
                    name: Optional[str] = None,
                    compute: str = "decision_fused",
                    frames_per_pass: Optional[int] = None) -> FleetResult:
        for event in events:
            self.submit(event)
        self.drain(batched=True, compute=compute,
                   frames_per_pass=frames_per_pass)
        return self.result(name)

    def result(self, name: Optional[str] = None) -> FleetResult:
        """Merged fleet trace across shards.

        At one shard this is exactly the shard's own
        :meth:`FleetEngine.result` (the 1-shard router is trace-bitwise
        a plain fleet); with more, per-tenant traces union (tenants
        live on exactly one shard), fleet counters sum, and the
        per-shard scheduler stats nest under ``"shards"``.
        """
        if self.num_shards == 1:
            only = next(iter(self._shards.values()))
            return only.result(name or self.name)
        per_tenant = {}
        ticks = deferred = deferred_ticks = 0
        shard_stats = {}
        sched_name = ""
        for sid in self.ring.shard_ids:
            r = self._shards[sid].result()
            per_tenant.update(r.per_tenant)
            ticks += r.ticks
            deferred += r.swaps_deferred
            deferred_ticks += r.deferred_ticks
            shard_stats[sid] = r.scheduler_stats
            sched_name = r.scheduler
        return FleetResult(
            name=name or self.name,
            scheduler=sched_name,
            per_tenant=per_tenant,
            ticks=ticks,
            swaps_deferred=deferred,
            deferred_ticks=deferred_ticks,
            scheduler_stats={"shards": shard_stats},
        )

    # ------------------------------------------------------------------
    # Live migration + rebalancing
    # ------------------------------------------------------------------
    def migrate_tenant(self, tenant_id: str, target_shard: str,
                       finish: bool = False) -> bool:
        """Move a tenant between shards, mid-flight, without losing a bit.

        Handoff order: queued events out of the source inbox, engine
        detached (grants released; an in-flight incremental migration
        travels with its partially-summed ledger, or — ``finish=True`` —
        completes first, closing the ledger on α at the current index),
        engine re-attached on the target, events replayed there, and the
        directory updated so subsequent submits route to the new home.
        Returns False for a tenant already on ``target_shard``.
        """
        if target_shard not in self._shards:
            raise KeyError(f"unknown shard {target_shard!r}")
        source_shard = self.shard_of(tenant_id)
        if source_shard == target_shard:
            return False
        source = self._shards[source_shard]
        target = self._shards[target_shard]
        inbox = source.take_inbox(tenant_id)
        engine = source.remove_tenant(tenant_id, finish=finish)
        target.add_tenant(tenant_id, engine)
        for ev in inbox:
            target.submit(ev)
        self.directory.assign(tenant_id, target_shard)
        self.migrations += 1
        return True

    def maybe_rebalance(self) -> Optional[tuple]:
        """One hysteresis-gated rebalancing step (drain boundaries only).

        Evaluates the load meter's completed window, if any; on a
        suggestion, migrates that tenant and returns the
        ``(tenant_id, from_shard, to_shard)`` move.  Without a
        configured meter (or with an incomplete window) this is a no-op
        returning None.
        """
        meter = self._meter
        if meter is None or not meter.window_complete:
            return None
        suggestion = meter.suggest()
        if suggestion is None:
            return None
        tenant_id, source_shard, target_shard = suggestion
        if (tenant_id not in self._known
                or self.directory.lookup(tenant_id) != source_shard):
            return None
        self.migrate_tenant(tenant_id, target_shard)
        return suggestion


__all__ = ["FleetRouter", "shard_ids_for"]
