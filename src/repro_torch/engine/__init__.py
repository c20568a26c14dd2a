"""Online layout-optimization engine on PyTorch: loop, policies, backend,
and the multi-tenant fleet.

    from repro_torch.engine import LayoutEngine, InMemoryBackend, OreoPolicy

    policy = OreoPolicy(data, initial_layout, generator, OreoConfig(alpha=80))
    engine = LayoutEngine(policy, InMemoryBackend(data), delta=policy.config.delta)
    for query in live_traffic:
        step = engine.step(query)          # serve + decide + maybe reorg
    trace = engine.result()

    fleet = FleetEngine({"t0": engine_0, "t1": engine_1},
                        KConcurrentScheduler(1))
    trace = fleet.run_batched(events)      # one scan launch per pass

``data`` is the table as a float64 tensor on its device; every scan runs
there (:mod:`repro_torch.engine.compute`).  ``InMemoryBackend`` serves
zone maps on the device; ``DiskBackend`` keeps one versioned
:class:`repro_torch.data.PartitionStore` directory per materialized layout.
``LayoutEngine(..., incremental=True, rows_per_tick=...)`` (and
``FleetEngine`` over such engines) executes each reorganization as a
planned migration of micro-moves (:mod:`repro_torch.engine.reorg`),
serving hybrid zone maps while rows move; the planner orders the moves
with the move-score kernel.  ``LayoutEngine(..., ingest=IngestConfig())``
opens the write path (:mod:`repro_torch.engine.ingest`): ``engine.ingest(
rows)`` (or an ``IngestEvent`` in a fleet's stream) appends rows as delta
partitions, and a clustering-debt meter charges compactions;
``DiskBackend(..., durable=True)`` logs every manifest change to a
crash-safe WAL (:mod:`repro_torch.data.wal`).

:class:`FleetRouter` (:mod:`repro_torch.engine.router`) shards tenants
over N fleets behind a consistent-hash :class:`PartitionDirectory`
(:mod:`repro_torch.engine.placement`), with live tenant migration and
hysteresis-gated rebalancing.  Both :class:`FleetEngine` and
:class:`FleetRouter` satisfy :class:`EventSink` — submit / drain / stats —
so :class:`repro_torch.serve.ServeFrontend` sits over either unchanged;
:mod:`repro_torch.launch.shard_host` runs the same placement over worker
processes.  ``InMemoryBackend(data, compute="reference")`` keeps no plane
and re-pads zone maps per query, the golden baseline.
"""
from typing import Protocol, runtime_checkable

from repro_torch.core.workload import Event, IngestEvent, QueryEvent, as_event
from repro_torch.engine import compute
from repro_torch.engine.backends import (DiskBackend, InMemoryBackend,
                                         StorageBackend)
from repro_torch.engine.compute import fleet_scan_matrix, scan_matrix
from repro_torch.engine.core import LayoutEngine, StepResult
from repro_torch.engine.fleet import (FleetEngine, FleetResult,
                                      FleetStepResult)
from repro_torch.engine.fleet_matrix import FleetMatrix
from repro_torch.engine.ingest import (DebtMeter, DeltaBatch, DeltaLog,
                                       IngestConfig)
from repro_torch.engine.placement import (HashRing, PartitionDirectory,
                                          RebalanceConfig, ShardLoadMeter)
from repro_torch.engine.policies import (BatchablePolicy, Decision,
                                         GreedyPolicy, MTSOptimalPolicy,
                                         OfflineOptimalPolicy, OreoPolicy,
                                         Policy, RegretPolicy, StaticPolicy,
                                         ThresholdSwitchPolicy)
from repro_torch.engine.reorg import (MicroMove, MigrationPlan,
                                      MigrationRecord, ReorgExecutor,
                                      plan_migration)
from repro_torch.engine.router import FleetRouter
from repro_torch.engine.scheduler import (KConcurrentScheduler,
                                          ReorgScheduler, SchedulerSpec,
                                          TokenBucketScheduler,
                                          UnlimitedScheduler,
                                          as_scheduler_spec)
from repro_torch.engine.state_matrix import StateMatrix


@runtime_checkable
class EventSink(Protocol):
    """Anything that accepts typed events and processes them on demand.

    The contract the serving tier programs against, implemented by
    :class:`FleetEngine` (one fleet) and :class:`FleetRouter` (a routed
    shard set); the core surface is ``submit(event)`` → queue, ``drain``
    → process, ``stats()`` → counters.  The rest of the surface a
    caller can rely on: ``queue_depth``, ``result(name)`` for the
    merged :class:`FleetResult`, ``tenant(tenant_id)`` for the backing
    :class:`LayoutEngine`, and ``shard_fleets()`` — the concrete fleets
    behind the sink (a fleet returns ``[self]``), which is how
    :class:`repro_torch.serve.ServeFrontend` reaches every shard's
    scheduler to shed reorg work under overload.
    """

    def submit(self, event) -> None: ...

    def drain(self, *, batched: bool = ..., compute: str = ...,
              frames_per_pass=..., collect: bool = ...): ...

    def stats(self) -> dict: ...

    @property
    def queue_depth(self) -> int: ...

    def result(self, name=None) -> FleetResult: ...

    def tenant(self, tenant_id: str) -> LayoutEngine: ...

    def shard_fleets(self): ...


__all__ = [
    "BatchablePolicy", "DebtMeter", "Decision", "DeltaBatch", "DeltaLog",
    "DiskBackend", "Event", "EventSink", "FleetEngine", "FleetMatrix",
    "FleetResult", "FleetRouter", "FleetStepResult", "GreedyPolicy",
    "HashRing", "InMemoryBackend", "IngestConfig", "IngestEvent",
    "KConcurrentScheduler", "LayoutEngine", "MTSOptimalPolicy",
    "MicroMove", "MigrationPlan", "MigrationRecord", "OfflineOptimalPolicy",
    "OreoPolicy", "PartitionDirectory", "Policy", "QueryEvent",
    "RebalanceConfig", "RegretPolicy", "ReorgExecutor", "ReorgScheduler",
    "SchedulerSpec", "ShardLoadMeter", "StateMatrix", "StaticPolicy",
    "StepResult", "StorageBackend", "ThresholdSwitchPolicy",
    "TokenBucketScheduler", "UnlimitedScheduler", "as_event",
    "as_scheduler_spec", "compute", "fleet_scan_matrix", "plan_migration",
    "scan_matrix",
]
