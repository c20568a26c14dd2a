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
"""
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
from repro_torch.engine.policies import (BatchablePolicy, Decision,
                                         GreedyPolicy, MTSOptimalPolicy,
                                         OfflineOptimalPolicy, OreoPolicy,
                                         Policy, RegretPolicy, StaticPolicy,
                                         ThresholdSwitchPolicy)
from repro_torch.engine.reorg import (MicroMove, MigrationPlan,
                                      MigrationRecord, ReorgExecutor,
                                      plan_migration)
from repro_torch.engine.scheduler import (KConcurrentScheduler,
                                          ReorgScheduler, SchedulerSpec,
                                          TokenBucketScheduler,
                                          UnlimitedScheduler,
                                          as_scheduler_spec)
from repro_torch.engine.state_matrix import StateMatrix

__all__ = [
    "BatchablePolicy", "DebtMeter", "Decision", "DeltaBatch", "DeltaLog",
    "DiskBackend", "Event", "FleetEngine",
    "FleetMatrix", "FleetResult", "FleetStepResult", "GreedyPolicy",
    "InMemoryBackend", "IngestConfig", "IngestEvent", "KConcurrentScheduler",
    "LayoutEngine",
    "MTSOptimalPolicy", "MicroMove", "MigrationPlan", "MigrationRecord",
    "OfflineOptimalPolicy", "OreoPolicy", "Policy",
    "QueryEvent", "RegretPolicy", "ReorgExecutor", "ReorgScheduler",
    "SchedulerSpec", "StateMatrix", "StaticPolicy", "StepResult",
    "StorageBackend", "ThresholdSwitchPolicy", "TokenBucketScheduler",
    "UnlimitedScheduler", "as_event", "as_scheduler_spec", "compute",
    "fleet_scan_matrix", "plan_migration", "scan_matrix",
]
