"""Incremental reorganization plane: micro-move planning and budgeted
execution.

The paper charges one atomic α-cost event per reorganization and swaps the
serving layout wholesale after the Δ-delay.  Production reclustering
systems instead migrate a few micro-partitions at a time, realizing
skipping benefit early and bounding per-tick reorganization work.  This
package is that plane:

* :mod:`planner` — diff a (source, target) layout pair into partition-level
  :class:`MicroMove`\\ s and order them greedily by estimated
  skipping-benefit-per-row-moved under the recent query distribution (the
  scan frequencies come from the move-score kernel, or from the fused
  decision kernel's ``freq`` output).
* :mod:`executor` — a :class:`ReorgExecutor` that consumes scheduler
  grants as *row budgets*, drives moves through the backend a micro-batch
  at a time, and keeps a per-migration charge ledger whose cumulative
  charge is bitwise equal to the atomic α charge at completion.

Hybrid-layout serving (zone maps mixing moved target and unmoved source
partitions) lives in the backends (:mod:`repro_torch.engine.backends`);
the engine/fleet entry point is ``LayoutEngine(..., incremental=True)`` /
``FleetEngine(..., incremental=True)``.
"""
from repro_torch.engine.reorg.executor import MigrationRecord, ReorgExecutor
from repro_torch.engine.reorg.planner import (MicroMove, MigrationPlan,
                                              plan_migration)

__all__ = [
    "MicroMove", "MigrationPlan", "MigrationRecord", "ReorgExecutor",
    "plan_migration",
]
