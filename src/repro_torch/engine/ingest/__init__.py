"""Streaming ingest plane: delta partitions, clustering debt, compaction.

``LayoutEngine(..., ingest=IngestConfig())`` opens the write path: rows
appended through :meth:`repro_torch.engine.LayoutEngine.ingest` land in
the backend's table on its device and in unclustered **delta
partitions** (:class:`DeltaLog`) that are visible to scans immediately —
their zone maps ride the existing StateMatrix listener events, so the
FleetMatrix keeps scoring delta-bearing tenants in the fused pass.  A
:class:`DebtMeter` folds the resulting *clustering debt* into the
decision plane: once the workload's realized excess scan cost crosses
``debt_threshold * α``, the engine charges a reclustering reorganization
through the same α-charged, Δ-delayed, scheduler-arbitrated path drift
reorgs take, and (in incremental mode) the
:class:`repro_torch.engine.reorg.ReorgExecutor` executes the compaction
as budgeted micro-moves with the bitwise-α charge ledger intact.
"""
from .debt import DebtMeter, IngestConfig
from .delta import DeltaBatch, DeltaLog

__all__ = ["DebtMeter", "DeltaBatch", "DeltaLog", "IngestConfig"]
