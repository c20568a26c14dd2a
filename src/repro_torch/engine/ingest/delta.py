"""Delta partitions: unclustered append batches visible to scans at once.

Streaming ingest lands rows *without* routing them through the serving
layout: each :meth:`DeltaLog.append` becomes one **delta partition** with
exact zone maps, stacked on top of the clustered base table's metadata by
:meth:`DeltaLog.compose`.  Scans see appended rows immediately (the
composed zone maps are installed as the backend's serving state, so the
packed StateMatrix / FleetMatrix planes score delta-bearing tenants in the
same fused pass), but skipping over deltas is poor by construction — a
batch's bounds span whatever arrived — which is exactly the *clustering
debt* the decision plane meters (:mod:`repro_torch.engine.ingest.debt`).

``clustered_len`` tracks the prefix of the backing table covered by the
serving layout's clustering; everything beyond it lives in delta batches.
A reorganization (atomic activate, or an incremental compaction planned
over the deltas) *absorbs* batches: :meth:`absorb_up_to` drops every batch
the rewrite covered.

Batch zone maps live on the table's device as ``(C,)`` float64 tensors
(min and max are exact in any order, so they equal a host reduction bit
for bit); row counts stay on the host.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import layouts as L


@dataclasses.dataclass(frozen=True, eq=False)
class DeltaBatch:
    """One ingest batch: a [start, end) row range with exact zone maps."""

    batch_id: int
    start: int
    end: int
    mins: torch.Tensor      # (C,) on the table's device
    maxs: torch.Tensor      # (C,)

    @property
    def rows(self) -> int:
        return self.end - self.start


class DeltaLog:
    """Pending delta batches over a growing table."""

    def __init__(self, clustered_len: int):
        self.clustered_len = int(clustered_len)
        self.batches: List[DeltaBatch] = []
        self._next_id = 0
        #: Bumped whenever batches are absorbed (consumers reset caches).
        self.generation = 0

    @property
    def pending(self) -> bool:
        return bool(self.batches)

    @property
    def num_batches(self) -> int:
        return len(self.batches)

    @property
    def delta_rows(self) -> int:
        return sum(b.rows for b in self.batches)

    def append(self, rows: torch.Tensor, start: int) -> DeltaBatch:
        """Record one appended batch occupying ``[start, start+len)``;
        ``rows`` is the batch as a tensor on the table's device."""
        if rows.ndim != 2 or len(rows) == 0:
            raise ValueError("an ingest batch must be a non-empty (N, C) "
                             "array")
        mins, maxs = torch.aminmax(rows, dim=0)
        batch = DeltaBatch(batch_id=self._next_id, start=int(start),
                           end=int(start) + len(rows), mins=mins, maxs=maxs)
        self._next_id += 1
        self.batches.append(batch)
        return batch

    def compose(self, base: L.PartitionMetadata) -> L.PartitionMetadata:
        """Base zone maps + one partition per pending delta batch.

        With no pending batches this returns ``base`` itself (the same
        object), so an ingest-enabled engine that never ingests serves
        bit-identically to one without ingest.
        """
        if not self.batches:
            return base
        d_mins = torch.stack([b.mins for b in self.batches])
        d_maxs = torch.stack([b.maxs for b in self.batches])
        d_rows = np.array([float(b.rows) for b in self.batches])
        rows = np.concatenate([base.rows_host, d_rows])
        return L.PartitionMetadata(
            mins=torch.cat([base.mins, d_mins]),
            maxs=torch.cat([base.maxs, d_maxs]),
            rows=torch.from_numpy(rows).to(base.device), rows_host=rows)

    def source_assignment(self, base_assignment: torch.Tensor,
                          num_base_partitions: int,
                          total_len: int) -> Optional[torch.Tensor]:
        """Row -> partition assignment of the composed (hybrid) source,
        an ``(N,)`` int64 tensor on ``base_assignment``'s device.

        Base rows keep their clustered assignment; batch ``k``'s rows map
        to pseudo-partition ``num_base_partitions + k`` — the layout the
        migration planner diffs a compaction (or a delta-bearing drift
        reorg) against.  Rows beyond the last batch (none in practice:
        every appended row is logged) are unreachable.
        """
        if not self.batches:
            return None
        out = torch.empty(total_len, dtype=torch.int64,
                          device=base_assignment.device)
        out[:self.clustered_len] = base_assignment
        for k, b in enumerate(self.batches):
            out[b.start:b.end] = num_base_partitions + k
        return out

    def absorb_up_to(self, length: int) -> None:
        """A rewrite clustered rows [0, length): drop the covered batches."""
        self.batches = [b for b in self.batches if b.start >= length]
        self.clustered_len = max(self.clustered_len, int(length))
        self.generation += 1


__all__ = ["DeltaBatch", "DeltaLog"]
