"""Clustering debt: metering what unclustered deltas cost the workload.

Every served query pays the *composed* serving state's scan cost — base
partitions plus wide-bounded delta partitions.  The **debt meter** tracks
the excess of that realized cost over the cost the same query would have
paid against a hypothetical *compacted* table (delta rows routed through
the serving layout and merged into its partitions' zone maps):

    debt += max(0, c(composed, q) - c(compacted, q))

The compacted zone maps are maintained incrementally on the table's
device — O(B*C) per append, never a re-route of the whole table — so the
meter stays metadata-only, like every other decision-plane estimate.
Each :meth:`DebtMeter.observe` is one scan of the compacted zone maps
(:func:`repro_torch.core.layouts.eval_cost`: one pruning launch on the
card), reduced on the host through the same einsum as every other cost,
so the debt is bitwise the reference package's.

Compaction triggering is the same amortization argument OREO's D-UMTS
layer applies to drift reorgs: reclustering is worth its α charge once
the workload has *demonstrated* at least ``debt_threshold * α`` of excess
scan cost under the recent query window.  ``debt_threshold=1.0`` is the
worst-case-safe default (pay α only after α of damage — total compaction
spend is bounded by realized excess), ``0.0`` degenerates to
always-recluster, and disabling auto-compaction gives never-recluster.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import layouts as L


@dataclasses.dataclass(frozen=True)
class IngestConfig:
    """Engine-level ingest behaviour.

    ``auto_compact`` — fold clustering debt into the decision plane: when
    the meter crosses ``debt_threshold * α`` the engine charges a
    reclustering reorg (α at decision time, Δ-delayed swap, scheduler
    arbitration — the drift-reorg machinery, one shared budget).
    ``debt_threshold`` — multiples of α the debt must reach; ``0.0``
    compacts at the first delta-touching query, ``float("inf")`` never.
    """

    auto_compact: bool = True
    debt_threshold: float = 1.0


class DebtMeter:
    """Incrementally-maintained clustering-debt accumulator."""

    def __init__(self):
        self.debt = 0.0
        #: Zone maps of the hypothetical compacted table (base layout with
        #: delta rows routed in); None while no deltas are pending.
        self._compacted: Optional[L.PartitionMetadata] = None
        #: Lifetime counters (benchmarks / traces).
        self.total_excess = 0.0
        self.compactions_triggered = 0

    @property
    def active(self) -> bool:
        return self._compacted is not None

    # -- maintenance ---------------------------------------------------
    def on_append(self, base_meta: L.PartitionMetadata, rows: torch.Tensor,
                  assignment: torch.Tensor) -> None:
        """Merge one routed batch into the compacted zone maps (O(B*C));
        ``rows`` and ``assignment`` are on the zone maps' device."""
        current = self._compacted if self._compacted is not None else base_meta
        p = current.num_partitions
        batch = L.metadata_from_assignment(rows, assignment, p)
        counts = current.rows_host + batch.rows_host
        self._compacted = L.PartitionMetadata(
            mins=torch.minimum(current.mins, batch.mins),
            maxs=torch.maximum(current.maxs, batch.maxs),
            rows=torch.from_numpy(counts).to(current.device),
            rows_host=counts)

    def reset(self) -> None:
        """Deltas were absorbed (compaction or drift reorg): debt is paid."""
        self.debt = 0.0
        self._compacted = None

    # -- metering ------------------------------------------------------
    def observe(self, query_cost: float, q_lo: np.ndarray,
                q_hi: np.ndarray) -> float:
        """Accrue one served query's excess cost; returns the increment."""
        if self._compacted is None:
            return 0.0
        ideal = float(L.eval_cost(self._compacted, q_lo, q_hi))
        excess = max(0.0, query_cost - ideal)
        self.debt += excess
        self.total_excess += excess
        return excess

    def triggered(self, alpha: float, config: IngestConfig) -> bool:
        """Should a reclustering reorg be charged now?"""
        if not config.auto_compact or self._compacted is None:
            return False
        return self.debt >= config.debt_threshold * alpha


__all__ = ["DebtMeter", "IngestConfig"]
