"""Cost model: service cost c(s, q) in [0, 1] and reorganization cost alpha.

Matches the paper (§III-A): the service cost of a query is the fraction of
data records accessed under the layout (a reliable proxy for query time); the
reorganization cost is ``alpha``, the expected ratio of reorganization compute
time to a full-table-scan query (60-100x is the paper's band; 80 its
default).  Costs go through the device scan
(:func:`repro_torch.core.layouts.eval_cost`) and reduce on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import layouts, workload as wl


@dataclasses.dataclass
class CostModel:
    alpha: float = 80.0
    full_scan_seconds: float = 1.0   # converts logical cost -> wall-clock

    def query_cost(self, layout: layouts.Layout, query: wl.Query) -> float:
        return float(layouts.eval_cost(layout.meta, query.lo, query.hi))

    def query_costs(self, layout: layouts.Layout, q_lo: np.ndarray,
                    q_hi: np.ndarray) -> np.ndarray:
        return np.atleast_1d(layouts.eval_cost(layout.meta, q_lo, q_hi))

    @property
    def reorg_cost(self) -> float:
        return self.alpha

    def to_seconds(self, logical_cost: float) -> float:
        return logical_cost * self.full_scan_seconds
