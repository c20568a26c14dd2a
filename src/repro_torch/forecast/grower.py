"""Online qd-tree state growth from forecasted query distributions.

The LayoutManager (Algorithm 5) generates candidates from the *observed*
sliding window — by the time a drifted template dominates the window, the
fleet has already paid for the transition.  :class:`QdTreeGrower` closes
that gap: given a :class:`repro_torch.forecast.predictors.Forecast`, it
builds a qd-tree layout (Yang et al., SIGMOD'20 — the same
:func:`repro_torch.core.qdtree.build_qdtree_layout` the reactive
generator uses, over the table on its device) from the *predicted* query
sample and admits it only when its predicted mean cost undercuts every
already-registered state by a relative margin — learned cost estimates
over the forecast window (the pruning kernel's scans), in the spirit of
cost-estimation-driven partitioning.

Grown state ids live in their own id space (:data:`GROWN_ID_BASE`) so
they can never collide with LayoutManager candidates; like the manager,
the grower only consumes an id on admission (a rejected candidate's id
is reused by the next proposal).  Registration and eviction are the
caller's job (:class:`repro_torch.forecast.policy.ForecastPolicy` routes
them through ``dumts.add_state``/``remove_state`` + backend
register/deregister, i.e. the StateMatrix dynamic-state events every
mirror — the FleetMatrix plane, serve caches — already listens to).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import layouts, qdtree, workload as wl

from .predictors import Forecast

#: Grown layout ids start here — disjoint from LayoutManager's
#: ``next_id`` counter (initial layout id + admissions) by a wide margin.
GROWN_ID_BASE = 1_000_000


class QdTreeGrower:
    """Propose qd-tree layouts for forecasted workloads; picklable."""

    def __init__(self, data: torch.Tensor, target_partitions: int,
                 min_queries: int = 8, gain: float = 0.25,
                 cost_floor: float = 0.15, alpha: float = 0.0,
                 admit_margin: float = 1.0, seed: int = 0):
        #: The manager's table itself, not a copy: one copy of the table
        #: on the device, and one storage when an engine is pickled.
        self.data = data
        self.target_partitions = int(target_partitions)
        #: Minimum forecast sample size worth building a tree over.
        self.min_queries = int(min_queries)
        #: Relative held-out predicted-cost improvement for admission.
        self.gain = float(gain)
        #: Absolute bar: grow only when the best existing state still
        #: scans at least this fraction on the predicted regime.
        self.cost_floor = float(cost_floor)
        #: The D-UMTS movement cost the state space operates under.  A
        #: grown state the decision plane ever visits inserts an extra
        #: α-priced hop in the jump sequence, so admission must predict
        #: a payoff that covers it: ``(best - cand) * dwell >
        #: admit_margin * alpha``.  At ``alpha=0`` the test is void.
        self.alpha = float(alpha)
        self.admit_margin = float(admit_margin)
        self.seed = int(seed)
        self.next_id = GROWN_ID_BASE
        self.num_proposed = 0
        self.num_admitted = 0

    def propose(self, fc: Forecast,
                existing_metas: Sequence[layouts.PartitionMetadata],
                ) -> Optional[layouts.Layout]:
        """Build and vet one candidate for the forecast; None if rejected.

        The tree is built on *half* the forecast sample and vetted on the
        held-out half — scoring on the training queries would admit every
        tree (a qd-tree trivially crushes the exact predicates it was cut
        from), flooding the D-UMTS with near-duplicates whose counters
        dilute the α budget (every active state accrues on every query).
        Admission requires the held-out mean cost to undercut the best
        existing state by ``gain`` relative *and* that best existing cost
        to exceed ``cost_floor`` — a regime some registered layout already
        serves cheaply is not worth another state.
        """
        if len(fc.queries) < self.min_queries:
            return None
        self.num_proposed += 1
        train = fc.queries[::2]
        test = fc.queries[1::2]
        q_lo, q_hi = wl.stack_queries(test)
        best = min(
            (float(layouts.eval_cost(m, q_lo, q_hi).mean())
             for m in existing_metas), default=np.inf)
        if best <= self.cost_floor:
            return None
        cand = qdtree.build_qdtree_layout(
            self.next_id, self.data, train, self.target_partitions,
            seed=self.seed, name=f"grown#{self.next_id}")
        cand_cost = float(layouts.eval_cost(cand.meta, q_lo, q_hi).mean())
        if cand_cost >= (1.0 - self.gain) * best:
            return None                     # id reused by the next proposal
        if (best - cand_cost) * fc.dwell <= self.admit_margin * self.alpha:
            return None                     # payoff won't cover the α hop
        self.next_id += 1
        self.num_admitted += 1
        return cand

    def info(self) -> dict:
        return {"grown_proposed": self.num_proposed,
                "grown_admitted": self.num_admitted}


def grown_ids(state_ids) -> List[int]:
    """The subset of ``state_ids`` minted by a grower."""
    return [s for s in state_ids if s >= GROWN_ID_BASE]
