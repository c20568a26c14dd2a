"""Transition-distribution predictors (paper §IV-C, Theorem IV.2).

The default predictor weights each active state by the fraction of data it
skipped in the *previous phase* and biases the jump distribution as
P(s) ∝ w_s^gamma.  gamma=0 recovers the uniform BLS transition; gamma>0
favors recently-good states, which empirically cuts reorganization cost by
~17-28% (Table II) without hurting query cost.

These are *transition* predictors — they bias where D-UMTS jumps once a
counter fills.  The *workload* predictors that forecast what the next
horizon of queries will look like (and pre-position moves ahead of the
drift) are their own subsystem: :mod:`repro_torch.forecast`.
"""
from __future__ import annotations

from typing import Dict

from . import mts


class GammaBiasedTransition:
    """P(s) ∝ w_s^gamma over the active states; picklable callable.

    The DynamicUMTS passes ``weights[s] = 1 - last_phase_cost(s)/alpha``
    (average fraction skipped proxy); states unseen last phase get weight 1
    (optimistic -- new states are worth exploring, matching the paper's
    median/replay initialization spirit).  A class rather than a closure
    so policies holding it — and whole engines — survive pickling for
    cross-process tenant migration.
    """

    def __init__(self, gamma: float):
        self.gamma = gamma

    def __call__(self, weights: Dict[int, float]) -> Dict[int, float]:
        if self.gamma == 0.0 or not weights:
            return mts.uniform_transition(weights)
        powered = {s: max(w, 1e-6) ** self.gamma
                   for s, w in weights.items()}
        total = sum(powered.values())
        return {s: v / total for s, v in powered.items()}


def gamma_biased_transition(gamma: float) -> mts.TransitionFn:
    return GammaBiasedTransition(gamma)


def median_initialized_counter(existing_phase_costs: Dict[int, float]) -> float:
    """Paper §IV-C: a state added mid-phase can have its counter initialized
    to the median of query costs incurred so far by existing states."""
    if not existing_phase_costs:
        return 0.0
    vals = sorted(existing_phase_costs.values())
    mid = len(vals) // 2
    if len(vals) % 2:
        return vals[mid]
    return 0.5 * (vals[mid - 1] + vals[mid])
