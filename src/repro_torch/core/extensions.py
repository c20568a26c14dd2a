"""Extensions sketched in the paper's §VIII / technical-report appendices.

* :class:`MultiCopyDUMTS` -- Appendix-D direction: with storage budget for
  ``kappa`` simultaneous copies of the dataset, the system *holds* a set of
  kappa layouts, services each query with the cheapest held layout, and pays
  the movement cost only to replace one copy.  Algorithm-4 counters/phases
  are kept per state; a held state is ejected when its counter fills.
* :func:`two_state_asymmetric` -- Appendix-C special case: two states with
  asymmetric switch costs (cf. Bruno-Chaudhuri online physical tuning).  The
  classic work-function rule (switch when accumulated extra cost since last
  switch exceeds the switch cost) is 3-competitive.
* :func:`offline_two_state` -- the optimal offline cost of that case.

Host logic over per-query costs, as in the reference, drawing the same
numpy random streams.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


class MultiCopyDUMTS:
    """D-UMTS with kappa simultaneously-held layouts (storage-for-query)."""

    def __init__(self, alpha: float, initial_states: Sequence[int],
                 kappa: int = 2, seed: int = 0):
        if kappa < 1:
            raise ValueError("kappa >= 1")
        self.alpha = float(alpha)
        self.kappa = kappa
        self.rng = np.random.default_rng(seed)
        self.states: set = set(initial_states)
        self.counters: Dict[int, float] = {s: 0.0 for s in initial_states}
        self.active: set = set(initial_states)
        init = list(initial_states)[:kappa]
        self.held: List[int] = list(init)
        self.moves = 0
        self.phase = 0

    def add_state(self, state_id: int) -> None:
        if state_id in self.states:
            return
        self.states.add(state_id)
        self.counters[state_id] = 0.0
        self.active.add(state_id)

    def observe(self, costs: Dict[int, float]) -> Tuple[int, float]:
        """Returns (serving_state, cost) -- cost = min over held copies."""
        serving = min(self.held, key=lambda s: costs[s])
        c = costs[serving]
        # Counters accumulate the cost each state would incur as the *sole*
        # layout (the Alg. 3 semantics, unchanged).
        for s in list(self.active):
            self.counters[s] += costs[s]
        self.active = {s for s in self.active
                       if self.counters[s] < self.alpha}
        if not self.active:
            self.counters = {s: 0.0 for s in self.states}
            self.active = set(self.states)
            self.phase += 1
        # Replace any held copy whose counter filled.
        for i, s in enumerate(self.held):
            if s not in self.active:
                candidates = [a for a in self.active if a not in self.held]
                if not candidates:
                    continue
                self.held[i] = int(self.rng.choice(sorted(candidates)))
                self.moves += 1
        return serving, c

    @property
    def total_reorg_cost(self) -> float:
        return self.moves * self.alpha


def two_state_asymmetric(costs_a: Sequence[float], costs_b: Sequence[float],
                         alpha_ab: float, alpha_ba: float
                         ) -> Tuple[float, List[int]]:
    """Work-function online algorithm for 2 states with asymmetric switch
    costs.  Switch away from the current state when the accumulated excess
    cost since the last switch exceeds the cost of switching *back and
    forth* is not required -- the one-way switch cost suffices for the
    3-competitive bound in this special case.

    Returns (total cost, per-query state sequence).
    """
    assert len(costs_a) == len(costs_b)
    state = 0
    regret = 0.0
    total = 0.0
    seq: List[int] = []
    for ca, cb in zip(costs_a, costs_b):
        here, there = (ca, cb) if state == 0 else (cb, ca)
        switch_cost = alpha_ab if state == 0 else alpha_ba
        regret = max(0.0, regret + (here - there))
        if regret > switch_cost:
            total += switch_cost
            state = 1 - state
            regret = 0.0
            here = ca if state == 0 else cb
        total += here
        seq.append(state)
    return total, seq


def offline_two_state(costs_a: Sequence[float], costs_b: Sequence[float],
                      alpha_ab: float, alpha_ba: float) -> float:
    """Optimal offline two-state cost via dynamic programming."""
    best = [0.0, alpha_ab]     # start in state 0 by convention
    for ca, cb in zip(costs_a, costs_b):
        best = [
            min(best[0], best[1] + alpha_ba) + ca,
            min(best[1], best[0] + alpha_ab) + cb,
        ]
    return min(best)
