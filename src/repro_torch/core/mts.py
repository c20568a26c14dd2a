"""D-UMTS: the dynamic uniform Metrical Task System at the heart of OREO.

Implements Algorithms 1-4 of the paper:

* Per-state counters accumulate service costs c(s, q) for every *active* state.
* A state becomes inactive ("full") once its counter reaches alpha.
* When the current state goes full, jump to a uniformly random (or
  predictor-biased, §IV-C) active state, paying movement cost alpha.
* When no active state remains, a new *phase* starts: all counters reset, and
  state additions deferred mid-phase become visible (Algorithm 4).
* Mid-phase deletion sets the deleted state's counter to alpha; deleting the
  current state forces an immediate jump.

The "stay at phase start" optimization (§IV-A, last paragraph) keeps the
current state across a phase boundary instead of re-randomizing -- the paper
notes this does not change the asymptotic competitive ratio but measurably
cuts reorganization cost.

Competitive ratio: 2*H(|S_max|) (Theorem IV.1), predictor-improved via
Theorem IV.2.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import numpy as np

# A transition distribution builder: maps {state_id: weight in [0,1]} of the
# *active* states to a probability vector over those states (same key order).
TransitionFn = Callable[[Dict[int, float]], Dict[int, float]]


def uniform_transition(weights: Dict[int, float]) -> Dict[int, float]:
    n = len(weights)
    return {s: 1.0 / n for s in weights}


@dataclasses.dataclass
class MTSEvent:
    """One reorganization decision (state switch)."""
    query_idx: int
    from_state: int
    to_state: int
    reason: str            # "counter_full" | "state_deleted" | "phase_reset"


class DynamicUMTS:
    """Online decision maker over a dynamic state space (Algorithm 4).

    Usage: call :meth:`observe` once per query with the service-cost map of
    *all currently known* states; call :meth:`add_state` / :meth:`remove_state`
    for state-management queries at any point.  ``current_state`` is the state
    the system is in *before* servicing the next query.
    """

    def __init__(self, alpha: float, initial_states: List[int],
                 seed: int = 0,
                 transition_fn: Optional[TransitionFn] = None,
                 stay_on_phase_start: bool = True,
                 midphase_admission: str = "median"):
        """``midphase_admission``: how state additions mid-phase are handled.

        * ``"defer"``  -- Algorithm 4 verbatim: the new state only becomes
          available at the next phase.
        * ``"median"`` -- §IV-C optimization: the state joins the current
          phase immediately, its counter initialized to the median of the
          phase costs incurred so far by existing active states.
        """
        if alpha <= 1:
            raise ValueError("alpha must exceed 1 (reorg costlier than scan)")
        if not initial_states:
            raise ValueError("need at least one initial state")
        if midphase_admission not in ("defer", "median"):
            raise ValueError(f"bad midphase_admission: {midphase_admission}")
        self.alpha = float(alpha)
        self.rng = np.random.default_rng(seed)
        self.transition_fn = transition_fn or uniform_transition
        self.stay_on_phase_start = stay_on_phase_start
        self.midphase_admission = midphase_admission

        self.states: set[int] = set(initial_states)
        self.counters: Dict[int, float] = {s: 0.0 for s in initial_states}
        self.active: set[int] = set(initial_states)
        self.pending_additions: set[int] = set()
        self.current_state: int = int(self.rng.choice(sorted(self.states)))

        self.query_idx = 0
        self.phase = 0
        self.max_state_space = len(self.states)
        self.events: List[MTSEvent] = []
        self.history: List[int] = [self.current_state]
        # Per-phase bookkeeping for predictors: per-state (cost sum, #queries
        # observed while active) -> last phase's *average* cost per query,
        # whose complement is the paper's "average fraction of data skipped".
        self.last_phase_avg_costs: Dict[int, float] = {}
        self._phase_costs: Dict[int, float] = {s: 0.0 for s in initial_states}
        self._phase_counts: Dict[int, int] = {s: 0 for s in initial_states}

    # ------------------------------------------------------------------
    # State-management queries (the D in D-UMTS)
    # ------------------------------------------------------------------
    def add_state(self, state_id: int,
                  admission: Optional[str] = None) -> None:
        """Add a state (Algorithm 4, line 12).

        ``defer`` mode parks it until the next phase; ``median`` mode (§IV-C)
        admits it into the running phase with a median-initialized counter.
        ``admission`` overrides the instance-wide mode for this one state —
        predictive growers defer their speculative states to the next phase
        (a fresh state is a preferred jump target, so mid-phase admission
        would pull exploratory jumps toward a layout built for a regime
        that hasn't arrived yet) while manager-driven additions keep the
        configured behavior.
        """
        if state_id in self.states or state_id in self.pending_additions:
            return
        if (admission or self.midphase_admission) == "defer":
            self.pending_additions.add(state_id)
        else:
            active_costs = [self.counters[s] for s in self.active]
            init = float(np.median(active_costs)) if active_costs else 0.0
            self.states.add(state_id)
            self.counters[state_id] = init
            self._phase_costs[state_id] = init
            self._phase_counts.setdefault(state_id, 0)
            if init < self.alpha:
                self.active.add(state_id)
        self.max_state_space = max(
            self.max_state_space, len(self.states) + len(self.pending_additions))

    def remove_state(self, state_id: int) -> None:
        """Deletion marks the counter full; deleting the current state forces
        a jump (Algorithm 4, lines 5-11)."""
        self.pending_additions.discard(state_id)
        if state_id not in self.states:
            return
        if len(self.states) == 1:
            raise ValueError("cannot remove the last remaining state")
        self.states.discard(state_id)
        self.active.discard(state_id)
        self.counters[state_id] = self.alpha
        if not self.active:
            self._reset_phase(reason="state_deleted")
        if state_id == self.current_state:
            self._jump(reason="state_deleted")

    def force_move(self, state_id: int, reason: str = "preposition") -> None:
        """Deterministically move the decision maker to an active state.

        The hook behind predictive pre-positioning
        (:class:`repro_torch.forecast.ForecastPolicy`): the caller pays the
        usual movement cost α for the emitted event; counters, phases and
        the rng stream are untouched, so a wrapper that never calls this is
        bitwise indistinguishable from the bare D-UMTS.  Moving to the
        current state is a no-op (no event, nothing charged).
        """
        if state_id not in self.active:
            raise ValueError(f"cannot force-move to inactive state "
                             f"{state_id} (active: {sorted(self.active)})")
        if state_id == self.current_state:
            return
        self.events.append(MTSEvent(self.query_idx, self.current_state,
                                    state_id, reason))
        self.current_state = state_id

    # ------------------------------------------------------------------
    # Query processing
    # ------------------------------------------------------------------
    def observe(self, costs: Dict[int, float]) -> int:
        """Process one query given service costs for (at least) all active
        states.  Returns the state the system is in while servicing the query
        (counters update first, as in Algorithm 3 -- the returned state is the
        state *after* any forced transitions for this query)."""
        for s in list(self.active):
            c = float(costs[s])
            if not (0.0 <= c <= 1.0 + 1e-9):
                raise ValueError(f"cost out of [0,1]: state {s} -> {c}")
            self.counters[s] += c
            self._phase_costs[s] = self._phase_costs.get(s, 0.0) + c
            self._phase_counts[s] = self._phase_counts.get(s, 0) + 1
        self.active = {s for s in self.active if self.counters[s] < self.alpha}
        if self.current_state not in self.active:
            if not self.active:
                self._reset_phase(reason="phase_reset")
                if not self.stay_on_phase_start:
                    self._jump(reason="phase_reset")
            else:
                self._jump(reason="counter_full")
        self.query_idx += 1
        self.history.append(self.current_state)
        return self.current_state

    # ------------------------------------------------------------------
    # Internals
    # ------------------------------------------------------------------
    def _reset_phase(self, reason: str) -> None:
        self.states |= self.pending_additions
        self.pending_additions.clear()
        self.last_phase_avg_costs = {
            s: self._phase_costs[s] / max(self._phase_counts.get(s, 0), 1)
            for s in self._phase_costs if self._phase_counts.get(s, 0) > 0
        }
        self._phase_costs = {s: 0.0 for s in self.states}
        self._phase_counts = {s: 0 for s in self.states}
        self.counters = {s: 0.0 for s in self.states}
        self.active = set(self.states)
        self.phase += 1
        self.max_state_space = max(self.max_state_space, len(self.states))

    def _jump(self, reason: str) -> None:
        # Weight = average fraction of data skipped in the last phase
        # (paper §IV-C); states unseen last phase (freshly generated from the
        # current window) get the optimistic weight 1.
        candidates = {
            s: 1.0 - min(self.last_phase_avg_costs.get(s, 0.0), 1.0)
            for s in self.active
        }
        probs = self.transition_fn(candidates)
        keys = sorted(probs)
        p = np.array([max(probs[s], 0.0) for s in keys], dtype=np.float64)
        total = p.sum()
        p = p / total if total > 0 else np.full(len(keys), 1.0 / len(keys))
        new_state = int(self.rng.choice(keys, p=p))
        self.events.append(MTSEvent(self.query_idx, self.current_state,
                                    new_state, reason))
        self.current_state = new_state

    # ------------------------------------------------------------------
    # Reporting
    # ------------------------------------------------------------------
    @property
    def num_moves(self) -> int:
        return len(self.events)

    def competitive_bound(self) -> float:
        """2*H(|S_max|) from Theorem IV.1."""
        n = max(self.max_state_space, 1)
        return 2.0 * sum(1.0 / i for i in range(1, n + 1))


def harmonic(n: int) -> float:
    return sum(1.0 / i for i in range(1, n + 1))


def theorem_iv1_bound(s_max: int) -> float:
    return 2.0 * harmonic(max(s_max, 1))


def theorem_iv2_bound(n: int, beta: float) -> float:
    """O(log_{1/(1-beta)} n): expected transitions with a beta-good predictor."""
    if not 0.0 < beta < 1.0:
        raise ValueError("beta in (0,1)")
    return math.log(max(n, 2)) / math.log(1.0 / (1.0 - beta))
