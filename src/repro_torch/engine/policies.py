"""Layout policies: the decision layer plugged into the :class:`LayoutEngine`.

A :class:`Policy` decides, one query at a time, which layout state the system
should be in and when a reorganization is charged; the engine turns those
decisions into physical actions against a :class:`StorageBackend`.  OREO and
every method of comparison from the paper (§VI-A3, §VI-C) are policies over
the *same* shared loop.  Decisions are host logic, carried over line for line
from the reference; every cost they read comes from the device scan.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import baselines as _baselines
from repro_torch.core import layout_manager as lm
from repro_torch.core import layouts, mts, oreo, predictors, sampling
from repro_torch.core import workload as wl


@dataclasses.dataclass
class Decision:
    """One per-query decision emitted by a policy.

    ``state`` is the decision state the system is in while servicing the
    query.  ``reorg`` charges one reorganization (cost alpha) *now*; the
    engine applies the physical swap after its configured Δ-delay.  ``added``
    / ``removed`` report state-management events for tracing.
    """

    state: int
    reorg: bool = False
    added: List[int] = dataclasses.field(default_factory=list)
    removed: List[int] = dataclasses.field(default_factory=list)


@runtime_checkable
class Policy(Protocol):
    """Decision-layer contract consumed by :class:`LayoutEngine`.

    * ``name`` labels run results; ``alpha`` is the reorganization cost the
      engine charges per ``Decision.reorg``.
    * :meth:`bind` is called once before the first query: the policy
      registers its initial layout(s) with the backend and returns the state
      id the engine should activate as the initial serving layout.
    * :meth:`decide` is called once per query *before* the query is served.
      The policy may register/deregister candidate layouts on the backend
      and should use ``backend.estimate_costs`` (batched, metadata-only) for
      its decision making — never the physical table.
    * :meth:`info` contributes diagnostics to ``RunResult.info``.
    """

    name: str
    alpha: float

    def bind(self, backend) -> int: ...

    def decide(self, index: int, query: wl.Query, backend) -> Decision: ...

    def info(self) -> dict: ...


class BatchablePolicy(Policy, Protocol):
    """A policy whose decision rule can be applied to a block of frames.

    :meth:`repro_torch.engine.FleetEngine.run_batched` resolves whole
    no-swap passes without per-event Python for fleets where every policy
    exposes :meth:`decide_frames`.  The contract:

    * **pure**: no backend mutation (register/deregister) and no policy
      state update — the engine may discard the result and replay the same
      events through per-event :meth:`Policy.decide` (it does so whenever
      any row charges a reorganization, so swap frames keep the exact
      bookkeeping path and traces stay bit-identical);
    * **bit-identical**: row ``r`` of the result must equal the
      :class:`Decision` that sequential ``decide`` calls would produce
      given the same cost vectors — the rule may only depend on the costs
      and policy state, never on the step index;
    * ``costs`` is ``(k, n_slots)`` in :class:`StateMatrix` slot order
      (exactly what ``backend.estimate_vector`` returns per query); the
      returned ``states`` is ``(k,)`` decision state ids and ``reorg`` is
      a ``(k,)`` bool mask, or ``None`` meaning "never charges".
    """

    def decide_frames(self, costs: np.ndarray, backend): ...


# ---------------------------------------------------------------------------
# OREO (the paper's full system: D-UMTS + LAYOUT MANAGER)
# ---------------------------------------------------------------------------

class OreoPolicy:
    """The paper's online loop: LayoutManager candidates + D-UMTS switching."""

    name = "OREO"

    def __init__(self, data: torch.Tensor, initial_layout: layouts.Layout,
                 generator: lm.GeneratorFn,
                 config: Optional[oreo.OreoConfig] = None):
        self.config = config or oreo.OreoConfig()
        self.alpha = self.config.alpha
        self.initial_layout = initial_layout
        self.manager = lm.LayoutManager(data, generator, initial_layout,
                                        self.config.manager,
                                        seed=self.config.seed)
        self.dumts = mts.DynamicUMTS(
            alpha=self.config.alpha,
            initial_states=[initial_layout.layout_id],
            seed=self.config.seed,
            transition_fn=predictors.gamma_biased_transition(self.config.gamma),
            stay_on_phase_start=self.config.stay_on_phase_start,
        )

    def bind(self, backend) -> int:
        backend.register(self.initial_layout)
        return self.dumts.current_state

    def decide(self, index: int, query: wl.Query, backend) -> Decision:
        added, removed = self.manager.on_query(query, self.dumts.current_state)
        for sid in added:
            self.dumts.add_state(sid)
        for sid in removed:
            self.dumts.remove_state(sid)
        for sid in added:
            if sid in self.manager.store:       # not evicted in the same step
                backend.register(self.manager.store[sid])
        for sid in removed:
            backend.deregister(sid)

        # Service-cost estimates for all states known to the decision maker,
        # one batched metadata-only call; states not yet generated (deferred
        # additions) are pessimistically priced at a full scan.
        sids = set(self.dumts.states) | set(self.dumts.pending_additions)
        known = [s for s in sids if backend.has(s)]
        estimates = backend.estimate_costs(known, query)
        costs = {s: estimates.get(s, 1.0) for s in sids}

        prev_moves = self.dumts.num_moves
        state = self.dumts.observe(costs)
        return Decision(state=state, reorg=self.dumts.num_moves > prev_moves,
                        added=added, removed=removed)

    def info(self) -> dict:
        return {
            "phases": self.dumts.phase,
            "max_state_space": self.dumts.max_state_space,
            "competitive_bound": self.dumts.competitive_bound(),
            "candidates_generated": self.manager.num_generated,
            "candidates_admitted": self.manager.num_admitted,
        }


# ---------------------------------------------------------------------------
# Online baselines (same candidate cadence as OREO, different switching rule)
# ---------------------------------------------------------------------------

class GreedyPolicy:
    """Switch to any fresh candidate that beats the current layout on the
    sliding window, ignoring reorganization cost (§VI-A3)."""

    name = "Greedy"

    def __init__(self, data: torch.Tensor, initial_layout: layouts.Layout,
                 generator: lm.GeneratorFn, alpha: float,
                 mgr_cfg: Optional[lm.LayoutManagerConfig] = None):
        self.data = data
        self.generator = generator
        self.alpha = alpha
        self.cfg = mgr_cfg or lm.LayoutManagerConfig()
        self.window: sampling.SlidingWindow[wl.Query] = sampling.SlidingWindow(
            self.cfg.window_size)
        self.current = initial_layout
        self.next_id = initial_layout.layout_id + 1

    def bind(self, backend) -> int:
        backend.register(self.current)
        return self.current.layout_id

    def decide(self, index: int, query: wl.Query, backend) -> Decision:
        self.window.add(query)
        added: List[int] = []
        removed: List[int] = []
        reorg = False
        if ((index + 1) % self.cfg.gen_every == 0
                and len(self.window) >= self.cfg.window_size // 2):
            qs = self.window.sample()
            cand = self.generator(self.next_id, self.data, qs,
                                  self.cfg.target_partitions)
            self.next_id += 1
            w_lo, w_hi = wl.stack_queries(qs)
            cur_cost = layouts.eval_cost(self.current.meta, w_lo, w_hi).mean()
            cand_cost = layouts.eval_cost(cand.meta, w_lo, w_hi).mean()
            if cand_cost < cur_cost:
                old = self.current.layout_id
                self.current = cand
                backend.register(cand)
                backend.deregister(old)
                added.append(cand.layout_id)
                removed.append(old)
                reorg = True
        return Decision(state=self.current.layout_id, reorg=reorg,
                        added=added, removed=removed)

    def info(self) -> dict:
        return {}


class RegretPolicy:
    """Switch once a candidate's cumulative query-cost saving over the
    current layout exceeds alpha (TASM-style, §VI-A3)."""

    name = "Regret"

    def __init__(self, data: torch.Tensor, initial_layout: layouts.Layout,
                 generator: lm.GeneratorFn, alpha: float,
                 mgr_cfg: Optional[lm.LayoutManagerConfig] = None,
                 max_candidates: int = 8):
        self.data = data
        self.generator = generator
        self.alpha = alpha
        self.cfg = mgr_cfg or lm.LayoutManagerConfig()
        self.max_candidates = max_candidates
        self.window: sampling.SlidingWindow[wl.Query] = sampling.SlidingWindow(
            self.cfg.window_size)
        self.current = initial_layout
        self.next_id = initial_layout.layout_id + 1
        self.candidates: Dict[int, layouts.Layout] = {}
        self.cum_saving: Dict[int, float] = {}

    def bind(self, backend) -> int:
        backend.register(self.current)
        return self.current.layout_id

    def decide(self, index: int, query: wl.Query, backend) -> Decision:
        self.window.add(query)
        added: List[int] = []
        removed: List[int] = []
        reorg = False
        if ((index + 1) % self.cfg.gen_every == 0
                and len(self.window) >= self.cfg.window_size // 2):
            cand = self.generator(self.next_id, self.data,
                                  self.window.sample(),
                                  self.cfg.target_partitions)
            self.candidates[self.next_id] = cand
            self.cum_saving[self.next_id] = 0.0
            backend.register(cand)
            added.append(self.next_id)
            self.next_id += 1
            if len(self.candidates) > self.max_candidates:
                oldest = min(self.candidates)
                del self.candidates[oldest]
                del self.cum_saving[oldest]
                backend.deregister(oldest)
                removed.append(oldest)

        sids = [self.current.layout_id] + list(self.candidates)
        estimates = backend.estimate_costs(sids, query)
        cur_cost = estimates[self.current.layout_id]
        for sid in self.candidates:
            self.cum_saving[sid] += cur_cost - estimates[sid]
        if self.cum_saving:
            best = max(self.cum_saving, key=self.cum_saving.get)
            if self.cum_saving[best] > self.alpha:
                old = self.current.layout_id
                self.current = self.candidates.pop(best)
                self.cum_saving = {sid: 0.0 for sid in self.candidates}
                backend.deregister(old)
                removed.append(old)
                reorg = True
        return Decision(state=self.current.layout_id, reorg=reorg,
                        added=added, removed=removed)

    def info(self) -> dict:
        return {}


class ThresholdSwitchPolicy:
    """Argmin-with-hysteresis over a fixed state space, batch-decidable.

    Serves from the current state and charges a reorganization to the
    cheapest candidate whenever its estimated cost undercuts the current
    state's by more than ``threshold``.  The rule is a pure function of
    the packed cost vector, so it implements the
    :class:`BatchablePolicy` contract: :meth:`decide_frames` resolves a
    whole block of frames at once, bit-identically to sequential
    :meth:`decide` calls.  Needs a matrix-backed backend
    (``backend.estimate_vector``); candidate slots are the bind-order
    registrations ``0..S-1`` (the serving shadow, if any, registers
    after them and is never considered).
    """

    name = "threshold-switch"

    def __init__(self, state_space: List[layouts.Layout], alpha: float,
                 threshold: float = 0.0):
        if not state_space:
            raise ValueError("state_space must not be empty")
        self.alpha = float(alpha)
        self.threshold = float(threshold)
        self.space = list(state_space)
        self.ids = np.asarray([lay.layout_id for lay in self.space],
                              dtype=np.int64)
        self.num = len(self.space)
        self._cur_slot = 0
        self.switches = 0

    def bind(self, backend) -> int:
        for lay in self.space:
            backend.register(lay)
        self._cur_slot = 0
        return int(self.ids[0])

    def _switch_slot(self, costs_row: np.ndarray) -> int:
        """Slot to switch to, or -1 to stay (one row of the pure rule)."""
        sub = costs_row[:self.num]
        best = int(sub.argmin())
        if sub[best] < sub[self._cur_slot] - self.threshold:
            return best
        return -1

    def decide(self, index: int, query: wl.Query, backend) -> Decision:
        costs = np.asarray(backend.estimate_vector(query))
        slot = self._switch_slot(costs)
        if slot >= 0:
            self._cur_slot = slot
            self.switches += 1
            return Decision(state=int(self.ids[slot]), reorg=True)
        return Decision(state=int(self.ids[self._cur_slot]))

    def decide_frames(self, costs: np.ndarray, backend):
        """(k, n_slots) primed costs -> (states, reorg), no side effects.

        Fast path: when no row would trigger a switch from the current
        state (the common case between drifts), the answer is one
        vectorized comparison.  Otherwise the sequential evolution is
        simulated without committing — the fleet replays the pass through
        :meth:`decide` anyway whenever any row charges.
        """
        sub = costs[:, :self.num]
        k = sub.shape[0]
        cur = self._cur_slot
        if not (sub.min(axis=1) < sub[:, cur] - self.threshold).any():
            return np.full(k, self.ids[cur], dtype=np.int64), None
        states = np.empty(k, dtype=np.int64)
        reorg = np.zeros(k, dtype=bool)
        for r in range(k):
            sub_r = sub[r]
            best = int(sub_r.argmin())
            if sub_r[best] < sub_r[cur] - self.threshold:
                cur = best
                reorg[r] = True
            states[r] = self.ids[cur]
        return states, reorg

    def info(self) -> dict:
        return {"threshold": self.threshold, "switches": self.switches}


# ---------------------------------------------------------------------------
# Offline / oracle baselines (workload knowledge)
# ---------------------------------------------------------------------------

class StaticPolicy:
    """One layout optimized for the whole workload; never switches."""

    name = "Static"

    def __init__(self, data: torch.Tensor, stream: wl.WorkloadStream,
                 generator: lm.GeneratorFn, alpha: float,
                 target_partitions: int = 32,
                 layout: Optional[layouts.Layout] = None):
        self.alpha = alpha
        self.layout = layout if layout is not None else generator(
            0, data, stream.queries, target_partitions)

    def bind(self, backend) -> int:
        backend.register(self.layout)
        return self.layout.layout_id

    def decide(self, index: int, query: wl.Query, backend) -> Decision:
        return Decision(state=self.layout.layout_id)

    def info(self) -> dict:
        return {}


class MTSOptimalPolicy:
    """Fixed precomputed state space (best layout per template) + OREO's
    D-UMTS switching; no dynamic state management (§VI-C)."""

    name = "MTS Optimal"

    def __init__(self, data: torch.Tensor, stream: wl.WorkloadStream,
                 generator: lm.GeneratorFn, alpha: float,
                 target_partitions: int = 32, gamma: float = 1.0,
                 seed: int = 0):
        self.alpha = alpha
        per_template = _baselines.per_template_layouts(
            data, stream, generator, target_partitions)
        self.store = {lay.layout_id: lay for lay in per_template.values()}
        self.dumts = mts.DynamicUMTS(
            alpha=alpha, initial_states=sorted(self.store), seed=seed,
            transition_fn=predictors.gamma_biased_transition(gamma))

    def bind(self, backend) -> int:
        for lay in self.store.values():
            backend.register(lay)
        return self.dumts.current_state

    def decide(self, index: int, query: wl.Query, backend) -> Decision:
        costs = backend.estimate_costs(sorted(self.store), query)
        prev_moves = self.dumts.num_moves
        state = self.dumts.observe(costs)
        return Decision(state=state, reorg=self.dumts.num_moves > prev_moves)

    def info(self) -> dict:
        return {
            "phases": self.dumts.phase,
            "max_state_space": self.dumts.max_state_space,
            "competitive_bound": self.dumts.competitive_bound(),
        }


class OfflineOptimalPolicy:
    """Sees the whole stream: per-template layout, switching exactly at
    template boundaries — the lower bound for online methods (§VI-C)."""

    name = "Offline Optimal"

    def __init__(self, data: torch.Tensor, stream: wl.WorkloadStream,
                 generator: lm.GeneratorFn, alpha: float,
                 target_partitions: int = 32):
        self.alpha = alpha
        per_template = _baselines.per_template_layouts(
            data, stream, generator, target_partitions)
        self.store = {lay.layout_id: lay for lay in per_template.values()}
        self._state_per_query = np.zeros(len(stream), dtype=np.int64)
        self._reorg_at: set[int] = set()
        prev_tid = None
        for start, end, tid in stream.segments:
            self._state_per_query[start:end] = per_template[tid].layout_id
            if prev_tid is not None and tid != prev_tid:
                self._reorg_at.add(start)
            prev_tid = tid

    def bind(self, backend) -> int:
        for lay in self.store.values():
            backend.register(lay)
        return int(self._state_per_query[0]) if len(self._state_per_query) \
            else min(self.store)

    def decide(self, index: int, query: wl.Query, backend) -> Decision:
        return Decision(state=int(self._state_per_query[index]),
                        reorg=index in self._reorg_at)

    def info(self) -> dict:
        return {}


def __getattr__(name: str):
    # PEP 562: lazy re-export of the predictive plane (avoids the
    # forecast -> policies -> forecast import cycle).
    if name in ("ForecastPolicy", "ForecastConfig"):
        from repro_torch import forecast as _forecast
        return getattr(_forecast, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
