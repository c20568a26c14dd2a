"""ForecastPolicy: α-safe predictive wrapper around the reactive OREO loop.

Wraps an :class:`repro_torch.engine.policies.OreoPolicy` and adds two
predictive behaviors on top of its unchanged reactive machinery:

* **Pre-positioning** — when the forecaster predicts a regime whose best
  layout differs from the current decision state and the predicted saving
  justifies the price (``saving_per_query * dwell > margin * α``), the
  policy deterministically moves the D-UMTS to that state
  (:meth:`repro_torch.core.mts.DynamicUMTS.force_move`) and charges a
  normal α-priced, Δ-delayed reorganization through the engine — the
  identical governor/scheduler/micro-move path reactive jumps take, so
  every safety property of that path (charge ledgers, deferral semantics,
  incremental execution) carries over untouched.
* **State growth** — new forecasts are offered to a
  :class:`repro_torch.forecast.grower.QdTreeGrower`; admitted layouts
  join the D-UMTS state space and the backend's StateMatrix plane mid-run
  (the dynamic-state events every mirror already consumes).

**The worst-case envelope.**  Pre-positioning spend is hard-clamped:
a new pre-position is allowed only while

    ``prepositions + 1 <= budget_frac * reactive_moves``

so cumulative pre-position charges never exceed ``budget_frac`` of what
the reactive policy is provably allowed to spend (OReO's Theorem IV.1
envelope) — an always-wrong forecaster degrades the trace by at most a
constant factor of the reactive movement budget, never unboundedly.
Each wrong pre-position additionally costs at most α of excess query
cost before the mispredicted state's counter fills plus one α corrective
jump, both already accounted by the D-UMTS analysis.  With
``budget_frac=0`` and ``grow=False`` the wrapper consumes no randomness
and issues no moves: the trace is *bitwise identical* to the bare inner
policy (golden-tested).

The wrapper is picklable and deterministic; it deliberately does **not**
implement ``decide_frames``, so the fleet's batched path primes costs
per event and falls back to the exact per-event machinery — loop and
``run_batched`` traces stay bit-identical even while grown states churn
the plane mid-stream (plane-version checks invalidate stale primes).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import layouts, workload as wl
from repro_torch.engine.policies import Decision

from .grower import QdTreeGrower
from .predictors import EwmaMixtureForecaster, Forecast, template_key


@dataclasses.dataclass
class ForecastConfig:
    """Knobs of the predictive plane (the α-safety clamp included)."""

    lead: int = 16              # steps ahead forecasts target
    forecast_every: int = 10    # recompute the forecast every N queries
    #: Pre-position only when ``saving_per_query * dwell > margin * α``.
    margin: float = 0.5
    #: Margin for trend-source forecasts.  A trend fires mid-drift where
    #: the mixture shifts a little every horizon — per-event savings are
    #: structurally smaller than at a periodic phase boundary, so the
    #: same bar would suppress exactly the moves drift forecasting is
    #: for; the mixture-weighted scoring already discounts the upside.
    trend_margin: float = 0.25
    #: Hard clamp: prepositions+1 <= budget_frac * reactive_moves.  0
    #: disables pre-positioning entirely (bitwise-reactive trace).
    budget_frac: float = 1.0
    min_gap: int = 8            # min queries between pre-positions
    grow: bool = True           # offer forecasts to the qd-tree grower
    #: Forecast sources eligible for growth.  Periodic forecasts describe
    #: *recurring* regimes the reactive LayoutManager has already seen and
    #: covered from its window, so growing for them just dilutes the
    #: D-UMTS (every active state's counter accrues on every query);
    #: trend forecasts describe *novel* rising regimes the window hasn't
    #: caught up with yet — the gap growth exists to close.
    grow_sources: Tuple[str, ...] = ("trend", "adversarial")
    max_grown: int = 3          # live grown states per tenant
    grow_min_queries: int = 8   # forecast sample floor for growing
    grow_gain: float = 0.25     # held-out relative-cost bar for admission
    grow_cost_floor: float = 0.15   # best-existing cost bar for admission
    #: Retire a grown state once the decision plane hasn't selected it
    #: for this many queries — an idle grown state is pure D-UMTS
    #: dilution (its counter still accrues on every query).
    grow_retire_after: int = 256


class ForecastPolicy:
    """Predictive decision layer over an inner (reactive) OREO policy.

    ``inner`` must expose the OreoPolicy surface (``dumts``, ``manager``,
    ``config``, ``bind``/``decide``/``info``); the default forecaster is
    an :class:`repro_torch.forecast.predictors.EwmaMixtureForecaster` and
    the default grower builds qd-trees over the inner manager's table.
    """

    def __init__(self, inner, forecaster=None,
                 config: Optional[ForecastConfig] = None,
                 grower: Optional[QdTreeGrower] = None):
        self.inner = inner
        self.config = config or ForecastConfig()
        self.alpha = inner.alpha
        self.name = f"Forecast+{inner.name}"
        self.forecaster = forecaster or EwmaMixtureForecaster()
        mgr = getattr(inner, "manager", None)
        if grower is None and mgr is not None:
            grower = QdTreeGrower(
                mgr.data, mgr.config.target_partitions,
                min_queries=self.config.grow_min_queries,
                gain=self.config.grow_gain,
                cost_floor=self.config.grow_cost_floor,
                alpha=inner.alpha,
                seed=getattr(inner.config, "seed", 0) + 101)
        self.grower = grower

        self._fc: Optional[Forecast] = None
        self._fc_bounds: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._pred_cost: Dict[int, float] = {}
        self._grown: List[int] = []         # live grown ids, oldest first
        self._grown_key: Dict[int, Tuple] = {}   # grown id -> forecast key
        self._grown_used: Dict[int, int] = {}    # grown id -> last current
        self._pending_checks: Deque[Tuple[int, Tuple]] = collections.deque()
        self._last_pre = -(10 ** 9)
        self._index = -1
        #: Per-target cooldown: after pre-positioning to a state, don't
        #: pre-position to it again for ~one regime dwell.  If the move
        #: was wrong and the reactive machinery jumped away, retrying the
        #: same target immediately is the ping-pong the clamp should not
        #: have to absorb; if it was right, there is nothing to retry.
        self._cooldown: Dict[int, int] = {}
        self.num_forecasts = 0
        self.prepositions = 0
        self.forecast_checks = 0
        self.forecast_hits = 0

    # ------------------------------------------------------------------
    @property
    def reactive_moves(self) -> int:
        """Moves the inner D-UMTS made on its own (the envelope anchor)."""
        return self.inner.dumts.num_moves - self.prepositions

    def bind(self, backend) -> int:
        return self.inner.bind(backend)

    # ------------------------------------------------------------------
    def _predicted_cost(self, sid: int, backend) -> float:
        c = self._pred_cost.get(sid)
        if c is None:
            q_lo, q_hi = self._fc_bounds
            c = float(layouts.eval_cost(backend.get(sid).meta,
                                        q_lo, q_hi).mean())
            self._pred_cost[sid] = c
        return c

    def _maybe_grow(self, fc: Forecast, backend) -> None:
        dumts = self.inner.dumts
        if fc.source not in self.config.grow_sources:
            return
        if any(self._grown_key.get(g) == fc.key for g in self._grown):
            return      # this regime already has a live grown layout
        existing = [backend.get(s).meta for s in sorted(dumts.states)
                    if backend.has(s)]
        cand = self.grower.propose(fc, existing)
        if cand is None:
            return
        # Defer activation to the next phase reset: a mid-phase grown
        # state is a preferred jump target (unseen states score an
        # optimistic transition weight) for a regime that hasn't arrived.
        dumts.add_state(cand.layout_id, admission="defer")
        backend.register(cand)
        self._grown.append(cand.layout_id)
        self._grown_key[cand.layout_id] = fc.key
        self._grown_used[cand.layout_id] = self._index
        while len(self._grown) > self.config.max_grown:
            victim = next((g for g in self._grown
                           if g != dumts.current_state), None)
            if victim is None:
                break
            self._drop_grown(victim, backend)

    def _drop_grown(self, sid: int, backend) -> None:
        self._grown.remove(sid)
        self._grown_key.pop(sid, None)
        self._grown_used.pop(sid, None)
        self.inner.dumts.remove_state(sid)
        backend.deregister(sid)

    def _retire_idle_grown(self, index: int, backend) -> None:
        """Evict grown states the decision plane has stopped choosing.

        Once the reactive LayoutManager catches up with a drift (its
        window now *observes* the regime the forecast anticipated), its
        own candidate supersedes the grown layout — which then sits in
        the state space accruing counter mass on every query and
        fattening every jump distribution, paying for nothing.
        """
        limit = self.config.grow_retire_after
        cur = self.inner.dumts.current_state
        for sid in list(self._grown):
            if sid == cur:
                continue
            if index - self._grown_used.get(sid, index) > limit:
                self._drop_grown(sid, backend)

    # ------------------------------------------------------------------
    def decide(self, index: int, query: wl.Query, backend) -> Decision:
        cfg = self.config
        realized = template_key(query)
        while self._pending_checks and self._pending_checks[0][0] <= index:
            _, predicted = self._pending_checks.popleft()
            self.forecast_checks += 1
            if predicted == realized:
                self.forecast_hits += 1

        self.forecaster.observe(query)
        self._index = index
        if (index + 1) % cfg.forecast_every == 0:
            if cfg.grow and self.grower is not None:
                self._retire_idle_grown(index, backend)
            fc = self.forecaster.forecast(cfg.lead)
            if fc is not None:
                self._fc = fc
                self._fc_bounds = wl.stack_queries(fc.queries)
                self._pred_cost = {}
                self.num_forecasts += 1
                # fc.lead is the *effective* lead (forecasters clamp the
                # requested lead to the observed regime scale) — score
                # accuracy at the horizon actually predicted.
                self._pending_checks.append((index + fc.lead, fc.key))
                if cfg.grow and self.grower is not None:
                    self._maybe_grow(fc, backend)

        d = self.inner.decide(index, query, backend)
        if d.state in self._grown_used:
            self._grown_used[d.state] = index

        fc = self._fc
        if fc is None or d.reorg or fc.key == realized:
            # Only act while the prediction differs from what is realized
            # *now*: mid-regime there is nothing to pre-position for, and
            # once the predicted regime arrives the reactive machinery is
            # already looking at its true costs.
            return d
        dumts = self.inner.dumts
        cand = [s for s in dumts.active if backend.has(s)]
        if len(cand) < 2 or d.state not in cand:
            return d
        # Deterministic argmin over predicted per-query cost; ties break
        # to the smallest state id (tuple order).
        best_cost, best_sid = min(
            (self._predicted_cost(s, backend), s) for s in sorted(cand))
        saving = self._predicted_cost(d.state, backend) - best_cost
        # Counters accrue on *every* active state, so a target whose
        # counter is nearly full gets force-retired by the D-UMTS almost
        # immediately — its remaining headroom caps how long the
        # pre-position can actually hold, whatever the forecast's dwell.
        headroom = self.alpha - dumts.counters.get(best_sid, 0.0)
        dwell = min(fc.dwell, headroom / max(best_cost, 1e-6))
        margin = cfg.trend_margin if fc.source == "trend" else cfg.margin
        if (best_sid != d.state
                and saving * dwell > margin * self.alpha
                and index - self._last_pre >= cfg.min_gap
                and index >= self._cooldown.get(best_sid, -1)
                and self.prepositions + 1
                    <= cfg.budget_frac * self.reactive_moves):
            dumts.force_move(best_sid)
            self.prepositions += 1
            self._last_pre = index
            self._cooldown[best_sid] = index + max(cfg.min_gap,
                                                   int(fc.dwell))
            return Decision(state=best_sid, reorg=True,
                            added=d.added, removed=d.removed)
        return d

    # ------------------------------------------------------------------
    def info(self) -> dict:
        out = dict(self.inner.info())
        out.update(self.forecaster.info())
        if self.grower is not None:
            out.update(self.grower.info())
        out.update({
            "forecasts": self.num_forecasts,
            "prepositions": self.prepositions,
            "reactive_moves": self.reactive_moves,
            "forecast_checks": self.forecast_checks,
            "forecast_hits": self.forecast_hits,
            "forecast_accuracy": (self.forecast_hits / self.forecast_checks
                                  if self.forecast_checks else None),
        })
        return out
