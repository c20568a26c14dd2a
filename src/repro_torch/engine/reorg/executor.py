"""Budgeted migration execution with exact α-charge amortization.

A :class:`ReorgExecutor` sits between a
:class:`repro_torch.engine.LayoutEngine` running in ``incremental=True``
mode and its storage backend.  The engine's decision layer is untouched — reorganizations are still *charged* α at
decision time, exactly as in the atomic loop, so the paper's worst-case
accounting is preserved under every budget.  What changes is the physical
side: instead of one wholesale swap at the Δ-due step, the executor

1. **begins** a migration at the step the atomic swap would have applied
   (never earlier — the Δ-delay and every scheduler-deferral rule are the
   same code path as the atomic engine),
2. **advances** it a micro-batch at a time: each engine step it asks the
   governor/scheduler for a row budget (``grant_rows``), completes planned
   moves in greedy order as their row cost is covered, and installs the
   resulting hybrid zone maps on the backend,
3. **completes** by activating the target layout through the backend's
   normal path, so the post-migration state is bitwise the atomic one.

With an infinite per-tick budget every migration begins and completes
within the step the atomic swap would have landed, making the whole
incremental engine trace bit-identical to the atomic engine's.

Charge ledger
-------------
Each migration keeps an amortization schedule of the single atomic α:
every advancing step appends ``(index, rows_moved, charge)`` with the
charge proportional to rows moved, and the increments are constructed so
that their *left-to-right float sum* is bitwise ``α`` at completion (the
final increment is nudged by ULPs if ordinary subtraction would leave the
sum one rounding step off).  ``sum(charge for _, _, charge in
record.charges)`` therefore telescopes to exactly the atomic charge —
the invariant the property tests pin down.

A two-entry close: when ``charged + inc`` is an exact halfway case for
every ``inc`` near ``α - charged`` (``charged`` has a bit at half of
``α``'s ulp), round-half-to-even reaches only the two neighbours of an odd
``α`` and no single increment lands.  The completing step then appends
``(index, rows, inc1)`` and ``(index, 0, inc2)``: ``inc1`` is the largest
increment with ``charged + inc1 < α`` and ``inc2 = α - (charged + inc1)``,
exact by Sterbenz's lemma, so the sum is ``α`` and the rows still add up
to the migration's.  Everywhere one increment lands, the ledger is the
single-entry one (:func:`closing_charges`).
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Deque, List, Optional, Tuple

import numpy as np

from repro_torch.core import workload as wl

from .planner import COMPUTES, MigrationPlan, plan_migration


def closing_increment(charged: float, alpha: float) -> float:
    """The final charge that lands a left-to-right float sum on ``alpha``.

    Returns ``inc`` such that ``charged + inc == alpha`` *bitwise*.  Plain
    ``alpha - charged`` already does this in almost every case; when the
    two roundings (of the difference, then of the sum) conspire to land
    one ULP off, the increment is nudged until the sum is exact.
    """
    inc = alpha - charged
    for _ in range(4):                      # 1 nudge suffices in practice
        total = charged + inc
        if total == alpha:
            return inc
        inc = math.nextafter(inc, math.inf if total < alpha else -math.inf)
    raise AssertionError(
        f"could not close charge ledger: charged={charged!r} "
        f"alpha={alpha!r}")


def closing_charges(charged: float, alpha: float) -> Tuple[float, ...]:
    """The final charges that land a left-to-right float sum on ``alpha``.

    ``(closing_increment(charged, alpha),)`` wherever that lands; else
    ``(inc1, inc2)``: ``inc1`` the largest increment with ``charged + inc1
    < alpha``, ``inc2 = alpha - (charged + inc1)`` (exact, positive), so
    ``(charged + inc1) + inc2 == alpha`` bitwise.
    """
    try:
        return (closing_increment(charged, alpha),)
    except AssertionError:
        pass                                # a halfway tie: close in two
    inc1 = alpha - charged
    for _ in range(4):                      # 1 step suffices on a tie
        if charged + inc1 < alpha:
            return inc1, alpha - (charged + inc1)
        inc1 = math.nextafter(inc1, -math.inf)
    raise AssertionError(
        f"could not close charge ledger in two entries: "
        f"charged={charged!r} alpha={alpha!r}")


@dataclasses.dataclass
class MigrationRecord:
    """The observable trace of one (possibly still in-flight) migration."""

    target_state: int
    charged_at: int                 # decision index the α charge landed on
    begun_at: int = -1              # step the physical migration started
    completed_at: int = -1          # step the target layout took over
    alpha: float = 0.0
    total_rows: int = 0             # rows the full migration relocates
    moved_rows: int = 0
    moves_total: int = 0
    moves_done: int = 0
    #: Amortization schedule: (engine index, rows moved, charge).  The
    #: left-to-right float sum of the charges is bitwise ``alpha`` once
    #: ``completed_at >= 0``.
    charges: List[Tuple[int, int, float]] = dataclasses.field(
        default_factory=list)
    #: Running left-to-right sum of ``charges`` (what a consumer summing
    #: the schedule in order obtains).
    charged: float = 0.0

    @property
    def in_flight(self) -> bool:
        return self.begun_at >= 0 and self.completed_at < 0

    def charge(self, index: int, rows: int, completing: bool) -> None:
        if completing:
            incs = closing_charges(self.charged, self.alpha)
        else:
            incs = (self.alpha * (self.moved_rows / max(self.total_rows, 1))
                    - self.charged,)
        for k, inc in enumerate(incs):      # a tie's second entry moves 0
            self.charges.append((index, rows if k == 0 else 0, inc))
            self.charged = self.charged + inc


class ReorgExecutor:
    """Drives planned migrations through a backend under a row budget.

    ``rows_per_tick`` is the engine-local budget cap (None = unbounded);
    a fleet governor with ``grant_rows`` (see
    :class:`repro_torch.engine.scheduler.ReorgScheduler`) can tighten —
    never loosen — what a single step may move.  ``recent_window`` bounds
    the query sample handed to the planner's greedy ordering; ``compute``
    names the ordering's scan-frequency lane, ``"move_score"`` or
    ``"decision_fused"`` (see :mod:`.planner`; both exact).
    """

    def __init__(self, backend, rows_per_tick: Optional[int] = None,
                 recent_window: int = 64, compute: str = "move_score"):
        if rows_per_tick is not None and rows_per_tick <= 0:
            raise ValueError("rows_per_tick must be positive (None = "
                             "unbounded)")
        if compute not in COMPUTES:
            raise ValueError(f"unknown planner compute lane {compute!r} "
                             f"(expected one of {COMPUTES})")
        self.backend = backend
        self.rows_per_tick = rows_per_tick
        self.compute = compute
        self._recent: Deque[wl.Query] = collections.deque(
            maxlen=max(int(recent_window), 1))
        self._active: Optional[MigrationPlan] = None
        self._cursor = 0                    # next move index in plan order
        self._banked = 0.0                  # granted rows not yet spent
        self._done: Optional[np.ndarray] = None
        # Per-step budget tracking: advance() may run more than once per
        # engine step (a completing migration lets the next due swap begin
        # in the same step), and the engine-local cap applies per step.
        self._tick_index = -1
        self._tick_spent = 0
        #: Every migration this executor ran, in begin order (completed
        #: and in-flight); the charge-ledger invariant is per entry.
        self.migrations: List[MigrationRecord] = []

    # ------------------------------------------------------------------
    @property
    def active(self) -> Optional[MigrationRecord]:
        """The in-flight migration's record (None when idle)."""
        return self.migrations[-1] if self._active is not None else None

    @property
    def done_mask(self) -> Optional[np.ndarray]:
        """Copy of the in-flight migration's done mask (None when idle)."""
        return None if self._done is None else self._done.copy()

    def observe(self, query: wl.Query) -> None:
        """Feed one served query into the planner's recent-window sample."""
        self._recent.append(query)

    # ------------------------------------------------------------------
    def begin(self, engine, state_id: int, index: int,
              charged_at: int) -> None:
        """Start the migration the atomic engine would have swapped here.

        Plans the (source -> target) diff against the recent query window
        and leaves the serving state untouched — rows only move in
        :meth:`advance` (called later in the same engine step, so an
        unbounded budget still completes the migration at this very
        step)."""
        if self._active is not None:
            raise RuntimeError("a migration is already in flight")
        source = self.backend.serving_layout
        target = self.backend.get(state_id)
        # Delta-bearing backends (streaming ingest) hand the planner the
        # hybrid source — clustered base partitions plus one pseudo-
        # partition per pending delta batch — so compactions (and drift
        # reorgs with deltas in flight) diff against what is physically
        # being served.  Returns None with no pending deltas, which keeps
        # the plain path (and its traces) bit-identical.
        src_assign = src_meta = None
        delta_source = getattr(self.backend, "delta_source", None)
        if delta_source is not None:
            hybrid = delta_source()
            if hybrid is not None:
                src_assign, src_meta = hybrid
        plan = plan_migration(self.backend.data, source, target,
                              recent_queries=tuple(self._recent),
                              compute=self.compute,
                              source_assignment=src_assign,
                              source_meta=src_meta)
        self._active = plan
        self._cursor = 0
        self._banked = 0.0
        self._done = np.zeros(plan.num_target_partitions, dtype=bool)
        self.backend.begin_migration(plan)
        self.migrations.append(MigrationRecord(
            target_state=state_id, charged_at=charged_at, begun_at=index,
            alpha=engine.alpha, total_rows=plan.total_move_rows,
            moves_total=plan.num_moves))

    def advance(self, engine, index: int) -> None:
        """Spend this step's row budget on the in-flight migration."""
        plan = self._active
        if plan is None:
            return
        if index != self._tick_index:
            self._tick_index = index
            self._tick_spent = 0
        record = self.migrations[-1]
        remaining = int(sum(m.rows for m in plan.moves[self._cursor:])
                        - self._banked)
        want = remaining
        if self.rows_per_tick is not None:
            want = min(want, self.rows_per_tick - self._tick_spent)
        want = max(want, 0)
        granted = want
        governor = engine.governor
        if want and governor is not None and hasattr(governor, "grant_rows"):
            granted = min(want, governor.grant_rows(engine, want))
        self._banked += granted
        self._tick_spent += granted
        newly_done: List[int] = []
        rows_now = 0
        while self._cursor < len(plan.moves):
            move = plan.moves[self._cursor]
            if self._banked < move.rows:
                break
            self._banked -= move.rows
            self._cursor += 1
            newly_done.append(move.target_partition)
            rows_now += move.rows
        if not newly_done and self._cursor < len(plan.moves):
            return
        record.moved_rows += rows_now
        record.moves_done += len(newly_done)
        if self._cursor >= len(plan.moves):
            # Migration complete: snap to the target through the backend's
            # normal activation path (bitwise the atomic end state) and
            # close the charge ledger on exactly alpha.
            if newly_done:
                self._done[newly_done] = True
            self.backend.complete_migration(plan)
            record.charge(index, rows_now, completing=True)
            record.completed_at = index
            self._active = None
            self._done = None
            self._banked = 0.0
            governor = engine.governor
            if governor is not None and hasattr(governor, "on_complete"):
                governor.on_complete(engine, record.target_state)
        else:
            self._done[newly_done] = True
            self.backend.apply_migration(plan.hybrid_meta(self._done),
                                         newly_done)
            record.charge(index, rows_now, completing=False)

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Aggregate ledger stats (for benchmarks and traces)."""
        completed = [m for m in self.migrations if m.completed_at >= 0]
        return {
            "migrations": len(self.migrations),
            "completed": len(completed),
            "rows_moved": int(sum(m.moved_rows for m in self.migrations)),
            "moves_done": int(sum(m.moves_done for m in self.migrations)),
            "charged": float(sum(m.charged for m in self.migrations)),
        }


__all__ = ["MigrationRecord", "ReorgExecutor", "closing_charges",
           "closing_increment", "plan_migration"]
