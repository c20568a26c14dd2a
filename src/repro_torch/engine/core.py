"""The stepwise online loop: one engine, pluggable policies and backends.

``LayoutEngine.step(query)`` interleaves the three concerns of Figure 1 for a
single query — decision (policy), physical reorganization (backend, with the
paper's §VI-D5 Δ-delay between charging a reorg and the swap taking effect),
and serving — and returns a :class:`StepResult`.  ``run(stream)`` produces a
:class:`repro_torch.core.oreo.RunResult` trace.  It stacks the stream's
query bounds once and hands them to the backend as a lookahead, so the
policies' estimates are scanned a block of queries per launch between
plane changes (``step`` scans per query); when the backend supports block
serving it also evaluates serve costs in blocks between layout swaps.  The
decision loop stays strictly per-query and both are bit-identical to
stepping: a block row is consumed only while the plane is unchanged, and
decisions never depend on realized serve costs.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import oreo as _oreo
from repro_torch.core import workload as wl

from .backends import StorageBackend
from .ingest import DebtMeter, IngestConfig
from .policies import Decision, Policy


@dataclasses.dataclass
class StepResult:
    """Everything observable about one query's pass through the loop."""

    index: int
    query: wl.Query
    query_cost: float               # fraction of records accessed serving it
    decision_state: int             # state per the decision maker
    serving_state: Optional[int]    # physically materialized state
    reorg_charged: bool             # alpha charged at this query
    states_added: List[int]
    states_removed: List[int]
    decide_seconds: float
    reorg_seconds: float            # prepare + any swap applied this query
    serve_seconds: float


class LayoutEngine:
    """Drives a :class:`Policy` against a :class:`StorageBackend`, query by
    query.  Single-use and stateful: feed it one logical stream (via
    :meth:`step` or :meth:`run`) and read the trace with :meth:`result`.
    """

    def __init__(self, policy: Policy, backend: StorageBackend,
                 delta: int = 0, name: Optional[str] = None,
                 governor: Optional[object] = None,
                 incremental: bool = False,
                 rows_per_tick: Optional[int] = None,
                 reorg_window: int = 64,
                 reorg_compute: str = "move_score",
                 ingest: Optional[IngestConfig] = None):
        self.policy = policy
        self.backend = backend
        self.delta = delta
        self.name = name or policy.name
        self.alpha = policy.alpha
        #: Incremental reorganization mode (see
        #: :mod:`repro_torch.engine.reorg`): instead of one wholesale swap
        #: at the Δ-due step, a charged reorganization becomes a planned
        #: migration executed a micro-batch at a time under a per-tick row
        #: budget (``rows_per_tick``, None = unbounded; a fleet scheduler
        #: with ``grant_rows`` can tighten it further).  Charges are
        #: untouched — α still lands at decision time — and with an
        #: unbounded budget the trace is bit-identical to the atomic loop.
        #: ``reorg_compute`` names the planner's scan-frequency lane
        #: (``"move_score"`` or ``"decision_fused"``).
        self.incremental = bool(incremental)
        self.reorg_executor = None
        if self.incremental:
            if not getattr(backend, "supports_incremental", False):
                raise ValueError(
                    "incremental=True needs a backend with hybrid-serving "
                    f"support ({type(backend).__name__} has none; "
                    "InMemoryBackend compute='reference' serves straight "
                    "off the layout object)")
            from .reorg import ReorgExecutor
            self.reorg_executor = ReorgExecutor(
                backend, rows_per_tick=rows_per_tick,
                recent_window=reorg_window, compute=reorg_compute)
        elif rows_per_tick is not None:
            raise ValueError("rows_per_tick requires incremental=True")
        #: Optional reorg governor (see :mod:`repro_torch.engine.fleet`): an
        #: object with ``on_charge(engine, index, state_id) -> bool`` (may
        #: physical work start now?) and ``may_apply(engine, due_index,
        #: state_id) -> bool`` (may the due swap take effect now?).  None —
        #: the standalone default — starts work at charge time and applies
        #: every swap the moment it is due, i.e. the paper's single-tenant
        #: Δ-delay semantics.  A governor can only *defer* physical work,
        #: never advance it, so per-tenant Δ-delay bounds are preserved.
        self.governor = governor
        #: Streaming ingest (see :mod:`repro_torch.engine.ingest`): rows
        #: appended through :meth:`ingest` land as unclustered delta
        #: partitions visible to scans immediately; a :class:`DebtMeter`
        #: accrues the workload's excess scan cost over a hypothetical
        #: compacted table and, once it crosses ``debt_threshold * α``, the
        #: engine charges a reclustering reorganization through the exact
        #: drift-reorg path (α at decision time, Δ-delayed swap, governor
        #: arbitration, and — in incremental mode — budgeted micro-move
        #: execution).  The fleet reads ``_debt`` to decide whether a pass
        #: may commit in bulk.
        self.ingest_config = ingest
        self._debt: Optional[DebtMeter] = None
        self._delta_generation = 0
        #: Decision indices where a debt-triggered compaction was charged
        #: (a subset of the trace's ``reorg_indices``).
        self.compaction_indices: List[int] = []
        self.ingested_rows = 0
        if ingest is not None:
            enable = getattr(backend, "enable_ingest", None)
            if enable is None:
                raise ValueError(
                    f"ingest needs a backend with streaming-ingest support "
                    f"({type(backend).__name__} has no enable_ingest)")
            if self.incremental and getattr(backend, "delta_source",
                                            None) is None:
                raise ValueError(
                    "incremental=True ingest needs a backend exposing the "
                    "hybrid delta source for compaction planning "
                    "(delta_source); use atomic mode with "
                    f"{type(backend).__name__}")
            enable()
            self._debt = DebtMeter()
        self._started = False
        self._index = 0
        self._query_costs: List[float] = []
        self._reorg_indices: List[int] = []
        self._state_seq: List[int] = []
        # (effective_idx, sid); appended in index order, drained from the
        # front — a deque keeps the drain O(1) per swap.
        self._pending_swaps: Deque[Tuple[int, int]] = collections.deque()
        self._decide_seconds = 0.0
        self._reorg_seconds = 0.0
        self._serve_seconds = 0.0

    # ------------------------------------------------------------------
    def start(self) -> None:
        """Bind the policy and materialize the initial serving layout."""
        if self._started:
            return
        initial_state = self.policy.bind(self.backend)
        self.backend.activate(initial_state)
        self._started = True

    # -- streaming ingest (see repro_torch.engine.ingest) ---------------
    def ingest(self, rows):
        """Append one batch of rows as an unclustered delta partition.

        ``rows`` is an (N, C) host array (or a tensor); it goes to the
        table's device once, and is routed there for the debt meter.  The
        rows are visible to scans from the very next query (the backend
        composes their exact zone maps onto the serving state); the debt
        meter starts tracking what their lack of clustering costs.  Does
        not advance the query index — ingest events and queries are
        independent positions in a mixed stream.  Returns the backend's
        :class:`repro_torch.engine.ingest.DeltaBatch`.
        """
        if self.ingest_config is None:
            raise RuntimeError(
                "this engine was built without ingest support (pass "
                "ingest=IngestConfig() to LayoutEngine)")
        backend = self.backend
        rows = torch.as_tensor(rows, dtype=torch.float64,
                               device=backend.data.device)
        self.start()
        self._sync_debt()
        migrating = bool(getattr(backend, "migrating", False))
        base = backend.ingest_base_meta
        serving = backend.serving_layout
        batch = backend.ingest_rows(rows)
        self.ingested_rows += len(rows)
        if not migrating:
            # Mid-migration appends stay out of the meter until the
            # migration completes and _sync_debt rebuilds against the new
            # base (the generation bump at completion triggers it).
            self._debt.on_append(base, rows, self._route(serving, rows))
        return batch

    @staticmethod
    def _route(serving, rows: torch.Tensor) -> torch.Tensor:
        """``rows``' partitions under the serving layout, int64 on their
        device (partition 0 for a route-less layout)."""
        if serving is not None and serving.route is not None:
            return serving.route(rows).to(torch.int64)
        return torch.zeros(len(rows), dtype=torch.int64, device=rows.device)

    def _sync_debt(self) -> None:
        """Re-anchor the debt meter after any delta absorption.

        Absorptions bump the :class:`DeltaLog` generation (atomic
        activation, migration begin/complete); the meter then resets —
        debt is considered paid by the rewrite — and rebuilds its
        compacted zone maps from whichever batches are *still* pending
        against the new base, each re-routed from its slice of the
        device table.
        """
        d = getattr(self.backend, "delta_log", None)
        if d is None or d.generation == self._delta_generation:
            return
        self._delta_generation = d.generation
        self._debt.reset()
        if getattr(self.backend, "migrating", False) or not d.pending:
            return
        base = self.backend.ingest_base_meta
        serving = self.backend.serving_layout
        for b in d.batches:
            rows = self.backend.data[b.start:b.end]
            self._debt.on_append(base, rows, self._route(serving, rows))

    def _maybe_compact(self, i: int) -> None:
        """Charge a debt-triggered reclustering through the drift-reorg
        path.  Deferred while any swap or migration is in flight — the
        debt keeps accruing and re-triggers at the next clean step."""
        self._sync_debt()
        if self._pending_swaps or getattr(self.backend, "migrating", False):
            return
        if not self._debt.triggered(self.alpha, self.ingest_config):
            return
        sid = self.backend.serving_state
        if sid is None or not self.backend.has(sid):
            return
        self._debt.compactions_triggered += 1
        self.compaction_indices.append(i)
        self._charge_reorg(i, Decision(state=sid, reorg=True))

    def ingest_stats(self) -> dict:
        """Ingest-plane counters (kept out of :meth:`result`'s trace so
        ingest-disabled traces stay bit-comparable)."""
        d = getattr(self.backend, "delta_log", None)
        meter = self._debt
        return {
            "ingested_rows": int(self.ingested_rows),
            "pending_batches": 0 if d is None else d.num_batches,
            "pending_rows": 0 if d is None else d.delta_rows,
            "clustering_debt": 0.0 if meter is None else float(meter.debt),
            "total_excess": (0.0 if meter is None
                             else float(meter.total_excess)),
            "compactions": list(self.compaction_indices),
        }

    # ------------------------------------------------------------------
    def _charge_reorg(self, i: int, decision: Decision) -> None:
        """Bookkeeping for a charged reorganization (shared by step/run).

        The cost is charged at decision time (paper §VI-D5); the physical
        swap lands Δ queries later.  Backends may overlap the wait with
        background materialization started by ``prepare``.
        """
        if decision.reorg:
            self._reorg_indices.append(i)
            granted = (self.governor is None
                       or self.governor.on_charge(self, i, decision.state))
            if granted and not self.incremental:
                # Incremental mode never pre-materializes: physical work
                # happens at apply time, a micro-batch per tick.
                self.backend.prepare(decision.state)
            self._pending_swaps.append((i + self.delta, decision.state))

    def _apply_due_swaps(self, i: int) -> None:
        """Apply every swap that is due, in charge order; a state evicted
        while its swap was in flight is skipped.  A due swap the governor
        keeps deferred blocks everything queued behind it.

        In incremental mode "applying" a live swap *begins* a migration,
        and this step's row budget is spent on it right away — so with an
        unbounded budget several due swaps can begin, complete and
        activate within one step, exactly like the atomic loop applies
        them back to back.  Under a finite budget an in-flight migration
        blocks later swaps until it completes (those waits are migration-
        queue time, not scheduler deferral, and are not counted in the
        deferral stats).  Evicted states are skipped through the same
        bookkeeping as the atomic path.
        """
        executor = self.reorg_executor
        if executor is not None:
            # Governors with only the on_charge/may_apply pair still work:
            # may_apply's release-on-grant semantics are the degenerate
            # hold.
            may_begin = (None if self.governor is None else getattr(
                self.governor, "may_begin", self.governor.may_apply))
            while True:
                if executor.active is not None:
                    executor.advance(self, i)
                    if executor.active is not None:
                        return              # tick budget exhausted
                if not (self._pending_swaps
                        and self._pending_swaps[0][0] <= i):
                    return
                due, sid = self._pending_swaps[0]
                if may_begin is not None and not may_begin(self, due, sid):
                    return
                self._pending_swaps.popleft()
                if self.backend.has(sid):
                    executor.begin(self, sid, i, charged_at=due - self.delta)
        while self._pending_swaps and self._pending_swaps[0][0] <= i:
            due, sid = self._pending_swaps[0]
            if (self.governor is not None
                    and not self.governor.may_apply(self, due, sid)):
                break
            self._pending_swaps.popleft()
            if self.backend.has(sid):
                self.backend.activate(sid)

    @property
    def pending_swaps(self) -> Tuple[Tuple[int, int], ...]:
        """Charged-but-not-yet-applied swaps as (due_index, state_id)."""
        return tuple(self._pending_swaps)

    def finish_migration(self) -> None:
        """Drive any in-flight incremental migration to completion now.

        The finish half of the fleet's finish-or-transplant detach
        (:meth:`repro_torch.engine.FleetEngine.remove_tenant`): the
        remaining micro-moves land at the *current* index under an
        unmetered budget, so the migration's charge ledger closes bitwise
        on α right here instead of travelling with the engine.  No-op when
        idle or atomic.
        """
        executor = self.reorg_executor
        if executor is None or executor.active is None:
            return
        saved_governor = self.governor
        saved_cap = executor.rows_per_tick
        self.governor = None            # no grant_rows metering
        executor.rows_per_tick = None
        try:
            executor.advance(self, self._index)
        finally:
            self.governor = saved_governor
            executor.rows_per_tick = saved_cap
        assert executor.active is None, \
            "unbounded advance must complete the migration"

    def _step_core(self, query: wl.Query):
        """The decide/charge/swap/serve sequence shared by :meth:`step`
        and :meth:`step_fast` — one implementation so the two entry points
        can never drift apart (the fleet's loop/batched bit-identity rests
        on that)."""
        self.start()
        i = self._index
        executor = self.reorg_executor
        if executor is not None:
            executor.observe(query)
        if self._debt is not None:
            self._maybe_compact(i)
        t0 = time.perf_counter()
        decision = self.policy.decide(i, query, self.backend)
        t1 = time.perf_counter()
        self._charge_reorg(i, decision)
        self._apply_due_swaps(i)        # incremental: also spends the
        t2 = time.perf_counter()        # step's migration row budget
        query_cost = float(self.backend.serve(query))
        t3 = time.perf_counter()
        if self._debt is not None:
            self._sync_debt()
            self._debt.observe(query_cost, query.lo, query.hi)
        self._query_costs.append(query_cost)
        self._state_seq.append(decision.state)
        self._index += 1
        decide, reorg, serve = t1 - t0, t2 - t1, t3 - t2
        self._decide_seconds += decide
        self._reorg_seconds += reorg
        self._serve_seconds += serve
        return i, decision, query_cost, decide, reorg, serve

    def step(self, query: wl.Query) -> StepResult:
        """Advance the online loop by one query."""
        i, decision, query_cost, decide, reorg, serve = \
            self._step_core(query)
        return StepResult(
            index=i,
            query=query,
            query_cost=query_cost,
            decision_state=decision.state,
            serving_state=self.backend.serving_state,
            reorg_charged=decision.reorg,
            states_added=decision.added,
            states_removed=decision.removed,
            decide_seconds=decide,
            reorg_seconds=reorg,
            serve_seconds=serve,
        )

    def step_fast(self, query: wl.Query) -> float:
        """One query through the loop without materializing a StepResult
        (same :meth:`_step_core`, same trace); returns the query cost."""
        return self._step_core(query)[2]

    # ------------------------------------------------------------------
    def result(self, name: Optional[str] = None) -> _oreo.RunResult:
        """Trace of every query stepped so far."""
        return _oreo.RunResult(
            name=name or self.name,
            alpha=self.alpha,
            query_costs=np.asarray(self._query_costs),
            reorg_indices=list(self._reorg_indices),
            state_seq=np.asarray(self._state_seq, dtype=np.int64),
            info=dict(self.policy.info()),
            decide_seconds=self._decide_seconds,
            reorg_seconds=self._reorg_seconds,
            serve_seconds=self._serve_seconds,
        )

    def _open_lookahead(self, queries, q_lo, q_hi):
        """The backend's lookahead over ``queries``, or None if it has
        none (see ``_RegistryMixin.open_lookahead``)."""
        open_ = getattr(self.backend, "open_lookahead", None)
        return open_(queries, q_lo, q_hi) if callable(open_) else None

    def run(self, stream: wl.WorkloadStream, name: Optional[str] = None,
            batch_serve: Optional[bool] = None) -> _oreo.RunResult:
        """Step every query of ``stream`` and return the trace.

        The stream's bounds go to the backend as a lookahead (when it takes
        one): each estimate is its query's row of a block scan, valid until
        the next state registration or deregistration.  When the backend
        exposes ``serve_block`` (``batch_serve=None`` auto-detects; pass
        False to force the stepwise loop), serve costs are evaluated in
        blocks of consecutive queries served by the same physical layout:
        the per-query decision loop runs unchanged, serves are deferred,
        and each block is flushed right before a layout swap takes effect.
        The resulting trace is bit-identical to stepping.
        """
        queries = list(stream)
        has_block = callable(getattr(self.backend, "serve_block", None))
        if self.ingest_config is not None:
            # Debt metering consumes every realized serve cost in step
            # order, and a debt-triggered compaction can swap the layout
            # at any step — both break the swap-aligned block flushing.
            if batch_serve:
                raise ValueError(
                    "batch_serve=True is incompatible with ingest (debt "
                    "metering is per-step)")
            batch_serve = False
        if self.incremental:
            # Hybrid serving can change the layout at *any* step a
            # micro-batch lands, not only at pending-swap applies, so the
            # swap-aligned block flushing below would serve stale blocks.
            if batch_serve:
                raise ValueError(
                    "batch_serve=True is incompatible with incremental=True"
                    " (hybrid updates land between swaps)")
            batch_serve = False
        elif batch_serve is None:
            batch_serve = has_block
        elif batch_serve and not has_block:
            raise ValueError(
                "batch_serve=True requires a backend with serve_block")
        if not queries:
            return self.result(name)
        q_lo, q_hi = wl.stack_queries(queries)
        ahead = self._open_lookahead(queries, q_lo, q_hi)
        try:
            if batch_serve:
                self._run_blocks(queries, q_lo, q_hi, ahead)
            else:
                for k, query in enumerate(queries):
                    if ahead is not None:
                        ahead.cursor = k
                    self.step(query)
        finally:
            if ahead is not None:
                self.backend.close_lookahead()
        return self.result(name)

    def _run_blocks(self, queries, q_lo, q_hi, ahead) -> None:
        """``run``'s loop with serve costs flushed in blocks."""
        self.start()
        costs = np.empty(len(queries))
        block = 0
        for k, query in enumerate(queries):
            if ahead is not None:
                ahead.cursor = k
            i = self._index
            t0 = time.perf_counter()
            decision = self.policy.decide(i, query, self.backend)
            t1 = time.perf_counter()
            self._charge_reorg(i, decision)
            flush = 0.0
            if self._pending_swaps and self._pending_swaps[0][0] <= i:
                # Flush the open serve block before the swap changes the
                # serving layout (a step serves *after* applying due swaps,
                # so query k itself belongs to the next block).
                if k > block:
                    ts = time.perf_counter()
                    costs[block:k] = self.backend.serve_block(
                        q_lo[block:k], q_hi[block:k])
                    flush = time.perf_counter() - ts
                block = k
                self._apply_due_swaps(i)
            t2 = time.perf_counter()
            self._state_seq.append(decision.state)
            self._index += 1
            self._decide_seconds += t1 - t0
            self._reorg_seconds += t2 - t1 - flush
            self._serve_seconds += flush
        ts = time.perf_counter()
        costs[block:] = self.backend.serve_block(q_lo[block:], q_hi[block:])
        self._serve_seconds += time.perf_counter() - ts
        self._query_costs.extend(float(c) for c in costs)
