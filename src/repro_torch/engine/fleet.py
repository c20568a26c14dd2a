"""Multi-tenant fleet: many LayoutEngines, one reorganization budget.

A :class:`FleetEngine` drives N independent tenants — each a fully-formed
:class:`repro_torch.engine.LayoutEngine` with its own policy, backend, α
and Δ-delay — over a single interleaved stream of typed
:class:`~repro_torch.core.workload.QueryEvent` and
:class:`~repro_torch.core.workload.IngestEvent` envelopes, the shape of
traffic a warehouse actually sees.  :meth:`FleetEngine.submit` enqueues one
event and :meth:`FleetEngine.drain` processes the backlog; ``run`` /
``run_batched`` are drivers over that one entry point.  Decisions stay
strictly per-tenant; what is *shared* is physical reorganization work,
arbitrated by a pluggable
:class:`repro_torch.engine.scheduler.ReorgScheduler`.

The contract with each tenant's Δ-delay semantics (paper §VI-D5):

* Reorganization **charges** are untouched.  A tenant's policy runs
  exactly as it would standalone, and α is charged at decision time, so
  ``reorg_indices`` and ``state_seq`` are identical under *every*
  scheduler (decisions are metadata-only and never read the serving
  layout).
* Physical **swaps** may only be deferred, never advanced: a swap lands at
  the first of the tenant's own steps whose index is ≥ its due index
  (charge index + Δ) *and* whose work the scheduler has granted.  Under
  :class:`~repro_torch.engine.scheduler.UnlimitedScheduler` every grant is
  immediate and each tenant's full trace — query costs included — is
  bit-identical to running its engine alone.
* Swaps apply in charge order per tenant; a deferred swap blocks the
  tenant's later swaps, not other tenants'.

The host logic is the reference package's, line for line; the batched
path scores every pass on the packed :class:`FleetMatrix` plane on the
device.  An ingest event appends rows to its tenant's table (see
:meth:`LayoutEngine.ingest`): it ticks the fleet clock and the scheduler,
not the tenant's query index.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core import oreo as _oreo
from repro_torch.core import workload as wl
from repro_torch.kernels._backend import resolve_device

from .core import LayoutEngine, StepResult
from .fleet_matrix import FleetMatrix
from .scheduler import ReorgScheduler, SchedulerSpec, UnlimitedScheduler


@dataclasses.dataclass
class FleetStepResult:
    """One interleaved event's pass through the fleet."""

    tick: int                   # fleet clock (1-based event counter)
    tenant_id: str
    step: Optional[StepResult]  # the tenant-local step observation
    swap_deferred: bool         # a due swap was kept waiting at this step


@dataclasses.dataclass
class FleetResult:
    """Aggregate trace of a fleet run: per-tenant RunResults + fleet totals."""

    name: str
    scheduler: str
    per_tenant: Dict[str, _oreo.RunResult]
    ticks: int
    #: Distinct swaps the scheduler kept waiting past their due step.
    swaps_deferred: int
    #: Tenant steps served under a stale layout while a due swap waited —
    #: one deferred swap accrues a tick per step until granted, so this
    #: measures wait *time*, not how many swaps were affected.
    deferred_ticks: int
    scheduler_stats: dict = dataclasses.field(default_factory=dict)

    @property
    def total_query_cost(self) -> float:
        return sum(r.total_query_cost for r in self.per_tenant.values())

    @property
    def total_reorg_cost(self) -> float:
        return sum(r.total_reorg_cost for r in self.per_tenant.values())

    @property
    def total_cost(self) -> float:
        return self.total_query_cost + self.total_reorg_cost

    @property
    def num_reorgs(self) -> int:
        return sum(r.num_reorgs for r in self.per_tenant.values())

    @property
    def decide_seconds(self) -> float:
        return sum(r.decide_seconds for r in self.per_tenant.values())

    @property
    def reorg_seconds(self) -> float:
        return sum(r.reorg_seconds for r in self.per_tenant.values())

    @property
    def serve_seconds(self) -> float:
        return sum(r.serve_seconds for r in self.per_tenant.values())

    @property
    def wall_seconds(self) -> float:
        return self.decide_seconds + self.reorg_seconds + self.serve_seconds

    def summary(self) -> str:
        return (f"{self.name}[{self.scheduler}]: "
                f"total={self.total_cost:.1f} "
                f"(query={self.total_query_cost:.1f}, "
                f"reorg={self.total_reorg_cost:.1f}, "
                f"moves={self.num_reorgs}, "
                f"deferred={self.swaps_deferred} "
                f"over {self.deferred_ticks} ticks) "
                f"tenants={len(self.per_tenant)} ticks={self.ticks}")


class _TenantGovernor:
    """Bridges one tenant's engine hooks to the fleet's shared scheduler."""

    __slots__ = ("fleet", "tenant_id")

    def __init__(self, fleet: "FleetEngine", tenant_id: str):
        self.fleet = fleet
        self.tenant_id = tenant_id

    def on_charge(self, engine: LayoutEngine, index: int,
                  state_id: int) -> bool:
        return self.fleet._on_charge(self.tenant_id, engine, state_id)

    def may_apply(self, engine: LayoutEngine, due_index: int,
                  state_id: int) -> bool:
        return self.fleet._may_apply(self.tenant_id, engine, state_id)

    def may_begin(self, engine: LayoutEngine, due_index: int,
                  state_id: int) -> bool:
        # Incremental variant of may_apply: the granted unit stays held
        # for the whole migration (released via on_complete), so the
        # scheduler sees in-flight migrations as in-flight work.
        return self.fleet._may_apply(self.tenant_id, engine, state_id,
                                     hold=True)

    def on_complete(self, engine: LayoutEngine, state_id: int) -> None:
        self.fleet._on_complete(self.tenant_id)

    def grant_rows(self, engine: LayoutEngine, want: int) -> int:
        return self.fleet._grant_rows(self.tenant_id, want)


class FleetEngine:
    """Drives N tenant engines over one interleaved query stream.

    ``tenants`` maps tenant id → a *fresh* :class:`LayoutEngine` (not yet
    started, no governor of its own); ``scheduler`` arbitrates physical
    reorganization work fleet-wide (default: unlimited, i.e. no
    contention).  Feed events with :meth:`step` or :meth:`run`, read the
    aggregate trace with :meth:`result` — per-tenant traces are ordinary
    :class:`repro_torch.core.oreo.RunResult` objects.
    """

    def __init__(self, tenants: Mapping[str, LayoutEngine],
                 scheduler: Optional[ReorgScheduler] = None,
                 name: str = "fleet",
                 incremental: Optional[bool] = None):
        if not tenants and incremental is None:
            # An empty fleet is legal only as a shard awaiting tenants, and
            # then the mode cannot be inferred — requiring it explicitly
            # keeps the bare-constructor misuse loud.
            raise ValueError("a fleet needs at least one tenant (or an "
                             "explicit incremental= mode for an empty "
                             "shard)")
        self.name = name
        if isinstance(scheduler, SchedulerSpec):
            scheduler = scheduler.build()
        self.scheduler = scheduler or UnlimitedScheduler()
        self._tenants: Dict[str, LayoutEngine] = dict(tenants)
        #: Incremental fleet mode (see :mod:`repro_torch.engine.reorg`):
        #: every tenant engine must have been built with
        #: ``incremental=True``; scheduler grants are then held for whole
        #: migrations and ``grant_rows`` meters per-tick row budgets.
        #: ``None`` infers the mode from the tenants (which must agree).
        modes = {tid: e.incremental for tid, e in self._tenants.items()}
        if incremental is None:
            if len(set(modes.values())) > 1:
                raise ValueError(
                    f"tenants mix incremental and atomic engines: {modes}")
            incremental = next(iter(modes.values()))
        else:
            wrong = [tid for tid, m in modes.items()
                     if m != bool(incremental)]
            if wrong:
                raise ValueError(
                    f"incremental={incremental!r} but tenants {wrong} were "
                    f"built with the opposite mode")
        self.incremental = bool(incremental)
        for tid, engine in self._tenants.items():
            if engine.governor is not None:
                raise ValueError(f"tenant {tid!r}: engine already governed")
            if engine._started:
                raise ValueError(f"tenant {tid!r}: engine already started")
            engine.governor = _TenantGovernor(self, tid)
        self._tick = 0
        self.swaps_deferred = 0
        self.deferred_ticks = 0
        # Whether each tenant's *front* pending swap has already been
        # counted in swaps_deferred; reset whenever a front swap resolves.
        self._front_deferred: Dict[str, bool] = {
            tid: False for tid in tenants}
        # Charged swaps whose physical work awaits a scheduler grant, in
        # fleet-wide charge order; per-tenant FIFO is enforced so a
        # tenant's later swap never overtakes its earlier one.
        self._waiting: Deque[Tuple[str, int]] = collections.deque()
        self._waiting_count: Dict[str, int] = {
            tid: 0 for tid in self._tenants}
        # Work granted (prepare issued) but swap not yet applied.
        self._granted: Dict[str, Deque[int]] = {
            tid: collections.deque() for tid in self._tenants}
        # Units held by in-flight incremental migrations (granted via
        # may_begin, released on migration completion).
        self._held: Dict[str, int] = {tid: 0 for tid in self._tenants}
        # Units held by *transplanted* in-flight migrations this fleet's
        # scheduler refused to grant at re-attach time (see add_tenant):
        # the migration keeps moving — physical work cannot be un-begun —
        # but completion must not release a unit that was never acquired
        # here, so these are consumed before self._held on completion.
        self._held_free: Dict[str, int] = {}
        # Packed decision plane for run_batched; built lazily on first use
        # and maintained incrementally from then on (tenant attach/detach
        # plus per-tenant state events), never rebuilt per tick.
        self._fleet_matrix: Optional[FleetMatrix] = None
        # Submitted-but-not-yet-processed events (see submit/drain).
        self._inbox: Deque[wl.Event] = collections.deque()

    @property
    def tenant_ids(self) -> List[str]:
        return list(self._tenants)

    def tenant(self, tenant_id: str) -> LayoutEngine:
        return self._tenants[tenant_id]

    @property
    def fleet_matrix(self) -> Optional[FleetMatrix]:
        """The packed plane behind :meth:`run_batched` (None until used)."""
        return self._fleet_matrix

    # ------------------------------------------------------------------
    # Dynamic tenant membership
    # ------------------------------------------------------------------
    def add_tenant(self, tenant_id: str, engine: LayoutEngine) -> None:
        """Register a tenant mid-flight: a fresh engine, or a transplant.

        A *fresh* engine (not started, never governed) joins exactly as
        at construction.  A *started* engine — one detached from another
        fleet via :meth:`remove_tenant` — is **re-attached**: every
        charged-but-unapplied swap re-enters this fleet's admission queue
        in charge order (charges are never re-issued; α already landed at
        decision time, so the tenant's charge ledger is untouched by the
        move), and an in-flight incremental migration keeps its
        partially-summed
        :class:`~repro_torch.engine.reorg.executor.MigrationRecord` ledger
        and holds one scheduler unit here (or a free hold if this scheduler
        refuses — moves in flight cannot be un-begun).  Under
        :class:`~repro_torch.engine.scheduler.UnlimitedScheduler` on both
        sides, a detach/re-attach round trip is trace-bitwise invisible.
        A governed engine is always rejected — detach it first.

        If the packed plane exists it picks the tenant up incrementally
        (one new row), not via a rebuild.
        """
        if tenant_id in self._tenants:
            raise ValueError(f"tenant {tenant_id!r} already registered")
        if engine.governor is not None:
            raise ValueError(f"tenant {tenant_id!r}: engine already governed")
        if engine.incremental != self.incremental:
            raise ValueError(
                f"tenant {tenant_id!r}: engine incremental="
                f"{engine.incremental} but the fleet runs "
                f"incremental={self.incremental}")
        engine.governor = _TenantGovernor(self, tenant_id)
        self._tenants[tenant_id] = engine
        self._front_deferred[tenant_id] = False
        self._waiting_count[tenant_id] = 0
        self._granted[tenant_id] = collections.deque()
        self._held[tenant_id] = 0
        if engine._started:
            # Transplant: queued physical work re-enters admission here.
            for _, sid in engine._pending_swaps:
                self._waiting.append((tenant_id, sid))
                self._waiting_count[tenant_id] += 1
            executor = engine.reorg_executor
            if executor is not None and executor.active is not None:
                if self.scheduler.try_acquire(tenant_id):
                    self._held[tenant_id] = 1
                else:
                    self._held_free[tenant_id] = \
                        self._held_free.get(tenant_id, 0) + 1
        if self._fleet_matrix is not None:
            self._fleet_matrix.attach(tenant_id,
                                      self._batchable_matrix(tenant_id))

    def take_inbox(self, tenant_id: str) -> List[wl.Event]:
        """Remove and return ``tenant_id``'s queued events, in order.

        The live-migration handoff: drain these out of the source fleet
        before :meth:`remove_tenant` and replay them into the target,
        preserving the tenant's per-event order.
        """
        taken = [ev for ev in self._inbox if ev.tenant_id == tenant_id]
        if taken:
            self._inbox = collections.deque(
                ev for ev in self._inbox if ev.tenant_id != tenant_id)
        return taken

    def remove_tenant(self, tenant_id: str,
                      finish: bool = False) -> LayoutEngine:
        """Detach a tenant and return its (still usable) engine.

        Deterministic **finish-or-transplant** semantics for physical
        work in flight:

        * Charged-but-unapplied swaps stay on the engine's own pending
          queue (charges are decision-time and never dropped); their
          scheduler grants are released here and re-acquired wherever the
          engine lands next — a fleet via :meth:`add_tenant`, or
          standalone Δ-delay semantics if never re-attached.
        * An in-flight incremental migration either keeps migrating on
          the engine (transplant: its held unit is released to this pool
          and the partially-summed charge ledger travels with the
          engine's executor), or — with ``finish=True`` — is driven to
          completion *now*, closing the ledger bitwise on α at the
          current index, before the engine is handed back.

        Queued inbox events for the tenant must be taken first
        (:meth:`take_inbox`); leaving them behind would crash the next
        drain on an unknown tenant, so that is refused loudly here.
        """
        engine = self._tenants[tenant_id]
        if any(ev.tenant_id == tenant_id for ev in self._inbox):
            raise ValueError(
                f"tenant {tenant_id!r} has queued events; take_inbox() "
                f"them first")
        if finish:
            engine.finish_migration()
        del self._tenants[tenant_id]
        if self._waiting_count.pop(tenant_id):
            self._waiting = collections.deque(
                (t, s) for t, s in self._waiting if t != tenant_id)
        for _ in self._granted.pop(tenant_id):
            self.scheduler.release(tenant_id)
        for _ in range(self._held.pop(tenant_id, 0)):
            # An in-flight migration's unit goes back to the pool; the
            # detached engine keeps migrating under its own local budget.
            self.scheduler.release(tenant_id)
        # Free holds were never acquired from this scheduler: drop them.
        self._held_free.pop(tenant_id, None)
        self._front_deferred.pop(tenant_id)
        if self._fleet_matrix is not None:
            self._fleet_matrix.detach(tenant_id)
        engine.governor = None
        return engine

    # ------------------------------------------------------------------
    # Governor callbacks (one per tenant, shared budget)
    # ------------------------------------------------------------------
    def _on_charge(self, tid: str, engine: LayoutEngine,
                   state_id: int) -> bool:
        """A tenant charged a reorg; True lets its physical work start now."""
        if (self._waiting_count[tid] == 0
                and self.scheduler.try_acquire(tid)):
            self._granted[tid].append(state_id)
            return True
        self._waiting.append((tid, state_id))
        self._waiting_count[tid] += 1
        return False

    def _may_apply(self, tid: str, engine: LayoutEngine,
                   state_id: int, hold: bool = False) -> bool:
        """May this tenant's front (due) swap take effect at this step?

        ``hold=True`` (incremental mode) keeps the granted unit instead of
        releasing it: the migration about to begin holds it until
        :meth:`_on_complete`.  An evicted target releases immediately —
        no migration will begin for it.
        """
        granted = self._granted[tid]
        if granted and granted[0] == state_id:
            granted.popleft()
            if hold and engine.backend.has(state_id):
                self._held[tid] += 1
            else:
                self.scheduler.release(tid)
            self._front_deferred[tid] = False
            return True
        if not engine.backend.has(state_id):
            # Evicted while waiting for a grant: there is no physical work
            # to do and the engine skips the activation; just forget it.
            try:
                self._waiting.remove((tid, state_id))
                self._waiting_count[tid] -= 1
            except ValueError:
                pass
            self._front_deferred[tid] = False
            return True
        self.deferred_ticks += 1
        if not self._front_deferred[tid]:
            self._front_deferred[tid] = True
            self.swaps_deferred += 1
        return False

    def _on_complete(self, tid: str) -> None:
        """A tenant's incremental migration finished: release its unit.

        Free holds (transplanted migrations this scheduler refused to
        grant at re-attach) are consumed first and release nothing — the
        unit was never acquired from this pool.
        """
        if self._held_free.get(tid, 0) > 0:
            self._held_free[tid] -= 1
            return
        if self._held.get(tid, 0) > 0:
            self._held[tid] -= 1
            self.scheduler.release(tid)

    def _grant_rows(self, tid: str, want: int) -> int:
        """Per-tick row budget for a tenant's in-flight migration."""
        grant = getattr(self.scheduler, "grant_rows", None)
        if grant is None:
            return want
        return grant(tid, want)

    def _pump(self) -> None:
        """Grant waiting physical work, FIFO, as the scheduler allows."""
        if not self._waiting:
            return
        blocked: set = set()
        keep: Deque[Tuple[str, int]] = collections.deque()
        while self._waiting:
            tid, sid = self._waiting.popleft()
            engine = self._tenants[tid]
            if not engine.backend.has(sid):
                self._waiting_count[tid] -= 1
                continue
            if tid in blocked or not self.scheduler.try_acquire(tid):
                blocked.add(tid)
                keep.append((tid, sid))
                continue
            self._waiting_count[tid] -= 1
            self._granted[tid].append(sid)
            if not engine.incremental:
                # Incremental engines never pre-materialize: rows move at
                # apply time, a micro-batch per tick (see _apply_due_swaps).
                engine.backend.prepare(sid)
        self._waiting = keep

    # ------------------------------------------------------------------
    # Driving the fleet: submit / drain is THE entry point.  ``step``,
    # ``run`` and ``run_batched`` are drivers over it.
    # ------------------------------------------------------------------
    def submit(self, event) -> None:
        """Enqueue one :data:`repro_torch.core.workload.Event` for
        processing (a bare ``(tenant_id, Query)`` pair is coerced with a
        :class:`DeprecationWarning`).  Nothing runs until :meth:`drain`."""
        self._inbox.append(wl.as_event(event))

    @property
    def queue_depth(self) -> int:
        """Events submitted but not yet drained."""
        return len(self._inbox)

    def drain(self, *, batched: bool = False,
              compute: str = "decision_fused",
              frames_per_pass: Optional[int] = None,
              collect: bool = False):
        """Process every submitted event, in submission order.

        By default each event goes through the exact per-event machinery
        (tick, pump, decide, charge, Δ-delayed swap, serve) and the number
        of events processed is returned; ``collect=True`` returns the
        per-event :class:`FleetStepResult` observations instead.

        ``batched=True`` routes the backlog through the fused
        :class:`FleetMatrix` pass (see :meth:`run_batched` for the
        ``compute`` / ``frames_per_pass`` contract); observations are not
        produced on that path, so it is mutually exclusive with
        ``collect``.
        """
        if batched and collect:
            raise ValueError("collect=True needs the per-event path; "
                             "it cannot be combined with batched=True")
        if batched:
            events = list(self._inbox)
            self._inbox.clear()
            self._drain_batched(events, compute=compute,
                                frames_per_pass=frames_per_pass)
            return len(events)
        if collect:
            results = []
            while self._inbox:
                results.append(self._dispatch(self._inbox.popleft()))
            return results
        n = 0
        while self._inbox:
            self._dispatch(self._inbox.popleft())
            n += 1
        return n

    def _dispatch(self, event: wl.Event) -> FleetStepResult:
        """Advance the fleet by one typed event (the per-event hot path)."""
        tenant_id = event.tenant_id
        engine = self._tenants[tenant_id]
        self._tick += 1
        self.scheduler.tick(self._tick)
        self._pump()
        if isinstance(event, wl.IngestEvent):
            # Rows appended to the tenant's table — visible to its very
            # next query, ticking the fleet clock and the scheduler but
            # not the tenant's own index.
            engine.ingest(event.batch.rows)
            return FleetStepResult(tick=self._tick, tenant_id=tenant_id,
                                   step=None, swap_deferred=False)
        before = self.deferred_ticks
        step = engine.step(event.query)
        return FleetStepResult(tick=self._tick, tenant_id=tenant_id,
                               step=step,
                               swap_deferred=self.deferred_ticks > before)

    def step(self, tenant_id: str, event) -> FleetStepResult:
        """Advance the fleet by one interleaved event (payload form).

        ``event`` is a :class:`repro_torch.core.workload.Query` (one tenant
        step) or a :class:`repro_torch.core.workload.IngestBatch`; the pair
        is wrapped into the typed event envelope and dispatched
        immediately, ahead of any submitted backlog.
        """
        if isinstance(event, wl.IngestBatch):
            return self._dispatch(wl.IngestEvent(tenant_id, event))
        return self._dispatch(wl.QueryEvent(tenant_id, event))

    def run(self, events: Iterable[wl.Event],
            name: Optional[str] = None) -> FleetResult:
        """Submit every event, drain, and return the trace.

        Accepts any iterable of typed events, including a
        :class:`repro_torch.core.workload.FleetStream` or a mixed
        query/ingest :class:`repro_torch.core.workload.IngestStream`.
        """
        for event in events:
            self.submit(event)
        self.drain()
        return self.result(name)

    # ------------------------------------------------------------------
    # Batched fleet path over the packed FleetMatrix plane
    # ------------------------------------------------------------------
    def _batchable_matrix(self, tenant_id: str):
        backend = self._tenants[tenant_id].backend
        matrix = getattr(backend, "state_matrix", None)
        if matrix is None or not callable(getattr(backend, "prime_estimates",
                                                  None)):
            raise ValueError(
                f"tenant {tenant_id!r}: backend has no StateMatrix plane — "
                f"run_batched needs every tenant on a matrix-backed backend")
        return matrix

    def _ensure_fleet_matrix(self, compute: str) -> FleetMatrix:
        if self._fleet_matrix is None:
            matrices = {tid: self._batchable_matrix(tid)
                        for tid in self._tenants}
            device = (next(iter(matrices.values())).device if matrices
                      else resolve_device(None))
            fm = FleetMatrix(device, compute_backend=compute,
                             tenant_capacity=len(self._tenants))
            for tid, matrix in matrices.items():
                fm.attach(tid, matrix)
            self._fleet_matrix = fm
        else:
            self._fleet_matrix.set_compute_backend(compute)
        return self._fleet_matrix

    def run_batched(self, events: Iterable[wl.Event],
                    name: Optional[str] = None,
                    compute: str = "decision_fused",
                    frames_per_pass: Optional[int] = None) -> FleetResult:
        """Run the fleet with per-frame fused cost evaluation.

        The event stream is cut into *frames* — maximal runs of events with
        pairwise-distinct tenants (a full round of T events under the
        default round-robin interleave).  Each pass of frames is scored for
        all tenants on the packed :class:`FleetMatrix` plane on the device
        and primed into each tenant's backend; the events are then stepped
        **in exactly the original order through the per-event machinery**
        (tick, pump, decide, charge, Δ-delayed swap, serve — only the
        per-step observation objects are skipped), so decide/charge/swap
        bookkeeping, scheduler grants and Δ-delay semantics are untouched
        and the trace is bit-identical to :meth:`run` under every
        scheduler.  A tenant that mutates its state space mid-decision
        invalidates its primed frame entry (plane-version check) and falls
        back to the exact per-tenant path for that event.

        ``compute`` picks the scoring lane: ``"decision_fused"`` (default)
        scores a whole pass in one launch of the fused decision kernel,
        ``"fleet_scan"`` launches the fleet-scan kernel once per frame.
        Both compare in float64, so both are exact.

        Ingest events are handled inline, through the same per-event
        machinery as :meth:`run`, and end a pass's frames.

        When every tenant's policy implements the
        :class:`repro_torch.engine.policies.BatchablePolicy` contract (and
        no incremental executor or ingest debt is attached), passes in
        which no event charges a reorganization and no swap is
        pending resolve through a *bulk* path: the decision rule runs once
        per tenant over the stacked primed cost matrix and the per-event
        bookkeeping (cost trace, state trace, index, fleet clock) is
        committed wholesale.  Any pass containing a charge, a pending swap,
        or a stale prime is replayed through the exact per-event machinery.

        ``frames_per_pass`` controls how many frames are scored per pass;
        the default scales with fleet size so one pass covers a few hundred
        events — about a thousand when the bulk path is available.
        """
        for event in events:
            self.submit(event)
        self.drain(batched=True, compute=compute,
                   frames_per_pass=frames_per_pass)
        return self.result(name)

    def _drain_batched(self, events: List[wl.Event], compute: str,
                       frames_per_pass: Optional[int]) -> None:
        fm = self._ensure_fleet_matrix(compute)
        scheduler = self.scheduler
        # Per-tenant hot-loop facts hoisted out of the inner loop; the
        # serve memo is only primable where serve() charges exact metadata
        # scores (see InMemoryBackend._serve_primable).
        prep = {tid: (e, e.backend,
                      bool(getattr(e.backend, "_serve_primable", False)))
                for tid, e in self._tenants.items()}
        # Materialize every tenant's initial layout up front (idempotent;
        # a first step would do it anyway) so even the first fused pass
        # scores fully-populated planes instead of falling back.
        for engine, _, _ in prep.values():
            engine.start()
        # Static bulk-path eligibility: every tenant must carry a pure
        # batched decision rule and bookkeeping a no-swap frame can replay
        # wholesale (no incremental executor ticking per step, no ingest
        # debt observing per query, exact primable serve scores).
        bulk_ok = all(
            callable(getattr(engine.policy, "decide_frames", None))
            and engine.reorg_executor is None and engine._debt is None
            and primable
            for engine, _, primable in prep.values())
        n_tenants = len(prep)
        if frames_per_pass is None:
            # A few hundred events per pass amortizes the fixed Python
            # cost of a fused pass; with the bulk decide path available
            # the per-pass fixed cost is all that's left, so larger
            # passes pay off.
            per_pass = 1024 if bulk_ok else 256
            frames_per_pass = max(1, per_pass // max(n_tenants, 1))
        # Whether to skip prime-tuple materialization on the next pass:
        # flips off after a refused bulk commit (the replay needs primes,
        # and a switch-heavy stretch would otherwise score twice), back
        # on after a successful one.
        dense_hint = True
        i, n = 0, len(events)
        while i < n:
            if isinstance(events[i], wl.IngestEvent):
                # Ingest event: handled inline through the same per-event
                # machinery as :meth:`_dispatch` (tick, scheduler, pump,
                # append) — never scored by the fused pass, so a stream
                # without ingest events takes exactly the path without.
                tid, batch = events[i]
                self._tick += 1
                scheduler.tick(self._tick)
                if self._waiting:
                    self._pump()
                prep[tid][0].ingest(batch.rows)
                i += 1
                continue
            frames: List[List[wl.QueryEvent]] = []
            while len(frames) < frames_per_pass and i < n:
                j = i
                seen = set()
                while (j < n and isinstance(events[j], wl.QueryEvent)
                       and events[j][0] not in seen):
                    seen.add(events[j][0])
                    j += 1
                frames.append(events[i:j])
                i = j
                if j < n and isinstance(events[j], wl.IngestEvent):
                    break
            # A regular pass headed for the bulk path never reads the
            # per-event prime tuples — score dense-only and, in the rare
            # case the bulk commit is refused (pending swap, stale plane,
            # a charged reorg), rescore with primes: the plane is
            # untouched in between, so the rescore is bit-identical.
            dense_only = (bulk_ok and dense_hint
                          and all(len(f) == n_tenants for f in frames))
            primed = fm.estimate_frames(frames, want_primes=not dense_only)
            if bulk_ok:
                if self._bulk_pass(frames, primed, prep):
                    dense_hint = True
                    continue
                dense_hint = False
                if dense_only:
                    primed = fm.estimate_frames(frames)
            for frame, primes in zip(frames, primed):
                for (tid, q), prime in zip(frame, primes):
                    # Inlined per-event path: same tick/pump/step sequence
                    # as :meth:`step`, minus the FleetStepResult observation.
                    engine, backend, primable = prep[tid]
                    if prime is not None:
                        # Direct install of (query, version, costs) — the
                        # attribute form of backend.prime_estimates, minus
                        # one method call on the hottest line of the fleet.
                        # Stale costs are rejected at consumption time by
                        # the version check in _primed_costs.
                        backend._primed = (q, prime[0], prime[1])
                        if (primable and prime[2] is not None
                                and prime[0] == backend._matrix.version):
                            # Shadow serve score from the same fused pass.
                            # The version guard matters: a swap that landed
                            # at an *earlier* event of this pass bumped the
                            # plane version (activate registers the new
                            # shadow), so a score computed pre-swap must
                            # not be installed over the cleared memo — a
                            # policy that never re-estimates would
                            # otherwise serve it.  A swap landing at *this*
                            # event clears the memo after installation
                            # (activate() resets it), which stays safe.
                            backend._serve_memo = (q, prime[2])
                    self._tick += 1
                    scheduler.tick(self._tick)
                    if self._waiting:
                        self._pump()
                    engine.step_fast(q)

    def _bulk_pass(self, frames, primed, prep) -> bool:
        """Commit one scored pass without per-event Python, if legal.

        Returns True when the whole pass was resolved in bulk; False
        commits nothing — the caller replays the identical pass through
        the exact per-event machinery.

        Legality is exactly "no event of the pass can touch swap or
        scheduler state": no reorganization waiting for a grant, no
        pending Δ-delayed swap, every prime current (plane untouched since
        scoring) with a ready-made serve score, and no tenant's batched
        rule charging a reorganization.  Under those conditions each event
        reduces to appending its primed serve cost and decision state, and
        the scheduler clock may advance in one jump: ``tick`` is idempotent
        arithmetic over elapsed ticks, and with no acquires in the region
        no grant decision can depend on the intermediate values.
        """
        if self._waiting:
            return False
        # Fast dense path: on a *regular* pass (every frame holds exactly
        # one event per tenant) where every tenant's costs came out of the
        # batched (B, T, S) reduction, each tenant's whole cost matrix is
        # one slice ``batched[:, row, :n]`` and its serve scores one column.
        fm = self._fleet_matrix
        dense = fm.last_pass_dense if fm is not None else None
        t = len(prep)
        if dense is not None and all(len(frame) == t for frame in frames):
            batched, dinfo = dense
            b = len(frames)
            decided = []
            for tid, (engine, backend, _) in prep.items():
                d = dinfo.get(tid)
                if d is None:
                    decided = None          # mixed plane: prime-tuple path
                    break
                row, n_states, version, shadow = d
                if engine._pending_swaps or version != backend._matrix.version:
                    return False
                costs = batched[:, row, :n_states]
                states, reorg = engine.policy.decide_frames(costs, backend)
                if reorg is not None and np.any(reorg):
                    return False
                decided.append((engine, states, costs[:, shadow]))
            if decided is not None:
                for engine, states, serve in decided:
                    engine._query_costs.extend(serve.tolist())
                    engine._state_seq.extend(states.tolist())
                    engine._index += b
                self._tick += b * t
                self.scheduler.tick(self._tick)
                return True
        per: Dict[str, List[tuple]] = {}
        for frame, primes in zip(frames, primed):
            for (tid, _), prime in zip(frame, primes):
                if prime is None or prime[2] is None:
                    return False
                per.setdefault(tid, []).append(prime)
        decided = []
        for tid, plist in per.items():
            engine, backend, _ = prep[tid]
            if engine._pending_swaps or plist[0][0] != backend._matrix.version:
                return False
            costs = np.stack([p[1] for p in plist])
            states, reorg = engine.policy.decide_frames(costs, backend)
            if reorg is not None and np.any(reorg):
                return False
            decided.append((engine, states, plist))
        total = 0
        for engine, states, plist in decided:
            engine._query_costs.extend(p[2] for p in plist)
            engine._state_seq.extend(int(s) for s in states)
            engine._index += len(plist)
            total += len(plist)
        self._tick += total
        self.scheduler.tick(self._tick)
        return True

    def shard_fleets(self) -> List["FleetEngine"]:
        """The concrete fleets behind this sink: itself."""
        return [self]

    def stats(self) -> dict:
        """Fleet counters (one shard's worth of the event-sink contract)."""
        sched = (self.scheduler.stats()
                 if callable(getattr(self.scheduler, "stats", None)) else {})
        return {
            "name": self.name,
            "tenants": len(self._tenants),
            "queue_depth": len(self._inbox),
            "ticks": self._tick,
            "swaps_deferred": self.swaps_deferred,
            "deferred_ticks": self.deferred_ticks,
            "scheduler": sched,
        }

    def result(self, name: Optional[str] = None) -> FleetResult:
        stats = (self.scheduler.stats()
                 if callable(getattr(self.scheduler, "stats", None)) else {})
        return FleetResult(
            name=name or self.name,
            scheduler=self.scheduler.name,
            per_tenant={tid: engine.result()
                        for tid, engine in self._tenants.items()},
            ticks=self._tick,
            swaps_deferred=self.swaps_deferred,
            deferred_ticks=self.deferred_ticks,
            scheduler_stats=stats,
        )
