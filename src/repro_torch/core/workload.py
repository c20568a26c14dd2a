"""Query workload generation.

The paper's workload generator: a state machine that samples range queries
from one query *template* for an arbitrary amount of time before switching
to another random template (§VI-A2).  Templates focus on a small set of
columns with a target selectivity, mimicking TPC-H/TPC-DS template families.

Beyond the single-stream generator, this module hosts the typed fleet
event envelope (:class:`QueryEvent`, :class:`IngestEvent`) and the
**drift-scenario registry** (:data:`DRIFT_SCENARIOS`): named generators of
interleaved multi-tenant :class:`FleetStream`\\ s -- sudden template shift,
gradual interpolated drift, cyclic/diurnal rotation, flash-crowd burst and
template churn -- the workload conditions a multi-tenant fleet
(:class:`repro_torch.engine.FleetEngine`) is exercised under -- and the
**ingest-scenario registry** (:data:`INGEST_SCENARIOS`): mixed read/write
:class:`IngestStream`\\ s whose appended :class:`IngestBatch`\\ es land as
delta partitions (:mod:`repro_torch.engine.ingest`).

Queries and appended batches stay on the host: query bounds are ``(C,)``
float64 numpy arrays and batches ``(N, C)`` ones, drawn from numpy
``Generator``s seeded exactly as the reference package draws them, so the
same seed gives the same stream.  A batch goes to the device once, when
an engine appends it.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import (Callable, Dict, Iterator, List, NamedTuple, Optional,
                    Sequence, Tuple, Union)

import numpy as np


@dataclasses.dataclass(frozen=True)
class Query:
    """Conjunctive range query: per-column [lo, hi] bounds ((C,) arrays)."""

    lo: np.ndarray
    hi: np.ndarray
    template_id: int = -1

    @property
    def num_columns(self) -> int:
        return int(self.lo.shape[0])


def stack_queries(queries: Sequence[Query]) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorize a list of queries into (Q, C) lo/hi arrays."""
    if not queries:
        raise ValueError("empty query list")
    lo = np.stack([q.lo for q in queries])
    hi = np.stack([q.hi for q in queries])
    return lo, hi


# ---------------------------------------------------------------------------
# The typed event envelope (the fleet-level request API)
# ---------------------------------------------------------------------------

class QueryEvent(NamedTuple):
    """One tenant's range query, addressed to the fleet.

    A ``NamedTuple`` on purpose: it *is* the ``(tenant_id, query)`` pair,
    so streams of typed events unpack, index and compare like tuples.
    """

    tenant_id: str
    query: Query


class IngestEvent(NamedTuple):
    """One tenant's append batch, addressed to the fleet.

    Tuple-compatible with the ``(tenant_id, IngestBatch)`` pair, like
    :class:`QueryEvent`.
    """

    tenant_id: str
    batch: "IngestBatch"


#: The fleet's one request envelope.
Event = Union[QueryEvent, IngestEvent]


def as_event(obj) -> Event:
    """Coerce a request into the typed :data:`Event` union.

    Typed events pass through untouched.  Bare ``(tenant_id, Query)`` /
    ``(tenant_id, IngestBatch)`` pairs still work but raise a
    :class:`DeprecationWarning`.
    """
    if isinstance(obj, (QueryEvent, IngestEvent)):
        return obj
    if isinstance(obj, (tuple, list)) and len(obj) == 2:
        tid, payload = obj
        if isinstance(payload, Query):
            warnings.warn(
                "bare (tenant_id, Query) event tuples are deprecated; "
                "pass repro_torch.core.workload.QueryEvent(tenant_id, query)",
                DeprecationWarning, stacklevel=3)
            return QueryEvent(str(tid), payload)
        if isinstance(payload, IngestBatch):
            warnings.warn(
                "bare (tenant_id, IngestBatch) event tuples are deprecated; "
                "pass repro_torch.core.workload.IngestEvent(tenant_id, "
                "batch)", DeprecationWarning, stacklevel=3)
            return IngestEvent(str(tid), payload)
    raise TypeError(
        f"not a fleet event: {obj!r} (expected QueryEvent, IngestEvent, or "
        f"a (tenant_id, Query|IngestBatch) pair)")


@dataclasses.dataclass(frozen=True)
class QueryTemplate:
    """A template: a set of predicate columns + target per-column selectivity."""

    template_id: int
    columns: Tuple[int, ...]
    selectivities: Tuple[float, ...]

    def sample(self, rng: np.random.Generator, col_lo: np.ndarray,
               col_hi: np.ndarray) -> Query:
        c = col_lo.shape[0]
        lo = np.full(c, -np.inf)
        hi = np.full(c, np.inf)
        for col, sel in zip(self.columns, self.selectivities):
            span = col_hi[col] - col_lo[col]
            width = span * sel
            start = col_lo[col] + rng.uniform(0.0, max(span - width, 1e-12))
            lo[col] = start
            hi[col] = start + width
        return Query(lo=lo, hi=hi, template_id=self.template_id)


def make_templates(num_templates: int, num_columns: int,
                   rng: np.random.Generator,
                   cols_per_template: Tuple[int, int] = (1, 3),
                   selectivity_range: Tuple[float, float] = (0.01, 0.15),
                   ) -> List[QueryTemplate]:
    """Random template set: each focuses on 1-3 columns (paper's generator)."""
    templates = []
    for t in range(num_templates):
        k = int(rng.integers(cols_per_template[0], cols_per_template[1] + 1))
        cols = tuple(int(c) for c in rng.choice(num_columns, size=k,
                                                replace=False))
        sels = tuple(float(rng.uniform(*selectivity_range)) for _ in range(k))
        templates.append(QueryTemplate(t, cols, sels))
    return templates


@dataclasses.dataclass
class WorkloadStream:
    """Materialized workload: queries + ground-truth template segmentation."""

    queries: List[Query]
    segments: List[Tuple[int, int, int]]   # (start_idx, end_idx_excl, template_id)
    templates: List[QueryTemplate]

    def __len__(self) -> int:
        return len(self.queries)

    def __iter__(self) -> Iterator[Query]:
        return iter(self.queries)

    @property
    def num_switches(self) -> int:
        return max(len(self.segments) - 1, 0)


def generate_workload(templates: Sequence[QueryTemplate],
                      col_lo: np.ndarray, col_hi: np.ndarray,
                      total_queries: int,
                      seed: int = 0,
                      segment_length: Tuple[int, int] = (800, 2200),
                      num_segments: Optional[int] = None) -> WorkloadStream:
    """State-machine workload: stay in one template for a random stretch,
    then jump to another random template (never the same one twice in a row).
    """
    rng = np.random.default_rng(seed)
    queries: List[Query] = []
    segments: List[Tuple[int, int, int]] = []
    current = int(rng.integers(len(templates)))
    if num_segments is not None:
        # Divide the stream into exactly num_segments segments.
        cuts = np.linspace(0, total_queries, num_segments + 1).astype(int)
        lengths = np.diff(cuts)
    else:
        lengths = []
        remaining = total_queries
        while remaining > 0:
            ln = int(rng.integers(*segment_length))
            ln = min(ln, remaining)
            lengths.append(ln)
            remaining -= ln
    start = 0
    for ln in lengths:
        for _ in range(ln):
            queries.append(templates[current].sample(rng, col_lo, col_hi))
        segments.append((start, start + ln, current))
        start += ln
        # Switch template.
        if len(templates) > 1:
            nxt = int(rng.integers(len(templates)))
            while nxt == current:
                nxt = int(rng.integers(len(templates)))
            current = nxt
    return WorkloadStream(queries=queries, segments=segments,
                          templates=list(templates))


# ---------------------------------------------------------------------------
# Multi-tenant drift scenarios
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FleetStream:
    """An interleaved multi-tenant workload with per-tenant ground truth.

    ``events`` is the fleet-level stream of :class:`QueryEvent`\\ s in
    arrival order; ``per_tenant`` holds each tenant's queries *in the same
    relative order* as an ordinary :class:`WorkloadStream` (with its own
    segmentation), so a tenant's standalone run over ``per_tenant[tid]`` is
    the golden reference for its fleet trace.
    """

    scenario: str
    events: List[QueryEvent]
    per_tenant: Dict[str, WorkloadStream]

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self) -> Iterator[QueryEvent]:
        return iter(self.events)

    @property
    def tenant_ids(self) -> List[str]:
        return list(self.per_tenant)


#: name -> scenario generator; populated by :func:`drift_scenario` below.
DRIFT_SCENARIOS: Dict[str, Callable[..., FleetStream]] = {}


@dataclasses.dataclass(frozen=True)
class ScenarioInfo:
    """Ground-truth drift parameters of a registered scenario.

    All tick-valued quantities are fractions of a tenant's stream
    (scenarios scale with ``queries_per_tenant``); :meth:`period_ticks`
    gives the absolute cycle length.  ``forecastable`` marks scenarios
    whose structure a workload forecaster can exploit in principle
    (recurring or smoothly drifting mixtures).
    """

    name: str
    family: str                     # "drift" | "ingest"
    forecastable: bool = False
    #: Cyclic scenarios: templates per cycle / cycles per stream.
    num_phases: Optional[int] = None
    cycles: Optional[int] = None
    #: One-shot shifts: the (lo, hi) fraction window the shift tick is
    #: drawn from per tenant.
    shift_window: Optional[Tuple[float, float]] = None
    #: Gradual drift: fraction of the stream the mixture slides over.
    drift_span: Optional[float] = None
    #: Flash crowd: burst start fraction and burst length fraction.
    burst_start: Optional[float] = None
    burst_fraction: Optional[float] = None
    #: Template churn: fresh-template segments per stream.
    num_segments: Optional[int] = None

    def period_ticks(self, queries_per_tenant: int) -> Optional[int]:
        """Per-tenant cycle length in queries, if the scenario cycles."""
        if self.num_phases is None or self.cycles is None:
            return None
        block = max(queries_per_tenant // (self.num_phases * self.cycles), 1)
        return self.num_phases * block

    def drift_rate(self, queries_per_tenant: int) -> Optional[float]:
        """Mixture-share change per query, if the scenario drifts."""
        if self.drift_span is None:
            return None
        span = self.drift_span * max(queries_per_tenant - 1, 1)
        return 1.0 / span


#: name -> ScenarioInfo for every registered scenario.
SCENARIO_INFO: Dict[str, ScenarioInfo] = {}


def forecastable_scenarios() -> List[str]:
    """Names of registered scenarios a forecaster can exploit."""
    return sorted(n for n, i in SCENARIO_INFO.items() if i.forecastable)


def drift_scenario(name: str, forecastable: bool = False, **meta):
    """Register a named multi-tenant drift-scenario generator; keyword
    metadata lands in :data:`SCENARIO_INFO` as a :class:`ScenarioInfo`."""
    def deco(fn):
        DRIFT_SCENARIOS[name] = fn
        SCENARIO_INFO[name] = ScenarioInfo(name=name, family="drift",
                                           forecastable=forecastable, **meta)
        fn.scenario_name = name
        return fn
    return deco


def make_drift_scenario(name: str, col_lo: np.ndarray, col_hi: np.ndarray,
                        num_tenants: int = 4, queries_per_tenant: int = 2000,
                        seed: int = 0, **kwargs) -> FleetStream:
    """Instantiate a registered drift scenario by name."""
    if name not in DRIFT_SCENARIOS:
        raise KeyError(f"unknown drift scenario {name!r}; "
                       f"known: {sorted(DRIFT_SCENARIOS)}")
    return DRIFT_SCENARIOS[name](
        col_lo=col_lo, col_hi=col_hi, num_tenants=num_tenants,
        queries_per_tenant=queries_per_tenant, seed=seed, **kwargs)


def _stream_from_plan(plan: Sequence[Tuple[QueryTemplate, int]],
                      templates: Sequence[QueryTemplate],
                      col_lo: np.ndarray, col_hi: np.ndarray,
                      rng: np.random.Generator) -> WorkloadStream:
    """Materialize a (template, segment_length) plan into a WorkloadStream."""
    queries: List[Query] = []
    segments: List[Tuple[int, int, int]] = []
    start = 0
    for tmpl, length in plan:
        for _ in range(length):
            queries.append(tmpl.sample(rng, col_lo, col_hi))
        if length > 0:
            segments.append((start, start + length, tmpl.template_id))
        start += length
    return WorkloadStream(queries=queries, segments=segments,
                          templates=list(templates))


def interleave_streams(per_tenant: Dict[str, WorkloadStream],
                       weight_fn: Optional[Callable[[str, int], float]] = None,
                       ) -> List[QueryEvent]:
    """Deterministic weighted-fair interleave of per-tenant streams.

    Smooth weighted round-robin: each pick adds every live tenant's current
    weight to its credit, emits the highest-credit tenant's next query, and
    debits that tenant by the total live weight.  ``weight_fn(tenant_id,
    next_index)`` may vary over a tenant's progress (e.g. a flash-crowd
    burst); the default is uniform round-robin.  Per-tenant query order is
    always preserved.
    """
    tids = sorted(per_tenant)
    cursors = {tid: 0 for tid in tids}
    credits = {tid: 0.0 for tid in tids}
    events: List[QueryEvent] = []
    total = sum(len(s) for s in per_tenant.values())
    for _ in range(total):
        live = [t for t in tids if cursors[t] < len(per_tenant[t].queries)]
        weights = {t: (weight_fn(t, cursors[t]) if weight_fn else 1.0)
                   for t in live}
        for t in live:
            credits[t] += weights[t]
        pick = max(live, key=lambda t: credits[t])
        credits[pick] -= sum(weights.values())
        events.append(QueryEvent(pick, per_tenant[pick].queries[cursors[pick]]))
        cursors[pick] += 1
    return events


def _scenario_rngs(seed: int, num_tenants: int) -> List[np.random.Generator]:
    """One independent generator per tenant (tenants are separate tables)."""
    root = np.random.SeedSequence(seed)
    return [np.random.default_rng(s) for s in root.spawn(num_tenants)]


@drift_scenario("sudden_shift", shift_window=(0.35, 0.65))
def sudden_shift(col_lo: np.ndarray, col_hi: np.ndarray, num_tenants: int = 4,
                 queries_per_tenant: int = 2000, seed: int = 0,
                 ) -> FleetStream:
    """Each tenant abruptly switches template once, at a staggered point
    drawn from ``shift_window``, so the fleet sees a rolling wave of
    reorganization pressure."""
    per_tenant: Dict[str, WorkloadStream] = {}
    for t, rng in enumerate(_scenario_rngs(seed, num_tenants)):
        tmpls = make_templates(2, col_lo.shape[0], rng)
        shift = int(queries_per_tenant * rng.uniform(0.35, 0.65))
        plan = [(tmpls[0], shift),
                (tmpls[1], queries_per_tenant - shift)]
        per_tenant[f"t{t}"] = _stream_from_plan(plan, tmpls, col_lo, col_hi,
                                                rng)
    return FleetStream("sudden_shift", interleave_streams(per_tenant),
                       per_tenant)


@drift_scenario("gradual_drift", forecastable=True, drift_span=1.0)
def gradual_drift(col_lo: np.ndarray, col_hi: np.ndarray,
                  num_tenants: int = 4, queries_per_tenant: int = 2000,
                  seed: int = 0) -> FleetStream:
    """Smoothly interpolated drift from one template to another: query
    ``j`` samples the target template with probability ``j / (T - 1)``."""
    per_tenant: Dict[str, WorkloadStream] = {}
    for t, rng in enumerate(_scenario_rngs(seed, num_tenants)):
        tmpls = make_templates(2, col_lo.shape[0], rng)
        total = queries_per_tenant
        queries: List[Query] = []
        for j in range(total):
            frac = j / max(total - 1, 1)
            tmpl = tmpls[1] if rng.uniform() < frac else tmpls[0]
            queries.append(tmpl.sample(rng, col_lo, col_hi))
        # Ground-truth segmentation is approximate by construction: label
        # the source-dominant and target-dominant halves.
        segments = [(0, total // 2, tmpls[0].template_id),
                    (total // 2, total, tmpls[1].template_id)]
        per_tenant[f"t{t}"] = WorkloadStream(queries=queries,
                                             segments=segments,
                                             templates=list(tmpls))
    return FleetStream("gradual_drift", interleave_streams(per_tenant),
                       per_tenant)


@drift_scenario("cyclic_diurnal", forecastable=True, num_phases=3,
                cycles=4)
def cyclic_diurnal(col_lo: np.ndarray, col_hi: np.ndarray,
                   num_tenants: int = 4, queries_per_tenant: int = 2000,
                   seed: int = 0, num_phases: int = 3, cycles: int = 4,
                   ) -> FleetStream:
    """Diurnal rotation: templates recur in a fixed cycle, phase-shifted
    per tenant (tenants "peak" at different times of day)."""
    per_tenant: Dict[str, WorkloadStream] = {}
    for t, rng in enumerate(_scenario_rngs(seed, num_tenants)):
        tmpls = make_templates(num_phases, col_lo.shape[0], rng)
        block = max(queries_per_tenant // (num_phases * cycles), 1)
        phase0 = t % num_phases                     # per-tenant phase shift
        plan: List[Tuple[QueryTemplate, int]] = []
        emitted = 0
        k = 0
        while emitted < queries_per_tenant:
            tmpl = tmpls[(phase0 + k) % num_phases]
            length = min(block, queries_per_tenant - emitted)
            plan.append((tmpl, length))
            emitted += length
            k += 1
        per_tenant[f"t{t}"] = _stream_from_plan(plan, tmpls, col_lo, col_hi,
                                                rng)
    return FleetStream("cyclic_diurnal", interleave_streams(per_tenant),
                       per_tenant)


@drift_scenario("flash_crowd", burst_start=0.4, burst_fraction=0.15)
def flash_crowd(col_lo: np.ndarray, col_hi: np.ndarray, num_tenants: int = 4,
                queries_per_tenant: int = 2000, seed: int = 0,
                burst_tenant: int = 0, burst_frac: float = 0.15,
                burst_rate: float = 4.0) -> FleetStream:
    """One tenant's traffic spikes: a hot template takes over *and* its
    event rate multiplies by ``burst_rate`` for the burst window."""
    burst_tid = f"t{burst_tenant % num_tenants}"
    per_tenant: Dict[str, WorkloadStream] = {}
    burst_range: Tuple[int, int] = (0, 0)
    for t, rng in enumerate(_scenario_rngs(seed, num_tenants)):
        tid = f"t{t}"
        tmpls = make_templates(2, col_lo.shape[0], rng)
        if tid == burst_tid:
            burst_len = int(queries_per_tenant * burst_frac)
            start = int(queries_per_tenant * 0.4)
            plan = [(tmpls[0], start),
                    (tmpls[1], burst_len),            # the flash crowd
                    (tmpls[0], queries_per_tenant - start - burst_len)]
            burst_range = (start, start + burst_len)
        else:
            plan = [(tmpls[0], queries_per_tenant)]
        per_tenant[tid] = _stream_from_plan(plan, tmpls, col_lo, col_hi, rng)

    def weight(tid: str, next_index: int) -> float:
        if tid == burst_tid and burst_range[0] <= next_index < burst_range[1]:
            return burst_rate
        return 1.0

    return FleetStream("flash_crowd",
                       interleave_streams(per_tenant, weight_fn=weight),
                       per_tenant)


@drift_scenario("template_churn", num_segments=6)
def template_churn(col_lo: np.ndarray, col_hi: np.ndarray,
                   num_tenants: int = 4, queries_per_tenant: int = 2000,
                   seed: int = 0, num_segments: int = 6) -> FleetStream:
    """Templates enter and leave: every segment brings a never-seen-before
    template and retires the previous one."""
    per_tenant: Dict[str, WorkloadStream] = {}
    for t, rng in enumerate(_scenario_rngs(seed, num_tenants)):
        c = col_lo.shape[0]
        segs = max(num_segments, 1)
        cuts = np.linspace(0, queries_per_tenant, segs + 1).astype(int)
        tmpls: List[QueryTemplate] = []
        plan: List[Tuple[QueryTemplate, int]] = []
        for s in range(segs):
            fresh = make_templates(1, c, rng)[0]
            fresh = dataclasses.replace(fresh, template_id=s)
            tmpls.append(fresh)
            plan.append((fresh, int(cuts[s + 1] - cuts[s])))
        per_tenant[f"t{t}"] = _stream_from_plan(plan, tmpls, col_lo, col_hi,
                                                rng)
    return FleetStream("template_churn", interleave_streams(per_tenant),
                       per_tenant)


# ---------------------------------------------------------------------------
# Streaming ingest scenarios (mixed read/write event streams)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IngestBatch:
    """One append event: rows to land as an unclustered delta partition."""

    rows: np.ndarray            # (N, C) host float64; uploaded on append
    batch_id: int = -1

    @property
    def num_rows(self) -> int:
        return int(len(self.rows))


@dataclasses.dataclass
class IngestStream:
    """An interleaved multi-tenant stream mixing queries and appends.

    ``events`` is the fleet-level arrival order of typed :data:`Event`
    envelopes (:class:`QueryEvent` / :class:`IngestEvent`, each
    tuple-compatible with the legacy ``(tenant_id, payload)`` pairs);
    ``per_tenant`` preserves each tenant's own event order (the golden
    reference for a standalone replay of that tenant).
    """

    scenario: str
    events: List[Event]
    per_tenant: Dict[str, List[object]]

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self) -> Iterator[Event]:
        return iter(self.events)

    @property
    def tenant_ids(self) -> List[str]:
        return list(self.per_tenant)

    def tenant_queries(self, tenant_id: str) -> List[Query]:
        return [e for e in self.per_tenant[tenant_id]
                if isinstance(e, Query)]

    def tenant_batches(self, tenant_id: str) -> List[IngestBatch]:
        return [e for e in self.per_tenant[tenant_id]
                if isinstance(e, IngestBatch)]

    @property
    def total_appended_rows(self) -> int:
        return sum(e[1].num_rows for e in self.events
                   if isinstance(e[1], IngestBatch))


#: name -> scenario generator; populated by :func:`ingest_scenario` below.
INGEST_SCENARIOS: Dict[str, Callable[..., IngestStream]] = {}


def ingest_scenario(name: str, forecastable: bool = False, **meta):
    """Register a named mixed read/write scenario generator (metadata
    lands in :data:`SCENARIO_INFO`, exactly like :func:`drift_scenario`)."""
    def deco(fn):
        INGEST_SCENARIOS[name] = fn
        SCENARIO_INFO[name] = ScenarioInfo(name=name, family="ingest",
                                           forecastable=forecastable, **meta)
        fn.scenario_name = name
        return fn
    return deco


def make_ingest_scenario(name: str, col_lo: np.ndarray, col_hi: np.ndarray,
                         num_tenants: int = 3,
                         queries_per_tenant: int = 1500,
                         seed: int = 0, **kwargs) -> IngestStream:
    """Instantiate a registered ingest scenario by name."""
    if name not in INGEST_SCENARIOS:
        raise KeyError(f"unknown ingest scenario {name!r}; "
                       f"known: {sorted(INGEST_SCENARIOS)}")
    return INGEST_SCENARIOS[name](
        col_lo=col_lo, col_hi=col_hi, num_tenants=num_tenants,
        queries_per_tenant=queries_per_tenant, seed=seed, **kwargs)


def interleave_event_streams(per_tenant: Dict[str, List[object]],
                             weight_fn: Optional[Callable[[str, int],
                                                          float]] = None,
                             ) -> List[Event]:
    """Smooth-WRR interleave of per-tenant *mixed* event lists.

    Identical discipline to :func:`interleave_streams` (same credits, same
    tie-breaking), generalized from query lists to lists that may also
    hold :class:`IngestBatch` events.  Per-tenant event order is always
    preserved.
    """
    tids = sorted(per_tenant)
    cursors = {tid: 0 for tid in tids}
    credits = {tid: 0.0 for tid in tids}
    events: List[Event] = []
    total = sum(len(s) for s in per_tenant.values())
    for _ in range(total):
        live = [t for t in tids if cursors[t] < len(per_tenant[t])]
        weights = {t: (weight_fn(t, cursors[t]) if weight_fn else 1.0)
                   for t in live}
        for t in live:
            credits[t] += weights[t]
        pick = max(live, key=lambda t: credits[t])
        credits[pick] -= sum(weights.values())
        payload = per_tenant[pick][cursors[pick]]
        events.append(QueryEvent(pick, payload)
                      if isinstance(payload, Query)
                      else IngestEvent(pick, payload))
        cursors[pick] += 1
    return events


def _sample_batch(rng: np.random.Generator, col_lo: np.ndarray,
                  col_hi: np.ndarray, rows: int) -> IngestBatch:
    """Uniform rows over the full domain: maximally unclustered appends
    (a delta partition's bounds then span whatever arrived, so queries
    can rarely skip it — the worst case the debt meter prices)."""
    return IngestBatch(rows=rng.uniform(col_lo, col_hi,
                                        size=(rows, col_lo.shape[0])))


def _weave(queries: Sequence[Query],
           batch_after: Dict[int, List[IngestBatch]]) -> List[object]:
    """Per-tenant event list: each query, with any batches scheduled
    after it inserted in order (index -1 batches lead the stream)."""
    events: List[object] = list(batch_after.get(-1, []))
    for k, q in enumerate(queries):
        events.append(q)
        events.extend(batch_after.get(k, []))
    return events


@ingest_scenario("trickle")
def trickle_ingest(col_lo: np.ndarray, col_hi: np.ndarray,
                   num_tenants: int = 3, queries_per_tenant: int = 1500,
                   seed: int = 0, every: int = 10, batch_rows: int = 40,
                   ) -> IngestStream:
    """Steady trickle: a small append every ``every`` queries, one stable
    query template — the base case for debt-metered compaction."""
    per_tenant: Dict[str, List[object]] = {}
    for t, rng in enumerate(_scenario_rngs(seed, num_tenants)):
        tmpls = make_templates(1, col_lo.shape[0], rng)
        stream = _stream_from_plan([(tmpls[0], queries_per_tenant)], tmpls,
                                   col_lo, col_hi, rng)
        batches = {k: [_sample_batch(rng, col_lo, col_hi, batch_rows)]
                   for k in range(every - 1, queries_per_tenant, every)}
        per_tenant[f"t{t}"] = _weave(stream.queries, batches)
    return IngestStream("trickle", interleave_event_streams(per_tenant),
                        per_tenant)


@ingest_scenario("append_heavy")
def append_heavy(col_lo: np.ndarray, col_hi: np.ndarray,
                 num_tenants: int = 3, queries_per_tenant: int = 1500,
                 seed: int = 0, every: int = 4, batch_rows: int = 80,
                 ) -> IngestStream:
    """Write-dominated: frequent, larger appends keep delta partitions
    piling on faster than any single compaction clears them."""
    per_tenant: Dict[str, List[object]] = {}
    for t, rng in enumerate(_scenario_rngs(seed, num_tenants)):
        tmpls = make_templates(1, col_lo.shape[0], rng)
        stream = _stream_from_plan([(tmpls[0], queries_per_tenant)], tmpls,
                                   col_lo, col_hi, rng)
        batches = {k: [_sample_batch(rng, col_lo, col_hi, batch_rows)]
                   for k in range(every - 1, queries_per_tenant, every)}
        per_tenant[f"t{t}"] = _weave(stream.queries, batches)
    return IngestStream("append_heavy", interleave_event_streams(per_tenant),
                        per_tenant)


@ingest_scenario("mixed_rw", shift_window=(0.4, 0.6))
def mixed_rw(col_lo: np.ndarray, col_hi: np.ndarray, num_tenants: int = 3,
             queries_per_tenant: int = 1500, seed: int = 0,
             every: int = 8, batch_rows: int = 50) -> IngestStream:
    """Reads drift while writes trickle: a mid-stream template shift makes
    drift reorgs and debt compactions compete for the same α budget."""
    per_tenant: Dict[str, List[object]] = {}
    for t, rng in enumerate(_scenario_rngs(seed, num_tenants)):
        tmpls = make_templates(2, col_lo.shape[0], rng)
        shift = int(queries_per_tenant * rng.uniform(0.4, 0.6))
        stream = _stream_from_plan(
            [(tmpls[0], shift), (tmpls[1], queries_per_tenant - shift)],
            tmpls, col_lo, col_hi, rng)
        batches = {k: [_sample_batch(rng, col_lo, col_hi, batch_rows)]
                   for k in range(every - 1, queries_per_tenant, every)}
        per_tenant[f"t{t}"] = _weave(stream.queries, batches)
    return IngestStream("mixed_rw", interleave_event_streams(per_tenant),
                        per_tenant)


@ingest_scenario("ingest_burst")
def ingest_burst(col_lo: np.ndarray, col_hi: np.ndarray,
                 num_tenants: int = 3, queries_per_tenant: int = 1500,
                 seed: int = 0, burst_start: float = 0.3,
                 burst_end: float = 0.5, every: int = 3,
                 batch_rows: int = 100) -> IngestStream:
    """A concentrated load window then a long read-only tail: everything
    appended lands inside ``[burst_start, burst_end)`` of the stream."""
    per_tenant: Dict[str, List[object]] = {}
    lo_k = int(queries_per_tenant * burst_start)
    hi_k = int(queries_per_tenant * burst_end)
    for t, rng in enumerate(_scenario_rngs(seed, num_tenants)):
        tmpls = make_templates(1, col_lo.shape[0], rng)
        stream = _stream_from_plan([(tmpls[0], queries_per_tenant)], tmpls,
                                   col_lo, col_hi, rng)
        batches = {k: [_sample_batch(rng, col_lo, col_hi, batch_rows)]
                   for k in range(lo_k, hi_k, every)}
        per_tenant[f"t{t}"] = _weave(stream.queries, batches)
    return IngestStream("ingest_burst", interleave_event_streams(per_tenant),
                        per_tenant)


@ingest_scenario("bulk_load")
def bulk_load(col_lo: np.ndarray, col_hi: np.ndarray, num_tenants: int = 3,
              queries_per_tenant: int = 1500, seed: int = 0,
              load_rows: int = 600,
              load_points: Tuple[float, ...] = (0.2, 0.5, 0.9),
              ) -> IngestStream:
    """A few large loads at fixed points — the last one near the end of
    the stream, where eagerly reclustering can never pay for itself (the
    case that separates debt-aware from always-recluster)."""
    per_tenant: Dict[str, List[object]] = {}
    for t, rng in enumerate(_scenario_rngs(seed, num_tenants)):
        tmpls = make_templates(1, col_lo.shape[0], rng)
        stream = _stream_from_plan([(tmpls[0], queries_per_tenant)], tmpls,
                                   col_lo, col_hi, rng)
        batches: Dict[int, List[IngestBatch]] = {}
        for frac in load_points:
            k = min(int(queries_per_tenant * frac), queries_per_tenant - 1)
            batches.setdefault(k, []).append(
                _sample_batch(rng, col_lo, col_hi, load_rows))
        per_tenant[f"t{t}"] = _weave(stream.queries, batches)
    return IngestStream("bulk_load", interleave_event_streams(per_tenant),
                        per_tenant)


def queried_column_histogram(queries: Sequence[Query],
                             num_columns: int) -> np.ndarray:
    """How often each column appears with a finite predicate -- used by the
    workload-aware Z-order generator (top-k most-queried columns)."""
    hist = np.zeros(num_columns, dtype=np.int64)
    for q in queries:
        finite = np.isfinite(q.lo) | np.isfinite(q.hi)
        hist += finite.astype(np.int64)
    return hist
