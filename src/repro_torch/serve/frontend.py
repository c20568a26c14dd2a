"""The serving front end: admission, load leveling, shedding, caching.

:class:`ServeFrontend` is the traffic-facing tier in front of any
:class:`repro_torch.engine.EventSink` — a single
:class:`repro_torch.engine.FleetEngine` or a sharded
:class:`repro_torch.engine.FleetRouter` (at one shard the two are
trace-bitwise interchangeable under the frontend):

* **Bounded ingress queue** (queue-based load leveling): submitted
  events wait in a bounded deque and are dispatched in order by
  :meth:`ServeFrontend.pump`; the ``overflow_policy`` decides whether a
  full queue back-pressures the caller ("block": pump to make room) or
  refuses at ingress ("reject").  An *admitted* event is never dropped.
* **Per-tenant token-bucket admission**: each tenant earns tokens per
  submit attempt and spends one per admitted event, so a flash-crowd
  tenant throttles at ingress instead of starving the fleet.
* **Circuit breaker that sheds reorg work, never serve work**: under
  overload (queue depth past the open threshold) a scheduler proxy
  refuses *new* reorganization grants and row budgets, so migrations
  and compactions defer through the fleet's existing waiting/pump
  machinery while every query keeps being served.  α-charges are
  recorded at decision time *before* the scheduler is consulted
  (paper §VI-D5), so shedding cannot change a tenant's charge ledger
  by a single bit.
* **Versioned read-through serve-cost cache**: hits prime the backend's
  identity-keyed serve memo under a plane-version key
  (:mod:`repro_torch.serve.cache`), so hybrid-layout and delta-bearing
  tenants stay bit-exact.

All control decisions are clocked by event counters, not wall time, so
overload behaviour is deterministic and replayable; wall time is only
*measured* (per-event latency stamps for the benchmark's p50/p99).  The
tier is host code, line for line the reference package's; the fleets
behind it run their scans on the device.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, Iterable, List, Optional, Tuple

from repro_torch.core import workload as wl
from repro_torch.engine import EventSink
from repro_torch.engine.compute import BACKENDS
from repro_torch.engine.fleet import FleetResult

from .admission import CircuitBreaker, TokenBucket
from .cache import VersionedResultCache, cache_key


class _ShedState:
    """Overload state shared by every shard's shedding proxy.

    One frontend, one breaker, one shed decision — a router's shards
    each get their own :class:`_SheddingScheduler` (schedulers are
    per-shard) but all of them consult and count into this one object,
    so opening the breaker sheds reorg work fleet-wide and the counters
    aggregate naturally.
    """

    __slots__ = ("shedding", "shed_count", "shed_attempts", "shed_tids")

    def __init__(self) -> None:
        self.shedding = False
        #: Distinct (tenant, overload window) reorg grants refused.
        self.shed_count = 0
        #: Raw refused acquire attempts (the fleet re-polls waiting work
        #: every event, so this scales with time spent shedding).
        self.shed_attempts = 0
        self.shed_tids: set = set()


class _SheddingScheduler:
    """Proxy over one shard's scheduler; refuses grants while shedding.

    With ``shedding`` False the proxy is a pure delegate (same grant
    decisions, same stats, same name), so wrapping a fleet's scheduler
    changes nothing observable.  While shedding, ``try_acquire`` is
    refused (new reorg/compaction work queues in the fleet's waiting
    deque) and ``grant_rows`` returns 0 (in-flight incremental
    migrations pause); ``release`` always passes through so completing
    work frees its unit.
    """

    def __init__(self, inner, state: Optional[_ShedState] = None):
        self.inner = inner
        self.state = state if state is not None else _ShedState()

    @property
    def shedding(self) -> bool:
        return self.state.shedding

    @shedding.setter
    def shedding(self, value: bool) -> None:
        self.state.shedding = value

    @property
    def shed_count(self) -> int:
        return self.state.shed_count

    @property
    def shed_attempts(self) -> int:
        return self.state.shed_attempts

    @property
    def _shed_tids(self) -> set:
        return self.state.shed_tids

    @property
    def name(self) -> str:
        return self.inner.name

    def tick(self, now: int) -> None:
        self.inner.tick(now)

    def try_acquire(self, tenant_id: str) -> bool:
        state = self.state
        if state.shedding:
            state.shed_attempts += 1
            if tenant_id not in state.shed_tids:
                state.shed_tids.add(tenant_id)
                state.shed_count += 1
            return False
        return self.inner.try_acquire(tenant_id)

    def release(self, tenant_id: str) -> None:
        self.inner.release(tenant_id)

    def grant_rows(self, tenant_id: str, want: int) -> int:
        if self.state.shedding:
            self.state.shed_attempts += 1
            return 0
        grant = getattr(self.inner, "grant_rows", None)
        if grant is None:
            return want
        return grant(tenant_id, want)

    def stats(self) -> dict:
        stats = getattr(self.inner, "stats", None)
        return stats() if callable(stats) else {}


@dataclasses.dataclass(frozen=True)
class AdmissionResult:
    """Outcome of one :meth:`ServeFrontend.submit` attempt."""

    admitted: bool
    reason: str = "ok"        # "ok" | "throttled" | "queue_full"


@dataclasses.dataclass
class FrontendConfig:
    """Tuning knobs for :class:`ServeFrontend`.

    The defaults are permissive: unlimited admission, a deep queue, a
    breaker that only trips under a real backlog.  A frontend with
    defaults produces traces bit-identical to driving the fleet
    directly.
    """

    #: Ingress queue bound (queue-based load leveling).
    queue_capacity: int = 1024
    #: "block": a full queue pumps synchronously to make room (back
    #: pressure); "reject": refuse at ingress with reason "queue_full".
    overflow_policy: str = "block"
    #: Per-tenant admitted events per submit attempt; None = unlimited.
    admission_rate: Optional[float] = None
    #: Token-bucket burst size per tenant.
    admission_capacity: float = 8.0
    #: Starting tokens (None = full bucket).
    admission_initial: Optional[float] = None
    #: Trip the breaker (start shedding reorg work) when the queue is
    #: deeper than this fraction of capacity; disable with None.
    breaker_open_frac: Optional[float] = 0.75
    #: Re-close when the queue drains below this fraction ...
    breaker_close_frac: float = 0.25
    #: ... and at least this many events were processed while open.
    breaker_min_open_events: int = 32
    #: Versioned serve-cost cache entries; 0 disables the cache.
    cache_entries: int = 4096
    #: Events dispatched per :meth:`ServeFrontend.pump` call.
    pump_chunk: int = 32
    #: Stamp wall-clock latency per event (admission → completion).
    record_latency: bool = True
    #: Route pumps through the fused FleetMatrix pass (run_batched
    #: semantics; the versioned cache is bypassed — the fused pass does
    #: its own serve-score priming).
    batched: bool = False
    #: The batched pumps' fleet lane (one of
    #: :data:`repro_torch.engine.compute.BACKENDS`).
    compute: str = "decision_fused"
    frames_per_pass: Optional[int] = None

    def __post_init__(self) -> None:
        if self.queue_capacity < 1:
            raise ValueError("queue_capacity must be >= 1")
        if self.overflow_policy not in ("block", "reject"):
            raise ValueError(f"unknown overflow_policy "
                             f"{self.overflow_policy!r}")
        if self.admission_rate is not None and self.admission_rate <= 0:
            raise ValueError("admission_rate must be > 0 (None disables "
                             "admission control)")
        if self.pump_chunk < 1:
            raise ValueError("pump_chunk must be >= 1")
        if self.cache_entries < 0:
            raise ValueError("cache_entries must be >= 0")
        if self.compute not in BACKENDS:
            raise ValueError(f"unknown compute lane {self.compute!r} "
                             f"(expected one of {BACKENDS})")
        if self.breaker_open_frac is not None:
            if not 0.0 < self.breaker_open_frac <= 1.0:
                raise ValueError("breaker_open_frac must be in (0, 1]")
            if not 0.0 <= self.breaker_close_frac <= self.breaker_open_frac:
                raise ValueError("breaker_close_frac must be in "
                                 "[0, breaker_open_frac]")


class ServeFrontend:
    """Admission-controlled, load-leveled serving tier over a fleet.

    Typical use::

        frontend = ServeFrontend(fleet, FrontendConfig(...))
        for event in stream:
            frontend.submit_blocking(event)   # or submit() + own retry
        frontend.flush()
        result = frontend.result()

    The frontend owns the fleet's scheduler wrapping (shedding proxy)
    from construction on; everything else about the fleet is untouched,
    and :meth:`result` returns the ordinary :class:`FleetResult`.
    """

    def __init__(self, fleet: EventSink,
                 config: Optional[FrontendConfig] = None):
        self.fleet = fleet
        self.config = config or FrontendConfig()
        cfg = self.config
        # One shedding proxy per shard fleet (a plain FleetEngine is its
        # own single shard), all sharing one _ShedState so the breaker's
        # decision and the shed counters are frontend-wide.  A shard
        # already wrapped (stacked frontends) contributes its existing
        # state instead of being double-wrapped.
        shards = fleet.shard_fleets()
        state = next((s.scheduler.state for s in shards
                      if isinstance(s.scheduler, _SheddingScheduler)), None)
        self._shed_state = state if state is not None else _ShedState()
        self._shedders: List[_SheddingScheduler] = []
        for shard in shards:
            if isinstance(shard.scheduler, _SheddingScheduler):
                self._shedders.append(shard.scheduler)
            else:
                proxy = _SheddingScheduler(shard.scheduler,
                                           self._shed_state)
                shard.scheduler = proxy
                self._shedders.append(proxy)
        self._shedder = self._shedders[0]
        if cfg.breaker_open_frac is None:
            self._breaker: Optional[CircuitBreaker] = None
        else:
            cap = cfg.queue_capacity
            self._breaker = CircuitBreaker(
                open_above=max(1, int(cfg.breaker_open_frac * cap)),
                close_below=int(cfg.breaker_close_frac * cap),
                min_open_events=cfg.breaker_min_open_events)
        self._cache = (VersionedResultCache(cfg.cache_entries)
                       if cfg.cache_entries > 0 and not cfg.batched
                       else None)
        self._queue: Deque[Tuple[wl.Event, Optional[float]]] = \
            collections.deque()
        self._buckets: Dict[str, TokenBucket] = {}
        # (backend, state_matrix) per cache-eligible tenant; None marks a
        # tenant whose backend the versioned cache must not touch.
        self._cacheable: Dict[str, Optional[tuple]] = {}
        self._attempts = 0      # admission clock (all submit attempts)
        self.admitted = 0
        self.throttled = 0
        self.rejected = 0
        self.processed = 0
        #: Wall-clock seconds, admission → completion, per processed
        #: event (only when ``record_latency``); percentile fodder.
        self.latencies: List[float] = []

    # ------------------------------------------------------------------
    # Ingress
    # ------------------------------------------------------------------
    def submit(self, event) -> AdmissionResult:
        """Offer one event; admission-check, then enqueue (never runs it).

        Returns whether the event was admitted.  A throttled or rejected
        event was *not* enqueued — the caller owns the retry (or use
        :meth:`submit_blocking`).
        """
        ev = wl.as_event(event)
        self._attempts += 1
        cfg = self.config
        if cfg.admission_rate is not None:
            bucket = self._buckets.get(ev.tenant_id)
            if bucket is None:
                bucket = TokenBucket(cfg.admission_rate,
                                     cfg.admission_capacity,
                                     cfg.admission_initial)
                self._buckets[ev.tenant_id] = bucket
            if not bucket.try_take(self._attempts):
                self.throttled += 1
                return AdmissionResult(False, "throttled")
        if len(self._queue) >= cfg.queue_capacity:
            if cfg.overflow_policy == "reject":
                self.rejected += 1
                return AdmissionResult(False, "queue_full")
            while len(self._queue) >= cfg.queue_capacity:
                self.pump()
        t0 = time.perf_counter() if cfg.record_latency else None
        self._queue.append((ev, t0))
        self.admitted += 1
        self._update_breaker()
        return AdmissionResult(True, "ok")

    def submit_blocking(self, event) -> AdmissionResult:
        """Submit, retrying until admitted.

        A throttled attempt advances the admission clock (buckets refill
        per attempt, and the config requires ``admission_rate > 0``), so
        the retry loop always terminates; a full queue is pumped.
        """
        while True:
            res = self.submit(event)
            if res.admitted:
                return res
            if res.reason == "queue_full":
                self.pump()

    # ------------------------------------------------------------------
    # Dispatch
    # ------------------------------------------------------------------
    def pump(self, max_events: Optional[int] = None) -> int:
        """Dispatch up to ``max_events`` queued events; returns the count."""
        limit = max_events if max_events is not None else \
            self.config.pump_chunk
        if self.config.batched:
            return self._pump_batched(limit)
        n = 0
        while self._queue and n < limit:
            ev, t0 = self._queue.popleft()
            self._dispatch_one(ev, t0)
            self.processed += 1
            n += 1
            self._update_breaker()
        return n

    def flush(self) -> int:
        """Pump until the ingress queue is empty; returns events run."""
        total = 0
        while self._queue:
            total += self.pump()
        return total

    def run(self, events: Iterable[wl.Event],
            name: Optional[str] = None) -> FleetResult:
        """Submit (blocking) every event, flush, and return the trace."""
        for event in events:
            self.submit_blocking(event)
        self.flush()
        return self.result(name)

    def result(self, name: Optional[str] = None) -> FleetResult:
        return self.fleet.result(name)

    def _dispatch_one(self, ev: wl.Event, t0: Optional[float]) -> None:
        cache = self._cache
        fill = None
        if cache is not None and isinstance(ev, wl.QueryEvent):
            pair = self._cache_pair(ev.tenant_id)
            if pair is not None:
                backend, matrix = pair
                cost = cache.get(cache_key(ev.tenant_id, matrix.version,
                                           ev.query))
                if cost is not None:
                    # Read-through hit: prime the identity-keyed serve
                    # memo.  A swap landing mid-step clears it before it
                    # could be served stale (see repro_torch.serve.cache).
                    backend._serve_memo = (ev.query, cost)
                else:
                    fill = matrix
        self.fleet.submit(ev)
        results = self.fleet.drain(collect=True)
        r = results[0] if results else None
        if fill is not None and r is not None and r.step is not None:
            # Nothing bumps the plane after serve within a step, so the
            # post-step version is the serve-time version — the only
            # version this realized cost may be keyed under.
            cache.put(cache_key(ev.tenant_id, fill.version, ev.query),
                      r.step.query_cost)
        if t0 is not None:
            self.latencies.append(time.perf_counter() - t0)

    def _pump_batched(self, limit: int) -> int:
        cfg = self.config
        n = 0
        t0s: List[Optional[float]] = []
        while self._queue and n < limit:
            ev, t0 = self._queue.popleft()
            self.fleet.submit(ev)
            t0s.append(t0)
            n += 1
        if n:
            self.fleet.drain(batched=True, compute=cfg.compute,
                             frames_per_pass=cfg.frames_per_pass)
            self.processed += n
            if cfg.record_latency:
                done = time.perf_counter()
                self.latencies.extend(done - t0 for t0 in t0s
                                      if t0 is not None)
        self._update_breaker()
        return n

    # ------------------------------------------------------------------
    # Internals
    # ------------------------------------------------------------------
    def _cache_pair(self, tenant_id: str) -> Optional[tuple]:
        pair = self._cacheable.get(tenant_id, ())
        if pair == ():
            backend = self.fleet.tenant(tenant_id).backend
            matrix = getattr(backend, "state_matrix", None)
            primable = bool(getattr(backend, "_serve_primable", False))
            pair = (backend, matrix) if (matrix is not None
                                         and primable) else None
            self._cacheable[tenant_id] = pair
        return pair

    def _update_breaker(self) -> None:
        if self._breaker is None:
            return
        open_now = self._breaker.observe(len(self._queue), self.processed)
        if open_now and not self._shedder.shedding:
            self._shedder.shedding = True
        elif not open_now and self._shedder.shedding:
            self._shedder.shedding = False
            self._shedder._shed_tids.clear()

    # ------------------------------------------------------------------
    # Observability
    # ------------------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def shed_count(self) -> int:
        return self._shedder.shed_count

    def stats(self) -> dict:
        """Counters for dashboards and tests (plain dict, all scalars)."""
        breaker = self._breaker
        return {
            "queue_depth": len(self._queue),
            "queue_capacity": self.config.queue_capacity,
            "admitted": self.admitted,
            "throttled": self.throttled,
            "rejected": self.rejected,
            "processed": self.processed,
            "shed_count": self._shedder.shed_count,
            "shed_attempts": self._shedder.shed_attempts,
            "breaker": None if breaker is None else {
                "is_open": breaker.is_open,
                "opens": breaker.stats.opens,
                "closes": breaker.stats.closes,
                "open_events": breaker.stats.open_events,
            },
            "cache": None if self._cache is None else self._cache.stats(),
            # One shard: the scheduler's own stats dict, exactly as when
            # fronting a plain fleet; sharded: nested per shard.
            "scheduler": (self._shedder.stats()
                          if len(self._shedders) == 1 else
                          {"shards": [s.stats() for s in self._shedders]}),
        }
