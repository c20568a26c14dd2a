"""Shared reorganization-work schedulers for multi-tenant fleets.

A warehouse serving many tables cannot rewrite all of them at once: physical
reorganization competes for a shared maintenance budget (cf. Snowflake's
incremental reclustering).  A :class:`ReorgScheduler` is the fleet-wide
arbiter of that budget: each charged reorganization must *acquire* one unit
of physical work before its background materialization may start, and
*releases* it when the swap takes effect.

Deferral never changes what a tenant is charged — the decision layer runs
unmodified and reorganization cost is incurred at decision time exactly as
in the single-tenant loop — it only delays when the physical swap lands,
and never before the tenant's own Δ-delay has elapsed.

Schedulers are deliberately tiny state machines driven by the fleet clock
(one tick per interleaved query event):

* :class:`UnlimitedScheduler` — every acquire granted immediately; a fleet
  under it is bit-identical, per tenant, to running each engine alone.
* :class:`KConcurrentScheduler` — at most ``k`` reorganizations in flight
  (acquired and not yet swapped) across all tenants.
* :class:`TokenBucketScheduler` — a refillable budget: each reorganization
  costs one token, ``rate`` tokens drip in per tick up to ``capacity``.

Schedulers are *stateful* and therefore per-fleet: two shards sharing one
instance would share its token bucket and in-flight counts, silently
coupling budgets that must be independent.  :class:`SchedulerSpec` is the
declarative form — ``spec.build()`` mints a fresh scheduler per shard;
passing a bare instance where a spec is expected still works through
:func:`as_scheduler_spec`'s single-use deprecation shim.

Host logic, carried over line for line from the reference package: token
arithmetic stays float64, so grants land on the same ticks.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional, Protocol, runtime_checkable


@runtime_checkable
class ReorgScheduler(Protocol):
    """Fleet-wide admission control for physical reorganization work.

    * :meth:`tick` advances the scheduler's clock; called once per fleet
      event before any acquire attempt at that tick.
    * :meth:`try_acquire` asks to start one unit of physical work for a
      tenant; True grants it.  The fleet guarantees per-tenant FIFO: it
      never requests a grant for a tenant's later swap while an earlier
      one is still waiting.
    * :meth:`release` returns a granted unit once the swap has taken
      effect (or the target state was evicted and the swap skipped).
      Under an *incremental* fleet (:mod:`repro_torch.engine.reorg`) the
      unit is instead held for the whole migration — from the step its
      moves begin until the step the target layout takes over — so
      e.g. :class:`KConcurrentScheduler` bounds concurrent migrations.
    * :meth:`grant_rows` turns the grant into a *row budget*: an engine
      holding a granted unit asks, each tick, how many rows its in-flight
      migration may move now.  The default (and the behavior of every
      scheduler without a tighter rule) is to grant the full request, so
      atomic semantics — swap permission only — are the degenerate case.
    """

    name: str

    def tick(self, now: int) -> None: ...

    def try_acquire(self, tenant_id: str) -> bool: ...

    def release(self, tenant_id: str) -> None: ...

    def grant_rows(self, tenant_id: str, want: int) -> int: ...


class _StatsMixin:
    """Grant/denial counters shared by the concrete schedulers.

    ``grants`` counts distinct granted work units.  ``denied_attempts``
    counts *acquire attempts* that were refused — the fleet re-polls every
    waiting swap each tick, so this scales with time spent waiting, not
    with distinct swaps; for per-swap deferral counts see
    :attr:`repro_torch.engine.FleetResult.swaps_deferred`.
    """

    grants: int
    denied_attempts: int

    def _init_stats(self) -> None:
        self.grants = 0
        self.denied_attempts = 0

    def _count(self, granted: bool) -> bool:
        if granted:
            self.grants += 1
        else:
            self.denied_attempts += 1
        return granted

    def stats(self) -> dict:
        return {"scheduler": self.name, "grants": self.grants,
                "denied_attempts": self.denied_attempts}


class UnlimitedScheduler(_StatsMixin):
    """No contention: physical work starts the moment it is charged.

    The golden scheduler — a fleet under it reproduces each tenant's
    standalone trace bit for bit.
    """

    name = "unlimited"

    def __init__(self) -> None:
        self._init_stats()

    def tick(self, now: int) -> None:
        pass

    def try_acquire(self, tenant_id: str) -> bool:
        return self._count(True)

    def release(self, tenant_id: str) -> None:
        pass

    def grant_rows(self, tenant_id: str, want: int) -> int:
        return want


class KConcurrentScheduler(_StatsMixin):
    """At most ``k`` reorganizations in flight fleet-wide.

    A reorganization is in flight from the tick its work is granted until
    the tick its swap takes effect; with ``k=1`` the fleet serializes all
    physical reorganization onto one maintenance worker.
    """

    def __init__(self, k: int = 1):
        if k < 1:
            raise ValueError("k must be >= 1")
        self.k = k
        self.name = f"k{k}"
        self.in_flight = 0
        self._init_stats()

    def tick(self, now: int) -> None:
        pass

    def try_acquire(self, tenant_id: str) -> bool:
        if self.in_flight < self.k:
            self.in_flight += 1
            return self._count(True)
        return self._count(False)

    def release(self, tenant_id: str) -> None:
        if self.in_flight > 0:
            self.in_flight -= 1

    def grant_rows(self, tenant_id: str, want: int) -> int:
        # Concurrency is this scheduler's budget axis: a migration holding
        # one of the k units moves as fast as its engine allows.
        return want


class TokenBucketScheduler(_StatsMixin):
    """Token-bucket reorganization budget.

    ``rate`` tokens accrue per fleet tick up to ``capacity``; each granted
    reorganization consumes one whole token.  ``rate=0`` with an initial
    burst models a fixed budget; fractional rates model "one reorg every
    1/rate queries fleet-wide".

    With ``rows_per_token`` set, the bucket is denominated in *rows* for
    incremental fleets (:mod:`repro_torch.engine.reorg`): admission is free
    (:meth:`try_acquire` always grants, so migrations *start* on their
    Δ-due step) and :meth:`grant_rows` meters how many rows may move per
    tick — one token buys ``rows_per_token`` rows, so the bucket models a
    shared maintenance bandwidth of ``rate * rows_per_token`` rows/tick
    instead of "one wholesale swap every 1/rate ticks".
    """

    def __init__(self, rate: float, capacity: float,
                 initial: float | None = None,
                 rows_per_token: float | None = None):
        if rate < 0 or capacity < 0:
            raise ValueError("rate and capacity must be >= 0")
        if rows_per_token is not None and rows_per_token <= 0:
            raise ValueError("rows_per_token must be positive (None = "
                             "swap-permission mode)")
        self.rate = float(rate)
        self.capacity = float(capacity)
        self.tokens = float(capacity if initial is None else initial)
        self.rows_per_token = rows_per_token
        self.name = (f"bucket{rate:g}x{capacity:g}" if rows_per_token is None
                     else f"bucket{rate:g}x{capacity:g}rows{rows_per_token:g}")
        self._now = 0
        self._init_stats()

    def tick(self, now: int) -> None:
        elapsed = max(now - self._now, 0)
        self._now = now
        self.tokens = min(self.capacity, self.tokens + self.rate * elapsed)

    def try_acquire(self, tenant_id: str) -> bool:
        if self.rows_per_token is not None:
            # Row-denominated bucket: pacing happens in grant_rows.
            return self._count(True)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return self._count(True)
        return self._count(False)

    def release(self, tenant_id: str) -> None:
        pass

    def grant_rows(self, tenant_id: str, want: int) -> int:
        if self.rows_per_token is None:
            return want
        granted = min(int(want), int(self.tokens * self.rows_per_token))
        if granted > 0:
            self.tokens -= granted / self.rows_per_token
        return granted


# ---------------------------------------------------------------------------
# Declarative scheduler configuration (one fresh instance per shard)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SchedulerSpec:
    """A scheduler *recipe*: :meth:`build` mints a fresh instance.

    Shards of a sharded fleet each need their own :class:`ReorgScheduler`
    (the instances are stateful), so a spec's ``build()`` is called per
    shard.  :class:`repro_torch.engine.fleet.FleetEngine` accepts a spec anywhere it
    accepts an instance.  Use the classmethod constructors::

        SchedulerSpec.unlimited()
        SchedulerSpec.k_concurrent(2)
        SchedulerSpec.token_bucket(rate=0.1, capacity=4.0)
    """

    kind: str
    params: tuple = ()          # sorted (name, value) pairs, hash-stable

    @classmethod
    def unlimited(cls) -> "SchedulerSpec":
        return cls("unlimited")

    @classmethod
    def k_concurrent(cls, k: int = 1) -> "SchedulerSpec":
        return cls("k_concurrent", (("k", int(k)),))

    @classmethod
    def token_bucket(cls, rate: float, capacity: float,
                     initial: Optional[float] = None,
                     rows_per_token: Optional[float] = None
                     ) -> "SchedulerSpec":
        return cls("token_bucket", (("capacity", float(capacity)),
                                    ("initial", initial),
                                    ("rate", float(rate)),
                                    ("rows_per_token", rows_per_token)))

    def build(self) -> ReorgScheduler:
        kwargs: Dict[str, Any] = dict(self.params)
        factory = _SPEC_KINDS.get(self.kind)
        if factory is None:
            raise ValueError(f"unknown scheduler kind {self.kind!r} "
                             f"(one of {sorted(_SPEC_KINDS)})")
        return factory(**kwargs)

    @property
    def name(self) -> str:
        """The name the built scheduler will carry (for labels/results)."""
        return self.build().name


_SPEC_KINDS = {
    "unlimited": UnlimitedScheduler,
    "k_concurrent": KConcurrentScheduler,
    "token_bucket": TokenBucketScheduler,
}


class _SingleUseSpec(SchedulerSpec):
    """Deprecation shim: a live instance masquerading as a spec.

    Hands out the wrapped instance exactly once — a second ``build()``
    means two shards would share mutable scheduler state, which is the
    bug :class:`SchedulerSpec` exists to prevent, so it raises instead.
    """

    def __init__(self, instance: ReorgScheduler):
        object.__setattr__(self, "kind", f"instance:{instance.name}")
        object.__setattr__(self, "params", ())
        object.__setattr__(self, "_instance", instance)

    def build(self) -> ReorgScheduler:
        instance = object.__getattribute__(self, "_instance")
        if instance is None:
            raise ValueError(
                "this ReorgScheduler instance was already handed to a "
                "shard; schedulers are stateful and cannot be shared — "
                "pass a SchedulerSpec so each shard builds its own")
        object.__setattr__(self, "_instance", None)
        return instance

    @property
    def name(self) -> str:
        instance = object.__getattribute__(self, "_instance")
        return self.kind if instance is None else instance.name


def as_scheduler_spec(scheduler, warn: bool = True) -> SchedulerSpec:
    """Coerce a spec-or-instance argument into a :class:`SchedulerSpec`.

    Specs pass through; a bare :class:`ReorgScheduler` instance is
    wrapped in a single-use spec (with a :class:`DeprecationWarning`
    when ``warn`` — the multi-shard call sites where sharing would be a
    real bug warn, :class:`~repro_torch.engine.fleet.FleetEngine` itself keeps
    accepting instances silently since one fleet owning one instance is
    still well-defined).
    """
    if isinstance(scheduler, SchedulerSpec):
        return scheduler
    if isinstance(scheduler, ReorgScheduler):
        if warn:
            warnings.warn(
                "passing a ReorgScheduler instance where a SchedulerSpec "
                "is expected is deprecated: instances are stateful and "
                "single-use across shards — pass e.g. "
                "SchedulerSpec.k_concurrent(2) instead",
                DeprecationWarning, stacklevel=3)
        return _SingleUseSpec(scheduler)
    raise TypeError(f"expected a SchedulerSpec or ReorgScheduler, got "
                    f"{type(scheduler).__name__}")
