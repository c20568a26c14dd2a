"""Admission control primitives for the serving front end.

Two deterministic building blocks, both clocked by *event counters*
rather than wall time so overload behaviour is replayable in tests:

* :class:`TokenBucket` — per-tenant rate limiting at ingress.  A tenant
  earns ``rate`` tokens per submit attempt (fleet-wide), holds at most
  ``capacity``, and each admitted event spends one.
* :class:`CircuitBreaker` — queue-depth hysteresis that decides *when*
  the frontend sheds reorganization work.  It trips open when the
  ingress queue crosses ``open_above`` and re-closes only after the
  queue has drained below ``close_below`` **and** at least
  ``min_open_events`` events have been processed since it opened (the
  overload window), so it cannot flap on a single burst boundary.

Neither class touches the engine; :class:`repro_torch.serve.ServeFrontend`
composes them with the shedding scheduler proxy.
"""
from __future__ import annotations

import dataclasses


class TokenBucket:
    """Deterministic token bucket clocked by an external counter.

    ``now`` is any monotonically non-decreasing integer/float clock —
    the frontend passes its submit-attempt counter, so two runs over the
    same event sequence make identical admission decisions.
    """

    __slots__ = ("rate", "capacity", "tokens", "_last")

    def __init__(self, rate: float, capacity: float,
                 initial: float = None):
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate!r}")
        if capacity <= 0:
            raise ValueError(f"capacity must be > 0, got {capacity!r}")
        self.rate = float(rate)
        self.capacity = float(capacity)
        self.tokens = float(capacity if initial is None else initial)
        self._last = 0.0

    def try_take(self, now: float) -> bool:
        """Spend one token if available at clock ``now``; True on success."""
        elapsed = max(0.0, float(now) - self._last)
        self._last = float(now)
        self.tokens = min(self.capacity, self.tokens + elapsed * self.rate)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


@dataclasses.dataclass
class BreakerStats:
    """Observable breaker history: trips, re-closes, time spent open."""

    opens: int = 0
    closes: int = 0
    open_events: int = 0   # events processed while the breaker was open


class CircuitBreaker:
    """Queue-depth circuit breaker with a minimum-open overload window."""

    def __init__(self, open_above: int, close_below: int,
                 min_open_events: int = 0):
        if close_below > open_above:
            raise ValueError(
                f"close_below ({close_below}) must not exceed "
                f"open_above ({open_above})")
        self.open_above = int(open_above)
        self.close_below = int(close_below)
        self.min_open_events = int(min_open_events)
        self.is_open = False
        self._opened_at = 0
        self.stats = BreakerStats()

    def observe(self, queue_depth: int, processed: int) -> bool:
        """Update breaker state; returns True while open (shedding)."""
        if self.is_open:
            self.stats.open_events += 1
            if (queue_depth <= self.close_below
                    and processed - self._opened_at >= self.min_open_events):
                self.is_open = False
                self.stats.closes += 1
        elif queue_depth > self.open_above:
            self.is_open = True
            self._opened_at = processed
            self.stats.opens += 1
        return self.is_open
