"""Workload forecasters: predict the next horizon's query distribution.

The decision plane below this module is purely *reactive*: D-UMTS only
moves once realized costs have filled a counter, so cyclic and
gradually-drifting workloads pay full query cost until the drift has been
observed.  A forecaster watches the same per-tenant query stream the
policy sees and emits a :class:`Forecast` — a predicted dominant template
for the next horizon plus a representative query sample for it — which
:class:`repro_torch.forecast.policy.ForecastPolicy` turns into α-charged
pre-positioning moves and :class:`repro_torch.forecast.grower.QdTreeGrower`
turns into new candidate layouts.

Every forecaster here is pure, deterministic and picklable (plain
attributes, no closures, no rng): engines holding one survive
cross-process tenant migration, and a fleet trace with forecasting
enabled is reproducible bit-for-bit.  Everything here is host logic
over :class:`repro_torch.core.workload.Query`, whose bounds are numpy
arrays: the key codes, periods, dwell and mixture samples come from the
same numpy calls as the reference package's, so they are equal to its
object for object.

Two predictors:

* :class:`EwmaMixtureForecaster` — the real one.  Tracks the template-key
  sequence (ground-truth ``template_id`` when the workload carries one,
  else the set of predicate columns), detects *periodic* recurrence by
  autocorrelation over the key codes (cyclic/diurnal workloads), and
  falls back to a half-window EWMA-style *trend* test (share of the
  rising key projected ``lead`` steps ahead) for monotone drift.
* :class:`AdversarialForecaster` — the always-wrong probe for the
  worst-case golden tests: it predicts the *mirror image* of the observed
  predicate ranges (so its predictions look confidently actionable) under
  a sentinel key that never matches a realized query.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import workload as wl


def template_key(query: wl.Query) -> Tuple:
    """Hashable regime key for a query.

    Workload generators stamp ``template_id``; ad-hoc queries fall back
    to the set of columns carrying a finite predicate, which is exactly
    what distinguishes the registry's template families from one another.
    """
    if query.template_id >= 0:
        return ("tpl", int(query.template_id))
    finite = np.flatnonzero(np.isfinite(query.lo) | np.isfinite(query.hi))
    return ("cols",) + tuple(int(c) for c in finite)


@dataclasses.dataclass
class Forecast:
    """One prediction for the next horizon of a tenant's stream.

    ``key`` is the predicted dominant template key ``lead`` steps ahead;
    ``queries`` is a representative sample of what those queries should
    look like (consumed by the grower and by predicted-cost scoring);
    ``dwell`` is the expected persistence (in queries) of the predicted
    regime once it arrives — the lever that decides whether an α-priced
    pre-position can ever pay for itself.
    """

    key: Tuple
    queries: List[wl.Query]
    source: str                 # "period" | "trend" | "adversarial"
    confidence: float           # in [0, 1]
    dwell: float                # expected regime persistence, in queries
    lead: int                   # steps ahead the prediction targets


class PeriodDetector:
    """Smallest period whose key-code autocorrelation clears a threshold.

    Operates on integer key codes; a period ``p`` matches when
    ``codes[i] == codes[i - p]`` for at least ``threshold`` of the
    overlapping positions.  Degenerate histories (fewer than two distinct
    keys) match *every* lag, so they are rejected outright — a constant
    workload needs no forecasting.
    """

    def __init__(self, period_min: int = 4, period_max: int = 384,
                 threshold: float = 0.85, min_history: int = 32):
        self.period_min = int(period_min)
        self.period_max = int(period_max)
        self.threshold = float(threshold)
        self.min_history = int(min_history)

    def detect(self, codes: np.ndarray) -> Optional[Tuple[int, float]]:
        """(period, match_fraction) of the smallest qualifying period."""
        n = codes.shape[0]
        if n < self.min_history or np.unique(codes).size < 2:
            return None
        hi = min(self.period_max, n // 2)
        for p in range(self.period_min, hi + 1):
            frac = float(np.mean(codes[p:] == codes[:-p]))
            if frac >= self.threshold:
                return p, frac
        return None


def _run_length(codes: np.ndarray) -> float:
    """Average length of maximal runs of identical consecutive codes."""
    if codes.size == 0:
        return 1.0
    changes = int(np.count_nonzero(codes[1:] != codes[:-1]))
    return codes.size / (changes + 1)


class EwmaMixtureForecaster:
    """Template-mixture forecaster: period detection + EWMA-trend fallback.

    Keeps a bounded history of template keys and, per key, a bounded
    sample of recent concrete queries.  :meth:`forecast` first looks for
    periodic recurrence (cyclic/diurnal workloads: the predicted key is
    read straight off the detected cycle ``lead`` steps ahead); failing
    that, it projects the half-window share trend of the fastest-rising
    key (gradual drift: fire once the projected share crosses a majority
    of the mix).  Returns None when neither signal clears its bar —
    single-template and erratic workloads produce no forecasts, so a
    wrapping policy falls through to pure reactive behavior.
    """

    name = "ewma-mixture"

    def __init__(self, history: int = 768, samples_per_key: int = 32,
                 period_min: int = 4, period_max: int = 384,
                 period_threshold: float = 0.85,
                 trend_window: int = 256, trend_share: float = 0.55,
                 trend_min_delta: float = 0.04, trend_dwell: float = 256.0,
                 ewma_lambda: float = 0.02):
        self.history = int(history)
        self.samples_per_key = int(samples_per_key)
        self.detector = PeriodDetector(period_min, period_max,
                                       period_threshold)
        self.trend_window = int(trend_window)
        self.trend_share = float(trend_share)
        self.trend_min_delta = float(trend_min_delta)
        self.trend_dwell = float(trend_dwell)
        self.ewma_lambda = float(ewma_lambda)
        self._code_of: Dict[Tuple, int] = {}
        self._codes: Deque[int] = collections.deque(maxlen=self.history)
        self._samples: Dict[int, Deque[wl.Query]] = {}
        self._shares: Dict[int, float] = {}     # EWMA mixture weights
        self.observed = 0

    # ------------------------------------------------------------------
    def observe(self, query: wl.Query) -> None:
        key = template_key(query)
        code = self._code_of.get(key)
        if code is None:
            code = len(self._code_of)
            self._code_of[key] = code
            self._samples[code] = collections.deque(
                maxlen=self.samples_per_key)
        self._codes.append(code)
        self._samples[code].append(query)
        lam = self.ewma_lambda
        for c in self._shares:
            self._shares[c] *= (1.0 - lam)
        self._shares[code] = self._shares.get(code, 0.0) + lam
        self.observed += 1

    # ------------------------------------------------------------------
    def _key_of_code(self, code: int) -> Tuple:
        for k, c in self._code_of.items():
            if c == code:
                return k
        raise KeyError(code)

    def forecast(self, lead: int = 20) -> Optional[Forecast]:
        codes = np.fromiter(self._codes, dtype=np.int64,
                            count=len(self._codes))
        n = codes.shape[0]
        if n < self.detector.min_history or np.unique(codes).size < 2:
            return None

        hit = self.detector.detect(codes)
        if hit is not None:
            p, frac = hit
            dwell = _run_length(codes)
            # A lead beyond half a regime block predicts *past* the next
            # boundary: the pre-positioned state then serves the tail of
            # the old regime long enough for its counter to fill and
            # force a reactive jump straight back (ping-pong).  Clamp to
            # the observed block scale.
            lead = max(1, min(lead, int(dwell // 2)))
            j = n - 1 + lead
            while j >= n:
                j -= p
            code = int(codes[j])
            qs = list(self._samples.get(code, ()))
            if qs:
                return Forecast(key=self._key_of_code(code), queries=qs,
                                source="period", confidence=frac,
                                dwell=dwell, lead=lead)

        w = min(n, self.trend_window)
        recent = codes[-w:]
        half = w // 2
        if half < 8:
            return None
        first, second = recent[:half], recent[half:]
        counts = np.bincount(second)
        code = int(np.argmax(counts))
        s2 = float(counts[code]) / second.shape[0]
        s1 = float(np.mean(first == code))
        delta = s2 - s1
        projected = min(s2 + delta * (lead / half), 1.0)
        if delta >= self.trend_min_delta and projected >= self.trend_share:
            qs = self._mixture_sample(code, projected, second)
            if qs:
                return Forecast(key=self._key_of_code(code), queries=qs,
                                source="trend", confidence=projected,
                                dwell=self.trend_dwell, lead=lead)
        return None

    def _mixture_sample(self, code: int, share: float,
                        recent: np.ndarray) -> List[wl.Query]:
        """Blend the horizon's predicted query mix, not just the riser.

        Mid-drift the realized stream is still a mixture — a forecast of
        pure target queries makes every downstream consumer (predicted
        costs, grown trees) optimize for a regime that hasn't arrived,
        which mis-prices pre-positions while the old template still
        carries real mass.  ``share`` of the sample comes from the rising
        key; the rest is filled from the other keys in proportion to
        their weight in the recent window.
        """
        total = self.samples_per_key
        take = {code: int(round(share * total))}
        rest = total - take[code]
        if rest > 0:
            other = recent[recent != code]
            if other.size:
                ocounts = np.bincount(other)
                for c in np.flatnonzero(ocounts):
                    take[int(c)] = int(round(
                        rest * float(ocounts[c]) / other.size))
        qs: List[wl.Query] = []
        for c, k in take.items():
            pool = self._samples.get(c, ())
            qs.extend(list(pool)[-k:] if k > 0 else [])
        return qs

    def info(self) -> dict:
        return {"forecaster": self.name, "observed": self.observed,
                "distinct_keys": len(self._code_of)}


class AdversarialForecaster:
    """Always-wrong forecaster for the worst-case golden tests.

    Predicts the *mirror image* of the recent predicate ranges within the
    observed per-column domain (``lo' = dom_lo + dom_hi - hi``), under a
    sentinel key no realized query ever carries — so its predictions are
    maximally actionable-looking (the predicted-best layout genuinely
    differs from the current one) yet never come true.  The α-safety
    clamp in :class:`repro_torch.forecast.policy.ForecastPolicy` is what
    keeps the damage bounded; the golden tests drive this probe to prove it.
    """

    name = "adversarial"

    def __init__(self, samples: int = 32, dwell: float = 1e6):
        self.samples = int(samples)
        self.dwell = float(dwell)
        self._recent: Deque[wl.Query] = collections.deque(maxlen=samples)
        self._dom_lo: Optional[np.ndarray] = None
        self._dom_hi: Optional[np.ndarray] = None
        self.observed = 0

    def observe(self, query: wl.Query) -> None:
        self._recent.append(query)
        finite_lo = np.where(np.isfinite(query.lo), query.lo, np.inf)
        finite_hi = np.where(np.isfinite(query.hi), query.hi, -np.inf)
        if self._dom_lo is None:
            self._dom_lo, self._dom_hi = finite_lo, finite_hi
        else:
            self._dom_lo = np.minimum(self._dom_lo, finite_lo)
            self._dom_hi = np.maximum(self._dom_hi, finite_hi)
        self.observed += 1

    def _mirror(self, query: wl.Query) -> wl.Query:
        lo, hi = query.lo, query.hi
        finite = np.isfinite(lo) & np.isfinite(hi)
        # unbounded columns have inf/-inf domain sentinels whose sum is
        # nan; they are masked out anyway, so fold them to 0 first
        span = np.where(finite, self._dom_lo, 0.0) \
            + np.where(finite, self._dom_hi, 0.0)
        m_lo = np.where(finite, span - hi, lo)
        m_hi = np.where(finite, span - lo, hi)
        return wl.Query(lo=m_lo, hi=m_hi, template_id=-1)

    def forecast(self, lead: int = 20) -> Optional[Forecast]:
        if not self._recent:
            return None
        qs = [self._mirror(q) for q in self._recent]
        return Forecast(key=("adversarial-sentinel",), queries=qs,
                        source="adversarial", confidence=1.0,
                        dwell=self.dwell, lead=lead)

    def info(self) -> dict:
        return {"forecaster": self.name, "observed": self.observed}
