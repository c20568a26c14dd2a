"""Query-stream sampling: sliding window, reservoir, and R-TBS.

The LAYOUT MANAGER generates candidates from a *sliding window* (paper default)
and measures layout similarity on an *R-TBS* (reservoir-based time-biased
sample, Hentschel et al., TODS'19) of the stream (§V-B).  Plain reservoir
sampling is kept for the Table II ablation.
"""
from __future__ import annotations

from typing import Generic, List, TypeVar

import numpy as np

T = TypeVar("T")


class SlidingWindow(Generic[T]):
    """Fixed-size window of the most recent items."""

    def __init__(self, size: int):
        self.size = size
        self.items: List[T] = []

    def add(self, item: T) -> None:
        self.items.append(item)
        if len(self.items) > self.size:
            self.items.pop(0)

    def sample(self) -> List[T]:
        return list(self.items)

    def __len__(self) -> int:
        return len(self.items)


class ReservoirSample(Generic[T]):
    """Classic Vitter reservoir: uniform over the whole history."""

    def __init__(self, size: int, seed: int = 0):
        self.size = size
        self.rng = np.random.default_rng(seed)
        self.items: List[T] = []
        self.seen = 0

    def add(self, item: T) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.size:
                self.items[j] = item

    def sample(self) -> List[T]:
        return list(self.items)

    def __len__(self) -> int:
        return len(self.items)


class RTBSample(Generic[T]):
    """Reservoir-based Time-Biased Sampling (R-TBS).

    Items are retained with probability proportional to an exponential decay
    of their age: an item of age a has relative weight exp(-lam * a).  We use
    the simple "replace-with-probability" variant: each arrival is accepted
    into a full reservoir with probability p_accept driven by the weight ratio
    between the newest item (weight 1) and the current average retained
    weight; the evictee is chosen inverse-proportionally to weight.  This
    matches the qualitative property OREO needs -- recency bias with a tail of
    history -- and is exact for lam=0 (uniform reservoir).
    """

    def __init__(self, size: int, lam: float = 1e-3, seed: int = 0):
        self.size = size
        self.lam = lam
        self.rng = np.random.default_rng(seed)
        self.items: List[T] = []
        self.arrival: List[int] = []
        self.t = 0
        #: Bumped whenever the retained sample changes.  Consumers (e.g. the
        #: LayoutManager's cost-vector cache) key derived data on this counter
        #: so rejected arrivals don't invalidate anything.
        self.version = 0

    def _weights(self) -> np.ndarray:
        ages = self.t - np.asarray(self.arrival, dtype=np.float64)
        return np.exp(-self.lam * ages)

    def add(self, item: T) -> None:
        self.t += 1
        if len(self.items) < self.size:
            self.items.append(item)
            self.arrival.append(self.t)
            self.version += 1
            return
        w = self._weights()
        # Accept the (weight-1) newcomer vs. the reservoir's mean weight.
        p_accept = 1.0 / (1.0 + w.mean() * (self.size - 1) / self.size)
        p_accept = min(max(p_accept * 2.0, 1.0 / self.size), 1.0)
        if self.rng.random() < p_accept:
            inv = 1.0 / np.maximum(w, 1e-12)
            evict = int(self.rng.choice(self.size, p=inv / inv.sum()))
            self.items[evict] = item
            self.arrival[evict] = self.t
            self.version += 1

    def sample(self) -> List[T]:
        return list(self.items)

    def __len__(self) -> int:
        return len(self.items)
