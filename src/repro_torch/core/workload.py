"""Query workload generation.

The paper's workload generator: a state machine that samples range queries
from one query *template* for an arbitrary amount of time before switching
to another random template (§VI-A2).  Templates focus on a small set of
columns with a target selectivity, mimicking TPC-H/TPC-DS template families.

Queries stay on the host: their bounds are ``(C,)`` float64 numpy arrays,
drawn from numpy ``Generator``s seeded exactly as the reference package
draws them, so the same seed gives the same stream.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

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


def queried_column_histogram(queries: Sequence[Query],
                             num_columns: int) -> np.ndarray:
    """How often each column appears with a finite predicate -- used by the
    workload-aware Z-order generator (top-k most-queried columns)."""
    hist = np.zeros(num_columns, dtype=np.int64)
    for q in queries:
        finite = np.isfinite(q.lo) | np.isfinite(q.hi)
        hist += finite.astype(np.int64)
    return hist
