"""Data layouts and partition-level metadata.

A *layout* is a mapping from rows of a table to partitions (the paper's BID
column).  OREO never needs the mapping itself at decision time -- only the
per-partition metadata (min/max per column, row counts), which is what
``eval_skipped`` consumes.  Cost estimation is metadata-only and never
touches row data.

Zone maps live on the table's device.  The (Q, P) scan matrix is computed
there (:func:`repro_torch.engine.compute.scan_matrix`) and copied back; the
row-weighted reduction runs on the host through one numpy einsum
(:func:`scanned_dot`), so costs are bit-identical to the reference
package's and do not depend on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

#: Rows of the table :func:`metadata_from_assignment` reduces at a time,
#: in bytes: the partition gathers it makes never exceed this, however
#: skewed the layout.
CHUNK_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True, eq=False)
class PartitionMetadata:
    """Per-partition zone maps on a device.

    ``mins``/``maxs`` are (P, C) float64 tensors and ``rows`` the (P,)
    float64 row counts; ``rows_host`` is the host copy of ``rows`` that
    every cost reduction reads (made once, at construction).
    """

    mins: torch.Tensor
    maxs: torch.Tensor
    rows: torch.Tensor
    rows_host: Optional[np.ndarray] = dataclasses.field(default=None,
                                                        repr=False)

    def __post_init__(self):
        assert self.mins.shape == self.maxs.shape
        assert self.mins.shape[0] == self.rows.shape[0]
        if self.rows_host is None:
            object.__setattr__(self, "rows_host", self.rows.cpu().numpy()
                               .astype(np.float64))

    @property
    def device(self) -> torch.device:
        return self.mins.device

    @property
    def num_partitions(self) -> int:
        return int(self.mins.shape[0])

    @property
    def num_columns(self) -> int:
        return int(self.mins.shape[1])

    @property
    def total_rows(self) -> int:
        return int(self.rows_host.sum())


def metadata_from_assignment(data: torch.Tensor, assignment: torch.Tensor,
                             num_partitions: int,
                             row_scale: float = 1.0) -> PartitionMetadata:
    """Compute zone maps for ``data`` (N, C) under partition ``assignment`` (N,).

    ``row_scale`` scales row counts when ``data`` is a sample standing in for
    a larger table (the paper builds layouts and estimates metadata from
    0.1-1% samples; the full table is only touched on reorganization).

    Runs on the table's device, one block of rows (``CHUNK_BYTES``) at a
    time.  One pass counts every block's rows per partition
    (``torch.bincount``) and reads all the counts back at once; a second
    sorts each block's rows by partition and folds each partition's
    contiguous run into its min and max.  Over a full table this reads each
    row twice, with one host round trip per call, no atomics (a scatter-min
    into P x C slots would funnel every row through the same few addresses)
    and no sorted copy larger than one block, however skewed the layout.
    Min, max and integer counts do not depend on the order of the work, so
    the result is exact.  Empty partitions keep the [+inf, -inf] identity
    bounds and zero rows; rows assigned outside ``[0, num_partitions)`` are
    ignored.
    """
    n, c = data.shape
    mins = torch.full((num_partitions, c), np.inf, dtype=data.dtype,
                      device=data.device)
    maxs = torch.full((num_partitions, c), -np.inf, dtype=data.dtype,
                      device=data.device)
    step = max(1, CHUNK_BYTES // max(1, c * data.element_size()))
    starts = range(0, n, step)

    def buckets(start: int) -> torch.Tensor:
        # Out-of-range rows go to an extra bucket, past the last partition.
        a = assignment[start:start + step].long()
        return torch.where((a >= 0) & (a < num_partitions), a,
                           num_partitions)
    per_block = [torch.bincount(buckets(s), minlength=num_partitions + 1)
                 for s in starts]
    block_counts = (torch.stack(per_block).cpu().numpy() if per_block
                    else np.zeros((0, num_partitions + 1), dtype=np.int64))
    for start, block_count in zip(starts, block_counts):
        by_part = data[start:start + step][torch.argsort(buckets(start))]
        ends = np.cumsum(block_count)
        for p in np.flatnonzero(block_count[:num_partitions]):
            lo, hi = torch.aminmax(by_part[ends[p] - block_count[p]:ends[p]],
                                   dim=0)
            mins[p] = torch.minimum(mins[p], lo)
            maxs[p] = torch.maximum(maxs[p], hi)
        del by_part     # free this block's copy before the next one's
    counts = block_counts[:, :num_partitions].sum(axis=0, dtype=np.int64)
    rows = np.zeros(num_partitions, dtype=np.float64)
    nonempty = counts > 0
    rows[nonempty] = counts[nonempty] * row_scale
    return PartitionMetadata(mins=mins, maxs=maxs,
                             rows=torch.from_numpy(rows).to(data.device),
                             rows_host=rows)


@dataclasses.dataclass
class Layout:
    """A data layout: an assignment function plus its partition metadata.

    ``route`` maps a (N, C) tensor of rows to partition ids on the same
    device; it is retained so a *reorganization* (full rewrite of the table
    under this layout) can be materialized.  ``meta`` is the *estimated*
    metadata (built from the data sample the generator saw) used for
    decision making; ``true_meta`` is the exact metadata of the
    materialized table, filled in lazily the first time the layout is
    actually reorganized to (:meth:`materialize`).
    """

    layout_id: int
    name: str
    technique: str                      # "qdtree" | "default" | ...
    meta: PartitionMetadata
    route: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    info: dict = dataclasses.field(default_factory=dict)
    true_meta: Optional[PartitionMetadata] = None

    @property
    def num_partitions(self) -> int:
        return self.meta.num_partitions

    def materialize(self, data: torch.Tensor) -> PartitionMetadata:
        """Reorganize the full table under this layout; exact zone maps."""
        if self.true_meta is None:
            if self.route is None:
                self.true_meta = self.meta
            else:
                assignment = self.route(data)
                self.true_meta = metadata_from_assignment(
                    data, assignment, self.num_partitions)
        return self.true_meta

    def serving_meta(self) -> PartitionMetadata:
        """Metadata of the physically materialized table (falls back to the
        estimate if never materialized -- e.g. the initial default layout)."""
        return self.true_meta if self.true_meta is not None else self.meta


# ---------------------------------------------------------------------------
# Query cost evaluation ("eval_skipped")
# ---------------------------------------------------------------------------
#
# Every cost path below reduces the host copy of the scan matrix with the
# SAME contiguous einsum contraction (``scanned_dot``) the reference package
# uses, so single-query, batched-query and batched-state evaluation are
# bit-identical to each other and to the reference.


def scanned_dot(scanned: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Deterministic ``scanned · rows`` shared by all cost paths.

    ``scanned`` is bool (P,) or (Q, P); ``rows`` is float64 (P,).  Operands
    must be contiguous along P (freshly computed scan matrices always are).
    """
    if scanned.ndim == 1:
        return np.einsum("p,p->", scanned, rows)
    return np.einsum("qp,p->q", scanned, rows)


def partitions_scanned(meta: PartitionMetadata, q_lo: np.ndarray,
                       q_hi: np.ndarray) -> np.ndarray:
    """Which partitions a conjunctive range query must scan.

    ``q_lo``/``q_hi`` are (C,) or (Q, C) host arrays.  A partition is
    scanned iff every column's [min, max] range overlaps the query's
    [lo, hi] range.  Returns host bool (P,) or (Q, P).
    """
    from repro_torch.engine import compute
    scanned = compute.scan_matrix(np.atleast_2d(q_lo), np.atleast_2d(q_hi),
                                  meta.mins, meta.maxs)
    if q_lo.ndim == 1:
        return scanned[0]
    return scanned


def eval_cost(meta: PartitionMetadata, q_lo: np.ndarray,
              q_hi: np.ndarray) -> np.ndarray:
    """Fraction of data records accessed: the paper's service cost c(s, q).

    Returns float (Q,) (or scalar for a single query), each in [0, 1].
    """
    scanned = partitions_scanned(meta, q_lo, q_hi)
    total = max(meta.total_rows, 1)
    return scanned_dot(scanned, self_rows(meta)) / total


def self_rows(meta: PartitionMetadata) -> np.ndarray:
    return meta.rows_host


def eval_skipped(meta: PartitionMetadata, q_lo: np.ndarray,
                 q_hi: np.ndarray) -> np.ndarray:
    """Fraction of data records *skipped* (1 - cost)."""
    return 1.0 - eval_cost(meta, q_lo, q_hi)


def cost_vector(meta: PartitionMetadata, q_lo: np.ndarray,
                q_hi: np.ndarray) -> np.ndarray:
    """Cost vector of a layout over a query sample -- used for ε-admission."""
    return np.atleast_1d(eval_cost(meta, q_lo, q_hi))


def layout_distance(cv_a: np.ndarray, cv_b: np.ndarray) -> float:
    """Normalized L1 distance between two cost vectors (paper §V-B).

    Zero-length vectors (an empty query sample) carry no evidence that two
    layouts are similar, so the distance is *infinite*: admission treats the
    pair as distinct-but-unverifiable (callers reject separately) and
    eviction/pruning never merges states on the basis of an empty sample.
    """
    if len(cv_a) == 0 or len(cv_b) == 0:
        return float("inf")
    return float(np.abs(cv_a - cv_b).mean())


def eval_cost_states(metas: Sequence[PartitionMetadata], q_lo: np.ndarray,
                     q_hi: np.ndarray) -> np.ndarray:
    """Service cost of a *single* query under many candidate layouts at once.

    The partition-overlap test runs as one scan over all states, padded to
    the widest partition count (padding rows use [+inf, -inf] bounds, so
    they are never scanned).  The final per-state dot products reuse each
    state's exact (P,) row counts, so the result is bit-identical to calling
    :func:`eval_cost` on every state individually.

    Returns float (S,), one cost in [0, 1] per state.
    """
    from repro_torch.engine import compute
    if not metas:
        return np.zeros(0)
    counts = [m.num_partitions for m in metas]
    p_max = max(counts)
    s, c = len(metas), metas[0].num_columns
    dev = metas[0].device
    mins = torch.full((s, p_max, c), np.inf, dtype=torch.float64, device=dev)
    maxs = torch.full((s, p_max, c), -np.inf, dtype=torch.float64,
                      device=dev)
    for i, m in enumerate(metas):
        mins[i, :counts[i]] = m.mins
        maxs[i, :counts[i]] = m.maxs
    scanned = compute.masked_overlap(mins, maxs, q_lo, q_hi)   # (S, P_max)
    out = np.empty(s)
    for i, m in enumerate(metas):
        total = max(m.total_rows, 1)
        out[i] = scanned_dot(scanned[i, :counts[i]], self_rows(m)) / total
    return out
