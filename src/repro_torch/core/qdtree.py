"""Greedy Qd-tree layout generation (Yang et al., SIGMOD'20; paper §VI-A1).

The tree is built on a small data *sample* (0.1%-1% of rows, as in the paper)
using candidate cuts drawn from workload query predicates.  No advanced
(record-induced) cuts -- matching the paper's stated implementation.  Each
split greedily maximizes the expected number of sample rows skipped across the
window's queries.  The resulting binary tree routes any row to a leaf
(= partition id); partition metadata is then computed on the full table.

Split between host and device: the sample draw (a numpy ``Generator``,
seeded as in the reference), the query-side candidate cuts and the gain
arithmetic stay on the host; everything that touches sample rows — the
gather, the per-column sorts, the counts below each cut, the splits and
the median fallback — runs on the table's device.  Counts are integers and
comparisons exact, so the tree equals the reference's.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import layouts, workload as wl


@dataclasses.dataclass
class _Node:
    lo: np.ndarray              # node bounding box (C,), host
    hi: np.ndarray
    row_idx: torch.Tensor       # sample rows in this node, on the device
    col: int = -1               # split column (-1 = leaf)
    threshold: float = 0.0
    left: int = -1              # child node indices
    right: int = -1
    leaf_id: int = -1


def _rows_at_or_below(sample: torch.Tensor, row_idx: torch.Tensor,
                      cols: List[int], cuts: List[np.ndarray]) -> np.ndarray:
    """(len(cols), max cuts) counts of the node's rows with value <= cut.

    One sort of the node's rows for all candidate columns and one batched
    search, copied back in one transfer; padding cuts are +inf.
    """
    dev = sample.device
    col_idx = torch.as_tensor(cols, dtype=torch.int64, device=dev)
    vals = sample.index_select(0, row_idx).index_select(1, col_idx)
    vals = torch.sort(vals.t().contiguous(), dim=1).values     # (k, m)
    width = max(v.size for v in cuts)
    padded = np.full((len(cuts), width), np.inf)
    for i, v in enumerate(cuts):
        padded[i, :v.size] = v
    n_l = torch.searchsorted(vals, torch.as_tensor(padded, device=dev),
                             right=True)
    return n_l.cpu().numpy()


def _best_cut(sample: torch.Tensor, node: _Node, q_lo: np.ndarray,
              q_hi: np.ndarray, min_leaf_rows: int,
              max_cuts_per_col: int = 64) -> Tuple[float, int, float]:
    """Best (gain, col, value) cut for a node, vectorized per column.

    Candidate cuts are query predicate bounds inside the node box (Qd-tree's
    workload cuts).  For a cut (col, v): the left child box gets hi[col]=v and
    is skipped by queries with lo[col] > v; right child symmetric.  Only
    queries overlapping the node box contribute (others skip both children
    regardless).  gain = skipped_queries_left * rows_left +
    skipped_queries_right * rows_right.
    """
    overlap = ((q_lo <= node.hi[None, :]) &
               (q_hi >= node.lo[None, :])).all(axis=1)          # (Q,)
    if not overlap.any():
        return -1.0, -1, 0.0
    nrows = int(node.row_idx.numel())
    cands = []
    for col in range(sample.shape[1]):
        lo_b = q_lo[overlap, col]
        hi_b = q_hi[overlap, col]
        vs = np.concatenate([lo_b, hi_b])
        vs = np.unique(vs[(vs > node.lo[col]) & (vs < node.hi[col])
                          & np.isfinite(vs)])
        if vs.size == 0:
            continue
        if vs.size > max_cuts_per_col:
            vs = vs[np.linspace(0, vs.size - 1, max_cuts_per_col).astype(int)]
        cands.append((col, vs, lo_b, hi_b))
    best_gain, best_col, best_v = -1.0, -1, 0.0
    if not cands:
        return best_gain, best_col, best_v
    below = _rows_at_or_below(sample, node.row_idx, [c[0] for c in cands],
                              [c[1] for c in cands])
    for i, (col, vs, lo_b, hi_b) in enumerate(cands):
        n_l = below[i, :vs.size]
        n_r = nrows - n_l
        lo_sorted = np.sort(lo_b)
        hi_sorted = np.sort(hi_b)
        skip_l = lo_b.size - np.searchsorted(lo_sorted, vs, side="right")
        skip_r = np.searchsorted(hi_sorted, vs, side="left")
        gains = skip_l * n_l + skip_r * n_r
        valid = (n_l >= min_leaf_rows) & (n_r >= min_leaf_rows)
        gains = np.where(valid, gains, -1.0)
        j = int(np.argmax(gains))
        if gains[j] > best_gain:
            best_gain, best_col, best_v = float(gains[j]), col, float(vs[j])
    return best_gain, best_col, best_v


def _median(vals: torch.Tensor) -> float:
    """numpy's median: the mean of the two middle values for even counts
    (``torch.median`` would return the lower one)."""
    s = torch.sort(vals).values
    mid = s.numel() // 2
    if s.numel() % 2:
        return float(s[mid])
    return float((s[mid - 1] + s[mid]) / 2)


class _TreeRouter:
    """Tree routing over the packed node arrays, on their device.

    Built from host arrays; the tree's depth is known up front, so routing
    takes exactly that many vectorized steps with no host round trip (rows
    already at a leaf stay put).
    """

    def __init__(self, cols: np.ndarray, thresholds: np.ndarray,
                 lefts: np.ndarray, rights: np.ndarray, leaf_ids: np.ndarray,
                 device: torch.device):
        self.depth = _tree_depth(cols, lefts, rights)
        self.cols = torch.as_tensor(cols, dtype=torch.int64, device=device)
        self.thresholds = torch.as_tensor(thresholds, dtype=torch.float64,
                                          device=device)
        self.lefts = torch.as_tensor(lefts, dtype=torch.int64, device=device)
        self.rights = torch.as_tensor(rights, dtype=torch.int64,
                                      device=device)
        self.leaf_ids = torch.as_tensor(leaf_ids, dtype=torch.int64,
                                        device=device)

    def __call__(self, rows: torch.Tensor) -> torch.Tensor:
        idx = torch.zeros(len(rows), dtype=torch.int64, device=rows.device)
        for _ in range(self.depth):
            col = self.cols[idx]
            vals = rows.gather(1, col.clamp(min=0).unsqueeze(1)).squeeze(1)
            nxt = torch.where(vals <= self.thresholds[idx], self.lefts[idx],
                              self.rights[idx])
            idx = torch.where(col >= 0, nxt, idx)
        return self.leaf_ids[idx]


def _tree_depth(cols: np.ndarray, lefts: np.ndarray,
                rights: np.ndarray) -> int:
    depth, level = 0, [0]
    while True:
        level = [child for i in level if cols[i] >= 0
                 for child in (int(lefts[i]), int(rights[i]))]
        if not level:
            return depth
        depth += 1


class _DefaultRouter:
    """Arrival-order (or sort-column quantile) routing."""

    def __init__(self, k: int, sort_col: Optional[int],
                 boundaries: Optional[torch.Tensor]):
        self.k = k
        self.sort_col = sort_col
        self.boundaries = boundaries

    def __call__(self, rows: torch.Tensor) -> torch.Tensor:
        if self.sort_col is None:
            return _chunk_ids(len(rows), self.k, rows.device)
        return torch.searchsorted(self.boundaries,
                                  rows[:, self.sort_col].contiguous(),
                                  right=True)


def _chunk_ids(n: int, k: int, device: torch.device) -> torch.Tensor:
    """``min(i * k // n, k - 1)`` for i in [0, n): k equal chunks."""
    return torch.clamp_max(torch.arange(n, device=device) * k // n, k - 1)


def build_qdtree_layout(layout_id: int,
                        data: torch.Tensor,
                        queries: Sequence[wl.Query],
                        k: int,
                        sample_frac: float = 0.01,
                        min_sample_rows: int = 2048,
                        min_leaf_rows: int = 8,
                        seed: int = 0,
                        name: Optional[str] = None) -> layouts.Layout:
    """Greedy Qd-tree with <= k leaves; returns a routable Layout.

    Built entirely on a data sample (paper §VI-A1: 0.1%-1% of rows); the
    returned metadata is the sample *estimate* (rows scaled up).  Exact
    metadata is produced only when the layout is materialized
    (``Layout.materialize``), mirroring the real system where candidate
    exploration never rewrites the table.
    """
    rng = np.random.default_rng(seed)
    n, c = data.shape
    dev = data.device
    m = min(max(int(n * sample_frac), min(n, min_sample_rows)), n)
    sample_idx = rng.choice(n, size=m, replace=False)
    sample = data[torch.as_tensor(sample_idx, device=dev)]

    q_lo, q_hi = wl.stack_queries(list(queries))

    root = _Node(lo=sample.amin(dim=0).cpu().numpy() - 1e-9,
                 hi=sample.amax(dim=0).cpu().numpy() + 1e-9,
                 row_idx=torch.arange(m, device=dev))
    nodes: List[_Node] = [root]
    # Max-heap of splittable leaves by row count (split the biggest first).
    heap: List[Tuple[int, int, int]] = [(-m, 0, 0)]
    tiebreak = 1
    num_leaves = 1
    while num_leaves < k and heap:
        _, _, ni = heapq.heappop(heap)
        node = nodes[ni]
        nrows = int(node.row_idx.numel())
        if nrows < 2 * min_leaf_rows:
            continue
        best = _best_cut(sample, node, q_lo, q_hi, min_leaf_rows)
        if best[1] < 0:
            # No workload cut helps: median-cut the widest queried column to
            # keep sizes bounded (keeps partitions within size targets).
            hist = wl.queried_column_histogram(queries, c)
            col = int(np.argmax(hist)) if hist.sum() else int(
                np.argmax(node.hi - node.lo))
            vals = sample[node.row_idx, col]
            v = _median(vals)
            if not (node.lo[col] < v < node.hi[col]):
                continue
            n_le = int((vals <= v).sum())
            if n_le == 0 or n_le == nrows:
                continue
            best = (0.0, col, v)
        _, col, v = best
        mask = sample[node.row_idx, col] <= v
        lo_l, hi_l = node.lo.copy(), node.hi.copy()
        hi_l[col] = v
        lo_r, hi_r = node.lo.copy(), node.hi.copy()
        lo_r[col] = v
        left = _Node(lo=lo_l, hi=hi_l, row_idx=node.row_idx[mask])
        right = _Node(lo=lo_r, hi=hi_r, row_idx=node.row_idx[~mask])
        node.col, node.threshold = col, v
        node.left, node.right = len(nodes), len(nodes) + 1
        nodes.append(left)
        nodes.append(right)
        for child_i in (node.left, node.right):
            heapq.heappush(heap, (-int(nodes[child_i].row_idx.numel()),
                                  tiebreak, child_i))
            tiebreak += 1
        num_leaves += 1

    # Assign leaf ids.
    leaf_count = 0
    for nd in nodes:
        if nd.col < 0:
            nd.leaf_id = leaf_count
            leaf_count += 1

    route = _TreeRouter(
        np.array([nd.col for nd in nodes], dtype=np.int64),
        np.array([nd.threshold for nd in nodes]),
        np.array([nd.left for nd in nodes], dtype=np.int64),
        np.array([nd.right for nd in nodes], dtype=np.int64),
        np.array([nd.leaf_id for nd in nodes], dtype=np.int64), dev)
    sample_assignment = route(sample)
    meta = layouts.metadata_from_assignment(sample, sample_assignment,
                                            leaf_count, row_scale=n / m)
    return layouts.Layout(
        layout_id=layout_id,
        name=name or f"qdtree#{layout_id}",
        technique="qdtree",
        meta=meta,
        route=route,
        info={"num_nodes": len(nodes), "num_leaves": leaf_count,
              "sample_rows": m},
    )


def build_default_layout(layout_id: int, data: torch.Tensor, k: int,
                         sort_col: Optional[int] = None) -> layouts.Layout:
    """Default layout: partition by arrival order (or a predefined sort col),
    the paper's starting state (e.g. partition-by-time)."""
    n = len(data)
    ranks = _chunk_ids(n, k, data.device)
    if sort_col is None:
        assignment = ranks
        boundaries = None
    else:
        order = torch.argsort(data[:, sort_col], stable=True)
        assignment = torch.empty_like(ranks)
        assignment[order] = ranks
        # Route by value against the learned quantile boundaries.
        vals = data[order, sort_col]
        cuts = torch.clamp_max(
            torch.arange(1, k, device=data.device) * n // k, n - 1)
        boundaries = vals[cuts].contiguous()
    meta = layouts.metadata_from_assignment(data, assignment, k)
    route = _DefaultRouter(k, sort_col, boundaries)
    return layouts.Layout(layout_id=layout_id, name=f"default#{layout_id}",
                          technique="default", meta=meta, route=route)
