"""Micro-move planning: diff two layouts into budgetable partition moves.

A *migration* replaces the serving (source) layout with a target layout.
Atomically that is one rewrite of every partition; incrementally it is a
sequence of :class:`MicroMove`\\ s, one per target partition whose row set
actually differs from the source layout (identical partitions never move —
the same diff the skip-aware
:meth:`repro_torch.data.partition_store.PartitionStore.reorganize` applies
on disk).

The plan also carries the *block decomposition* the hybrid serving state
is maintained from: block ``(i, j)`` holds the rows routed from source
partition ``i`` to target partition ``j``, with exact per-block zone maps.
After any subset ``D`` of moves has completed, the physically hybrid table
is exactly

* one partition per **done** target ``j ∈ D`` (exact target zone maps),
* one **residual** partition per source ``i`` holding its not-yet-moved
  rows — zone maps are the elementwise min/max over blocks ``(i, j)`` with
  ``j ∉ D``,

and :meth:`MigrationPlan.hybrid_meta` materializes those
``P_s + P_t``-partition zone maps for any done mask in one masked
reduction over the block tensors.

The row assignments and the block zone maps stay on the table's device;
the block row counts, the identical-partition test, the gains and the sort
run on the host with the reference package's numpy expressions, so a plan
equals the reference's exact plan bit for bit.

Move *ordering* is greedy by estimated skipping-benefit-per-row under the
recent query distribution: completing move ``j`` relocates each block
``(i, j)`` from a partition scanned with the source partition's observed
frequency to one scanned with the target partition's frequency.  The
per-partition scan frequencies are one pass over both layouts' zone maps,
padded into one ``(2, P_max, C)`` plane, through the lane named by
``compute``: ``"move_score"`` (one launch of the move-score kernel) or
``"decision_fused"`` (the fused decision kernel's ``freq`` output).  Both
compare in float64 and give ``count / Q`` exactly.  Ordering never changes
the move *set*, which is always exactly the layout diff.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import layouts as L
from repro_torch.core import workload as wl
from repro_torch.engine import compute as _compute

#: The planner's scan-frequency lanes, each named after its kernel.
COMPUTES = ("move_score", "decision_fused")


@dataclasses.dataclass(frozen=True)
class MicroMove:
    """One budgetable unit of migration: materialize one target partition.

    ``rows`` is the number of rows relocated (the move's cost in the row
    budget); ``source_partitions`` the partitions those rows leave;
    ``benefit_per_row`` the greedy ordering key (estimated rows of scan
    saved per query, per row moved — 0.0 when no recent queries were
    available at planning time).
    """

    target_partition: int
    rows: int
    source_partitions: Tuple[int, ...]
    benefit_per_row: float = 0.0


@dataclasses.dataclass
class MigrationPlan:
    """Everything the executor and the hybrid backends need for one
    migration: the ordered moves, the block decomposition, and both
    layouts' row-level assignments."""

    source_id: int
    target: L.Layout
    moves: List[MicroMove]
    total_move_rows: int
    num_source_partitions: int
    num_target_partitions: int
    #: (N,) row -> source / target partition assignments over the table,
    #: int64 on its device.
    source_assignment: torch.Tensor
    target_assignment: torch.Tensor
    #: (P_s, P_t, C) device / (P_s, P_t) host exact per-block zone maps;
    #: empty blocks carry the [+inf, -inf] identity bounds and zero rows.
    block_mins: torch.Tensor
    block_maxs: torch.Tensor
    block_rows: np.ndarray
    #: Exact zone maps of the fully-materialized target table.
    target_meta: L.PartitionMetadata
    #: target partition j -> identical source partition i (row set
    #: unchanged between the layouts; such partitions never move).
    identical: dict

    @property
    def num_moves(self) -> int:
        return len(self.moves)

    def target_partition_rows(self, data: torch.Tensor,
                              j: int) -> torch.Tensor:
        """The physical rows of target partition ``j`` (stable row order)."""
        return data[self.target_assignment == j]

    def source_moved_mask(self, i: int, done: np.ndarray) -> torch.Tensor:
        """Per-row moved flags for source partition ``i``'s rows (in their
        original, file-stable order) given the host ``(P_t,)`` done mask."""
        done_dev = torch.as_tensor(done, device=self.target_assignment.device)
        return done_dev[self.target_assignment[self.source_assignment == i]]

    def hybrid_meta(self, done: np.ndarray) -> L.PartitionMetadata:
        """Exact zone maps of the hybrid table after the ``done`` moves.

        Partition order is ``[residual sources (P_s), targets (P_t)]``;
        fully-drained sources and not-yet-done targets carry the
        [+inf, -inf] identity bounds and zero rows, so they are never
        scanned and contribute exactly 0.0 to any cost reduction.  The
        masked min/max runs over the block tensors on the device, the row
        sums on the host.
        """
        p_s = self.num_source_partitions
        c = self.block_mins.shape[2]
        dev = self.block_mins.device
        kw = dict(dtype=torch.float64, device=dev)
        not_done = ~done
        if not_done.any():
            keep = torch.as_tensor(np.flatnonzero(not_done), device=dev)
            res_mins = self.block_mins[:, keep, :].amin(dim=1)
            res_maxs = self.block_maxs[:, keep, :].amax(dim=1)
            res_rows = self.block_rows[:, not_done].sum(axis=1)
        else:
            res_mins = torch.full((p_s, c), np.inf, **kw)
            res_maxs = torch.full((p_s, c), -np.inf, **kw)
            res_rows = np.zeros(p_s)
        done_dev = torch.as_tensor(done, device=dev)[:, None]
        tgt_mins = torch.where(done_dev, self.target_meta.mins, np.inf)
        tgt_maxs = torch.where(done_dev, self.target_meta.maxs, -np.inf)
        tgt_rows = np.where(done, self.target_meta.rows_host, 0.0)
        rows = np.concatenate([res_rows, tgt_rows])
        return L.PartitionMetadata(
            mins=torch.cat([res_mins, tgt_mins]),
            maxs=torch.cat([res_maxs, tgt_maxs]),
            rows=torch.from_numpy(rows).to(dev), rows_host=rows)


def _assignment(layout: L.Layout, data: torch.Tensor) -> torch.Tensor:
    """Row -> partition assignment on the table's device, matching what a
    physical write of the layout produces (``route`` when present;
    partition 0 otherwise, which is exactly how
    :meth:`PartitionStore.write` routes route-less layouts)."""
    if layout.route is None:
        return torch.zeros(len(data), dtype=torch.int64, device=data.device)
    return layout.route(data).to(torch.int64)


def scan_frequencies(metas: Sequence[L.PartitionMetadata],
                     q_lo: np.ndarray, q_hi: np.ndarray,
                     compute: str = "move_score") -> List[np.ndarray]:
    """Mean scan frequency of every partition of every layout under a query
    sample: ``(Q, C)`` host bounds x S layouts -> one host float64
    ``(P_s,)`` vector per layout.

    The layouts are stacked into one padded ``(S, P_max, C)`` plane on
    their device (padding carries [+inf, -inf] and is never scanned) and
    scored in one launch: ``compute="move_score"`` through the move-score
    kernel, ``"decision_fused"`` through the fused decision kernel's
    ``freq`` output over the ``(1, S, P_max, C)`` plane.  Both are exact,
    ``count / Q``.
    """
    if compute not in COMPUTES:
        raise ValueError(f"unknown planner compute lane {compute!r} "
                         f"(expected one of {COMPUTES})")
    counts = [m.num_partitions for m in metas]
    p_max = max(counts)
    s, c = len(metas), metas[0].num_columns
    kw = dict(dtype=torch.float64, device=metas[0].device)
    mins = torch.full((s, p_max, c), np.inf, **kw)
    maxs = torch.full((s, p_max, c), -np.inf, **kw)
    for k, m in enumerate(metas):
        mins[k, :counts[k]] = m.mins
        maxs[k, :counts[k]] = m.maxs
    if compute == "move_score":
        freq = _compute.move_frequencies(q_lo, q_hi, mins, maxs)
    else:
        freq = _compute.fused_window_freq(q_lo, q_hi, mins[None],
                                          maxs[None])[0]
    return [freq[k, :counts[k]].copy() for k in range(s)]


def plan_migration(data: torch.Tensor, source: L.Layout, target: L.Layout,
                   recent_queries: Sequence[wl.Query] = (),
                   compute: str = "move_score",
                   source_assignment: Optional[torch.Tensor] = None,
                   source_meta: Optional[L.PartitionMetadata] = None,
                   ) -> MigrationPlan:
    """Diff ``source`` -> ``target`` into greedily-ordered micro-moves.

    The move set is exactly the layout diff: one move per non-empty target
    partition whose row set is not already held verbatim by some source
    partition.  ``recent_queries`` drives the greedy
    benefit-per-row-moved ordering; with an empty sample the diff is
    ordered by target partition id (benefit 0).

    ``source_assignment`` / ``source_meta`` (always passed together)
    override the physical source partitioning — the hook the streaming
    ingest plane uses to plan compactions against a delta-bearing source.
    """
    if (source_assignment is None) != (source_meta is None):
        raise ValueError("source_assignment and source_meta go together")
    if compute not in COMPUTES:
        raise ValueError(f"unknown planner compute lane {compute!r} "
                         f"(expected one of {COMPUTES})")
    if source_assignment is None:
        a_s = _assignment(source, data)
        src_meta = source.serving_meta()
    else:
        a_s = torch.as_tensor(source_assignment, dtype=torch.int64,
                              device=data.device)
        src_meta = source_meta
    a_t = _assignment(target, data)
    p_s = src_meta.num_partitions
    p_t = target.num_partitions
    target_meta = target.materialize(data)

    # Exact per-block zone maps in one grouped reduction over the combined
    # (source, target) assignment key, on the device.
    key = a_s * p_t + a_t
    block = L.metadata_from_assignment(data, key, p_s * p_t)
    del key
    block_mins = block.mins.reshape(p_s, p_t, -1)
    block_maxs = block.maxs.reshape(p_s, p_t, -1)
    block_rows = block.rows_host.reshape(p_s, p_t)

    src_counts = block_rows.sum(axis=1)                  # (P_s,)
    tgt_counts = block_rows.sum(axis=0)                  # (P_t,)
    feeders = block_rows > 0                             # (P_s, P_t)

    # A target partition is *identical* iff all its rows come from one
    # source partition that contributes nothing anywhere else.
    identical = {}
    single_feeder = feeders.sum(axis=0) == 1
    for j in np.nonzero(single_feeder & (tgt_counts > 0))[0]:
        i = int(np.nonzero(feeders[:, j])[0][0])
        if block_rows[i, j] == src_counts[i] == tgt_counts[j]:
            identical[int(j)] = i

    diff = [int(j) for j in range(p_t)
            if tgt_counts[j] > 0 and int(j) not in identical]

    benefit_per_row = np.zeros(p_t)
    if recent_queries and diff:
        q_lo, q_hi = wl.stack_queries(list(recent_queries))
        freq_src, freq_tgt = scan_frequencies(
            [src_meta, target_meta], q_lo, q_hi, compute=compute)
        # Completing move j relocates block (i, j) from a partition read
        # with frequency freq_src[i] to one read with freq_tgt[j].
        gain = block_rows.T @ freq_src - tgt_counts * freq_tgt   # (P_t,)
        benefit_per_row = np.divide(gain, tgt_counts,
                                    out=np.zeros(p_t),
                                    where=tgt_counts > 0)

    order = sorted(diff, key=lambda j: (-benefit_per_row[j], j))
    moves = [MicroMove(target_partition=j,
                       rows=int(tgt_counts[j]),
                       source_partitions=tuple(
                           int(i) for i in np.nonzero(feeders[:, j])[0]),
                       benefit_per_row=float(benefit_per_row[j]))
             for j in order]
    return MigrationPlan(
        source_id=source.layout_id,
        target=target,
        moves=moves,
        total_move_rows=int(sum(m.rows for m in moves)),
        num_source_partitions=p_s,
        num_target_partitions=p_t,
        source_assignment=a_s,
        target_assignment=a_t,
        block_mins=block_mins,
        block_maxs=block_maxs,
        block_rows=block_rows,
        target_meta=target_meta,
        identical=identical,
    )


def plan_is_permutation_of_diff(plan: MigrationPlan) -> bool:
    """True iff the plan's move order is a permutation of the layout diff
    (every differing non-empty target partition exactly once)."""
    tgt_counts = plan.block_rows.sum(axis=0)
    diff = {int(j) for j in range(plan.num_target_partitions)
            if tgt_counts[j] > 0 and int(j) not in plan.identical}
    moved = [m.target_partition for m in plan.moves]
    return len(moved) == len(set(moved)) and set(moved) == diff


__all__ = ["COMPUTES", "MicroMove", "MigrationPlan", "plan_migration",
           "plan_is_permutation_of_diff", "scan_frequencies"]
