"""Columnar partition store: the physical layer under a data layout.

Materializes a layout (BID assignment) as one compressed file per partition
plus a metadata manifest -- the same structure the paper's Spark integration
uses (BID column + partition-level zone maps).  ``scan`` reads only the
partitions a query's predicates cannot skip; ``reorganize`` rewrites every
partition under a new layout (the alpha-cost operation measured in Table I).

The table lives on a device and the files on the host: :meth:`write`
routes the table on its device and gathers each partition there in stable
row order (one stable sort by assignment, then one slice per partition,
each copied to the host once), and the skip test of :meth:`scan` runs on
the device.  Files and ``manifest.json`` are the reference package's, byte
for byte in the manifest's case.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import layouts as L
from repro_torch.core import workload as wl
from repro_torch.kernels._backend import resolve_device


@dataclasses.dataclass
class ScanStats:
    partitions_read: int
    partitions_total: int
    rows_read: int
    seconds: float


@dataclasses.dataclass
class ReorgStats:
    """Outcome of one :meth:`PartitionStore.reorganize` call.

    ``partitions_rewritten`` counts partitions whose row set changed under
    the new layout (re-compressed and rewritten); ``partitions_skipped``
    counts partitions whose row set is identical between the layouts —
    their files are carried over without re-routing, re-compressing or
    re-serializing a single row.
    """

    seconds: float
    partitions_rewritten: int
    partitions_skipped: int
    rows_rewritten: int

    def __float__(self) -> float:
        return self.seconds


def manifest_dict(num_partitions: int, mins, maxs, rows,
                  layout_name: str) -> dict:
    """The manifest as a plain dict — the single canonical construction,
    shared by :func:`write_manifest` and a durability log, so a replayed
    manifest is *bitwise* the one on disk."""
    return {"num_partitions": int(num_partitions),
            "mins": [list(m) for m in mins],
            "maxs": [list(m) for m in maxs],
            "rows": [int(r) for r in rows],
            "layout": layout_name}


def write_manifest(root: str, num_partitions: int, mins, maxs, rows,
                   layout_name: str) -> None:
    """Write a store directory's manifest — the single producer of the
    format :meth:`PartitionStore.metadata` parses, shared by full writes,
    skip-aware reorganization, and incremental migration completion."""
    manifest = manifest_dict(num_partitions, mins, maxs, rows, layout_name)
    with open(os.path.join(root, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def chunk_bounds(chunk: np.ndarray, num_columns: int):
    """One partition's (mins, maxs) manifest rows; empty partitions carry
    the [+inf, -inf] identity bounds."""
    if len(chunk):
        return chunk.min(axis=0).tolist(), chunk.max(axis=0).tolist()
    return ([float("inf")] * num_columns, [float("-inf")] * num_columns)


def _route(layout: L.Layout, data: torch.Tensor) -> torch.Tensor:
    """Row -> partition ids on the table's device (partition 0 for a
    route-less layout)."""
    if layout.route is None:
        return torch.zeros(len(data), dtype=torch.int64, device=data.device)
    return layout.route(data).to(torch.int64)


def _grouped(assignment: torch.Tensor, k: int):
    """Stable row order grouped by partition: (order, host bounds) with
    partition p's rows at ``order[bounds[p]:bounds[p + 1]]``; rows assigned
    outside ``[0, k)`` fall outside every group."""
    sorted_bid, order = torch.sort(assignment, stable=True)
    bounds = torch.searchsorted(
        sorted_bid, torch.arange(k + 1, device=assignment.device))
    return order, bounds.cpu().numpy()


class PartitionStore:
    """On-disk partitioned table with zone-map metadata.

    ``device`` is where :meth:`metadata` puts the zone maps and where scans
    test them (the card unless the caller asks for the CPU).
    """

    def __init__(self, root: str,
                 device: Union[None, str, torch.device] = None):
        self.root = root
        self.device = resolve_device(device)
        # A crash mid-write/mid-reorganize leaves a fully- or partially-
        # written "<root>.tmp" staging directory behind (the swap in
        # _swap_in never happened, so the live directory is intact and
        # the orphan is pure garbage): reclaim it on open.
        orphan = root + ".tmp"
        if os.path.isdir(orphan):
            shutil.rmtree(orphan, ignore_errors=True)
        os.makedirs(root, exist_ok=True)

    def _fresh_tmp(self) -> str:
        tmp = self.root + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        return tmp

    def _swap_in(self, tmp: str) -> None:
        # Atomic swap (background reorganization completes, then the layout
        # pointer flips -- §III-B).
        if os.path.exists(self.root):
            shutil.rmtree(self.root)
        os.rename(tmp, self.root)

    # ------------------------------------------------------------------
    def write(self, data: torch.Tensor, layout: L.Layout,
              compress: bool = True) -> float:
        """Full reorganization: route rows, rewrite all partition files.
        Returns seconds taken (the measured reorg cost)."""
        t0 = time.time()
        k = layout.num_partitions
        order, bounds = _grouped(_route(layout, data), k)
        tmp = self._fresh_tmp()
        mins, maxs, rows = [], [], []
        save = np.savez_compressed if compress else np.savez
        for p in range(k):
            chunk = data[order[bounds[p]:bounds[p + 1]]].cpu().numpy()
            save(os.path.join(tmp, f"part_{p:05d}.npz"), rows=chunk)
            lo, hi = chunk_bounds(chunk, data.shape[1])
            mins.append(lo)
            maxs.append(hi)
            rows.append(int(len(chunk)))
        write_manifest(tmp, k, mins, maxs, rows, layout.name)
        self._swap_in(tmp)
        return time.time() - t0

    # ------------------------------------------------------------------
    def reorganize(self, layout: L.Layout) -> ReorgStats:
        """Reorganization as the paper measures it (Table I): read every
        partition back from disk, update the BID column (re-route on the
        layout's device), shuffle rows into their new partitions (sort by
        BID), then compress and write the new partition files — *except*
        partitions whose row set is unchanged between the layouts, whose
        existing files are carried over as-is.  Returns a
        :class:`ReorgStats` with the rewritten/skipped split.
        """
        t0 = time.time()
        meta = self.metadata()
        chunks = []
        for p in range(meta.num_partitions):
            with np.load(os.path.join(self.root, f"part_{p:05d}.npz")) as z:
                chunks.append(z["rows"])
        data = np.concatenate([c for c in chunks if len(c)]
                              or [np.zeros((0, meta.num_columns))])
        k = layout.num_partitions
        table = torch.as_tensor(data, device=layout.meta.device)
        order, bounds = _grouped(_route(layout, table), k)  # update BID
        order = order.cpu().numpy()                          # shuffle by BID
        del table

        # Old partition p is reusable for new partition p iff the row sets
        # coincide (order-insensitive: shuffling within a partition changes
        # neither its zone maps nor any scan result).
        def row_key(rows: np.ndarray) -> np.ndarray:
            return rows[np.lexsort(rows.T[::-1])] if len(rows) else rows

        tmp = self._fresh_tmp()
        mins, maxs, rows_out = [], [], []
        rewritten = skipped = rows_rewritten = 0
        save = np.savez_compressed
        for p in range(k):
            chunk = data[order[bounds[p]:bounds[p + 1]]]
            # Reuse requires an existing file to carry over: a partition
            # index beyond the old layout's count is always (re)written.
            identical = (p < len(chunks)
                         and len(chunk) == len(chunks[p])
                         and np.array_equal(row_key(chunk),
                                            row_key(chunks[p])))
            if identical:
                shutil.copyfile(os.path.join(self.root, f"part_{p:05d}.npz"),
                                os.path.join(tmp, f"part_{p:05d}.npz"))
                skipped += 1
            else:
                save(os.path.join(tmp, f"part_{p:05d}.npz"), rows=chunk)
                rewritten += 1
                rows_rewritten += len(chunk)
            lo, hi = chunk_bounds(chunk, data.shape[1])
            mins.append(lo)
            maxs.append(hi)
            rows_out.append(int(len(chunk)))
        write_manifest(tmp, k, mins, maxs, rows_out, layout.name)
        self._swap_in(tmp)
        return ReorgStats(seconds=time.time() - t0,
                          partitions_rewritten=rewritten,
                          partitions_skipped=skipped,
                          rows_rewritten=rows_rewritten)

    # ------------------------------------------------------------------
    def metadata(self) -> L.PartitionMetadata:
        """The manifest's zone maps, on :attr:`device`."""
        with open(os.path.join(self.root, "manifest.json")) as f:
            m = json.load(f)
        c = len(m["mins"][0]) if m["mins"] else 0
        rows = np.array(m["rows"], dtype=np.float64)

        def bounds(key):
            return torch.as_tensor(np.array(m[key], dtype=np.float64)
                                   .reshape(-1, c), device=self.device)
        return L.PartitionMetadata(mins=bounds("mins"), maxs=bounds("maxs"),
                                   rows=torch.as_tensor(rows,
                                                        device=self.device),
                                   rows_host=rows)

    def scan(self, query: wl.Query) -> Tuple[np.ndarray, ScanStats]:
        """Execute a query: read only non-skippable partitions, filter rows."""
        t0 = time.time()
        meta = self.metadata()
        scanned = L.partitions_scanned(meta, query.lo, query.hi)
        chunks = []
        rows_read = 0
        for p in np.nonzero(scanned)[0]:
            with np.load(os.path.join(self.root, f"part_{p:05d}.npz")) as z:
                chunk = z["rows"]
            rows_read += len(chunk)
            mask = ((chunk >= query.lo[None, :])
                    & (chunk <= query.hi[None, :])).all(axis=1)
            chunks.append(chunk[mask])
        out = (np.concatenate(chunks) if chunks
               else np.zeros((0, meta.num_columns)))
        return out, ScanStats(int(scanned.sum()), meta.num_partitions,
                              rows_read, time.time() - t0)

    def full_scan_seconds(self) -> float:
        """Time a full table scan (the alpha denominator)."""
        meta = self.metadata()
        t0 = time.time()
        for p in range(meta.num_partitions):
            with np.load(os.path.join(self.root, f"part_{p:05d}.npz")) as z:
                _ = z["rows"].sum()
        return time.time() - t0


__all__ = ["PartitionStore", "ReorgStats", "ScanStats", "chunk_bounds",
           "manifest_dict", "write_manifest"]
