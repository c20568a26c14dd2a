"""Storage backends: the physical layer behind the :class:`LayoutEngine`.

A backend owns the *physical* side of the online loop — which layouts are
registered, which one is currently materialized and serving queries, and what
a query actually costs against the materialized table.  The decision layer
(policies + D-UMTS) only ever sees metadata-level cost estimates, mirroring
the paper's design where candidate exploration never touches row data.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import (Dict, List, Optional, Protocol, Sequence, Tuple,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch.core import layouts as L
from repro_torch.core import workload as wl
from repro_torch.data.partition_store import (PartitionStore, manifest_dict,
                                              write_manifest)

from . import compute
from .state_matrix import BlockEstimates, StateMatrix


@runtime_checkable
class StorageBackend(Protocol):
    """Physical layer contract consumed by :class:`LayoutEngine`.

    Lifecycle of a state id under this protocol:

    1. :meth:`register` — a policy admits a candidate layout; the backend
       tracks it but does **not** materialize anything (registration is
       metadata-only and therefore cheap).
    2. :meth:`estimate_costs` — per-query, the engine asks for service-cost
       estimates of many registered states in one batched call.  Estimates
       use each layout's *estimated* metadata (``Layout.meta``), never the
       table.
    3. :meth:`prepare` — the engine announces a reorganization decision.  A
       backend may start background materialization here so the Δ-delay
       between decision and swap overlaps with useful work.
    4. :meth:`activate` — the swap takes effect: the state becomes the
       serving layout (materializing it now if :meth:`prepare` did not).
    5. :meth:`serve` — charge one query against the *currently serving*
       materialized layout, returning the fraction of records accessed.
    6. :meth:`deregister` — the policy evicted the state.  Must be a no-op
       for unknown ids; must not disturb the serving layout even if the
       serving state itself is deregistered (the physical table survives
       until the next swap).
    """

    def register(self, layout: L.Layout) -> None: ...

    def deregister(self, state_id: int) -> None: ...

    def has(self, state_id: int) -> bool: ...

    def get(self, state_id: int) -> L.Layout: ...

    def estimate_costs(self, state_ids: Sequence[int],
                       query: wl.Query) -> Dict[int, float]: ...

    def prepare(self, state_id: int) -> None: ...

    def activate(self, state_id: int) -> None: ...

    @property
    def serving_state(self) -> Optional[int]: ...

    def serve(self, query: wl.Query) -> float: ...


class _RegistryMixin:
    """Shared metadata registry + batched estimation over a StateMatrix.

    The registry mirrors every registered layout's zone maps into a packed
    :class:`StateMatrix` on ``device`` (O(P*C) per register / deregister),
    so per-query estimation is one scan over persistent tensors.  While a
    run's lookahead is open (:meth:`open_lookahead`), the query at its
    cursor is scored a block of queries per scan instead
    (:class:`BlockEstimates`); primed costs still come first.
    """

    _layouts: Dict[int, L.Layout]

    def _init_registry(self, device: torch.device) -> None:
        self._layouts = {}
        self._matrix = StateMatrix(device)
        self._primed: Optional[tuple] = None
        self._primed_idx: Optional[tuple] = None
        self._lookahead: Optional[BlockEstimates] = None
        # Streaming ingest (see repro_torch.engine.ingest): pending delta
        # batches over the growing table, and the device buffer the table
        # grows in.  None until enable_ingest() / the first append.
        self._delta = None
        self._buffer: Optional[torch.Tensor] = None

    def _append_rows(self, rows) -> Tuple[torch.Tensor, int]:
        """Append one batch to the table on its device; returns the batch as
        a device tensor and the row it starts at.

        The table grows in a buffer with spare capacity (doubling when
        full), and ``self.data`` is a view of its filled prefix: an append
        within capacity copies only the batch, and never writes a row an
        earlier view of the table can see.  The caller's own table tensor
        is never written.
        """
        data = self.data
        rows = torch.as_tensor(rows, dtype=torch.float64, device=data.device)
        if rows.ndim != 2 or rows.shape[1] != data.shape[1]:
            raise ValueError(f"an ingest batch must be (N, {data.shape[1]}), "
                             f"got {tuple(rows.shape)}")
        n, add = len(data), len(rows)
        buf = self._buffer
        if buf is None or n + add > len(buf):
            buf = torch.empty((max(n + add, 2 * n), data.shape[1]),
                              dtype=data.dtype, device=data.device)
            buf[:n] = data
            self._buffer = buf
        buf[n:n + add] = rows
        self.data = buf[:n + add]
        return rows, n

    @property
    def delta_log(self):
        """The pending-delta state (None until ``enable_ingest``)."""
        return self._delta

    def open_lookahead(self, queries: Sequence[wl.Query], q_lo: np.ndarray,
                       q_hi: np.ndarray) -> BlockEstimates:
        """Install a run's lookahead over ``queries`` (their stacked (N, C)
        bounds go to the plane's device in one copy); the caller moves its
        ``cursor`` and closes it with :meth:`close_lookahead`."""
        self._lookahead = BlockEstimates(queries, q_lo, q_hi,
                                         self._matrix.device)
        return self._lookahead

    def close_lookahead(self) -> None:
        ahead, self._lookahead = self._lookahead, None
        if ahead is not None:
            ahead.close()

    def _fresh_costs(self, query: wl.Query) -> np.ndarray:
        """Per-slot costs of ``query`` off the plane: its row of a block
        scan when the lookahead covers it, else a per-query scan."""
        ahead = self._lookahead
        if ahead is not None and ahead.covers(query):
            return ahead.costs(self._matrix)
        return self._matrix.estimate(query.lo, query.hi)

    def prime_estimates(self, query: wl.Query, version: int,
                        costs: np.ndarray) -> None:
        """Install precomputed per-slot costs for one upcoming query.

        ``costs`` is a full per-slot vector computed elsewhere (a fleet's
        fused pass), ``version`` the :attr:`StateMatrix.version` it was
        computed against.  :meth:`estimate_costs` consumes it only when the
        *same* query object arrives while the plane is still at that
        version — any state churn in between bumps the version and falls
        back to the exact per-tenant path, so priming can never change
        results.
        """
        self._primed = (query, version, costs)

    def _primed_costs(self, query: wl.Query) -> Optional[np.ndarray]:
        primed = self._primed
        if (primed is not None and primed[0] is query
                and primed[1] == self._matrix.version):
            return primed[2]
        return None

    def _primed_dict(self, costs: np.ndarray,
                     state_ids: Sequence[int]) -> Dict[int, float]:
        """id -> cost dict off a primed per-slot vector, vectorized.

        The slot-index gather is cached on (ids object, plane version);
        ``ndarray.tolist`` yields the same Python floats
        ``float(costs[slot])`` would.
        """
        m = self._matrix
        cache = self._primed_idx
        if (cache is not None and cache[0] is state_ids
                and cache[1] == m.version):
            ids, idx = cache[2], cache[3]
        else:
            ids = list(state_ids)
            idx = np.fromiter((m.slot(s) for s in ids), dtype=np.intp,
                              count=len(ids))
            # Holding a reference to state_ids keeps its id() from being
            # recycled while the cache entry is alive.
            self._primed_idx = (state_ids, m.version, ids, idx)
        return dict(zip(ids, costs.take(idx).tolist()))

    def register(self, layout: L.Layout) -> None:
        self._layouts[layout.layout_id] = layout
        self._matrix.register(layout.layout_id, layout.meta)

    def deregister(self, state_id: int) -> None:
        self._layouts.pop(state_id, None)
        self._matrix.deregister(state_id)

    def has(self, state_id: int) -> bool:
        return state_id in self._layouts

    def get(self, state_id: int) -> L.Layout:
        return self._layouts[state_id]

    @property
    def states(self) -> List[int]:
        return sorted(self._layouts)

    @property
    def state_matrix(self) -> StateMatrix:
        """The packed metadata plane."""
        return self._matrix

    def estimate_costs(self, state_ids: Sequence[int],
                       query: wl.Query) -> Dict[int, float]:
        """Batched metadata-only c(s, q) for every requested state: one scan
        over the persistent StateMatrix plane (or primed costs)."""
        costs = self._primed_costs(query)
        if costs is not None:
            return self._primed_dict(costs, state_ids)
        ids = list(state_ids)
        if not ids:
            return {}
        costs = self._fresh_costs(query)
        slots = self._matrix.slot
        return {s: float(costs[slots(s)]) for s in ids}

    def estimate_vector(self, query: wl.Query) -> np.ndarray:
        """All registered states' c(s, q) as one float64 per-slot vector
        (slot order is :attr:`StateMatrix.state_ids`); primed costs are
        consumed when valid."""
        costs = self._primed_costs(query)
        if costs is not None:
            return costs
        return self._fresh_costs(query)


class InMemoryBackend(_RegistryMixin):
    """Backend over a table held as one (N, C) float64 tensor on a device.

    Materialization computes exact zone maps over the table on its device;
    serving charges the metadata-derived fraction of records accessed.
    The serving layout's *exact* (materialized) zone maps live in the packed
    plane as a shadow state under the reserved id ``SERVING_SHADOW`` (-1),
    so each ``estimate_costs`` call fuses the serve score into the same
    scan and :meth:`serve` is usually a memo lookup — still bit-identical
    to ``eval_cost`` on the serving metadata.  :meth:`serve_block` scores
    whole query blocks for the engine's batched ``run`` fast path.
    """

    #: Reserved StateMatrix id for the materialized serving layout's zone
    #: maps.  Policies must use non-negative state ids.
    SERVING_SHADOW = -1
    #: A primed shadow-slot score is a valid serve memo: the scans are
    #: exact on every device, so the shadow's estimate is the serve cost.
    #: The fleet's batched path installs such scores directly.
    _serve_primable = True

    def __init__(self, data: torch.Tensor):
        if not isinstance(data, torch.Tensor) or data.dtype != torch.float64:
            raise TypeError("InMemoryBackend needs the table as a float64 "
                            "tensor on its device (see repro_torch.data)")
        self.data = data
        self._init_registry(data.device)
        self._serving: Optional[L.Layout] = None
        self._serving_cache: Optional[tuple] = None
        self._serve_memo: Optional[tuple] = None
        self._shadow_slot: Optional[tuple] = None   # (plane version, slot)
        self._migration = None                      # in-flight MigrationPlan
        # The delta-free base zone maps the composed serving state is built
        # from (see enable_ingest); every path is untouched without ingest.
        self._ingest_base: Optional[L.PartitionMetadata] = None

    def prepare(self, state_id: int) -> None:
        # In-memory reorganization is instantaneous; nothing to overlap.
        pass

    @property
    def pending_states(self) -> List[int]:
        """State ids with in-flight physical work (always empty here)."""
        return []

    def _install_serving_meta(self, meta: L.PartitionMetadata) -> None:
        """Swap the physical serving zone maps (layout or hybrid state)."""
        self._serving_cache = (meta.mins.contiguous(), meta.maxs.contiguous(),
                               L.self_rows(meta), max(meta.total_rows, 1))
        self._serve_memo = None
        # Re-registering the shadow fires the StateMatrix listener events,
        # so a mirror keeps scoring this tenant's (possibly hybrid) serving
        # state in the fused pass.
        self._matrix.register(self.SERVING_SHADOW, meta)

    def _install_base_meta(self, meta: L.PartitionMetadata) -> None:
        """Install a delta-free base state, composing pending deltas on top.

        With ingest disabled (or zero pending batches) the composed state
        *is* ``meta`` — the same object — so the serving plane, the shadow
        registration and every downstream estimate are bit-identical to
        the paths without ingest.
        """
        self._ingest_base = meta
        d = self._delta
        self._install_serving_meta(meta if d is None else d.compose(meta))

    def _activate_layout(self, layout: L.Layout) -> None:
        self._serving = layout
        d = self._delta
        if d is not None and d.pending:
            # An atomic (re)materialization rewrites the *grown* table:
            # every pending delta batch is routed in and absorbed.
            layout.true_meta = None
            meta = layout.materialize(self.data)
            d.absorb_up_to(len(self.data))
        else:
            meta = layout.materialize(self.data)
        self._install_base_meta(meta)

    def activate(self, state_id: int) -> None:
        self._activate_layout(self._layouts[state_id])

    # -- streaming ingest (see repro_torch.engine.ingest) ---------------
    def enable_ingest(self):
        """Open the write path: appended rows land as delta partitions."""
        if self._delta is None:
            from .ingest import DeltaLog
            self._delta = DeltaLog(len(self.data))
        return self._delta

    @property
    def ingest_base_meta(self) -> Optional[L.PartitionMetadata]:
        """Zone maps of the clustered base under the composed deltas."""
        return self._ingest_base

    def ingest_rows(self, rows):
        """Append one batch as an unclustered delta partition.

        ``rows`` (host array or tensor) goes to the table's device once.
        The batch is visible to scans immediately: its exact zone maps are
        composed onto the serving state and re-registered through the
        StateMatrix listener events (bumping the plane's version, so no
        estimate scanned before the append is used after it), and an
        attached FleetMatrix keeps scoring this (now delta-bearing) tenant
        in the fused pass.
        """
        d = self._delta
        if d is None:
            raise RuntimeError("enable_ingest() first")
        rows, start = self._append_rows(rows)
        batch = d.append(rows, start)
        # Exact (materialized) zone maps are stale for the grown table;
        # estimated candidate metadata is sample-based and untouched.
        for lay in self._layouts.values():
            lay.true_meta = None
        if self._serving is not None:
            self._serving.true_meta = None
            self._install_serving_meta(d.compose(self._ingest_base))
        return batch

    def delta_source(self):
        """(assignment, meta) of the hybrid delta-bearing source state.

        What the migration planner diffs a compaction (or a drift reorg
        with deltas pending) against: clustered base partitions plus one
        pseudo-partition per delta batch, the assignment an ``(N,)`` int64
        tensor on the table's device.  None with no pending deltas — the
        plain planning path stays bit-identical.
        """
        d = self._delta
        if d is None or not d.pending:
            return None
        base_len = d.clustered_len
        serving = self._serving
        if serving is not None and serving.route is not None:
            base_assign = serving.route(self.data[:base_len]).to(torch.int64)
        else:
            base_assign = torch.zeros(base_len, dtype=torch.int64,
                                      device=self.data.device)
        base = self._ingest_base
        assign = d.source_assignment(base_assign, base.num_partitions,
                                     len(self.data))
        return assign, d.compose(base)

    @property
    def serving_state(self) -> Optional[int]:
        return None if self._serving is None else self._serving.layout_id

    # -- incremental migration (see repro_torch.engine.reorg) -----------
    @property
    def serving_layout(self) -> Optional[L.Layout]:
        """The Layout object behind :attr:`serving_state` (source of an
        in-flight migration)."""
        return self._serving

    @property
    def supports_incremental(self) -> bool:
        """Hybrid serving runs on the packed plane, which every backend of
        the port has."""
        return True

    @property
    def migrating(self) -> bool:
        return self._migration is not None

    def begin_migration(self, plan) -> None:
        """An incremental migration starts; serving is untouched until the
        first completed micro-batch lands via :meth:`apply_migration`."""
        if self._migration is not None:
            raise RuntimeError("a migration is already in flight")
        self._migration = plan
        if self._delta is not None:
            # The plan routed the table as of planning time: those rows
            # (pending deltas included — they are source pseudo-partitions
            # of the plan) now belong to the migration, and its hybrid
            # zone maps track them partition by partition.  Batches
            # appended mid-flight stack as fresh deltas on top.
            self._delta.absorb_up_to(len(plan.target_assignment))

    def apply_migration(self, hybrid_meta: L.PartitionMetadata,
                        newly_done: Sequence[int]) -> None:
        """A micro-batch of moves completed: serve the hybrid state.

        The hybrid zone maps become the physical serving state (and the
        SERVING_SHADOW plane entry), so estimates, serve fusion and block
        serving all score the mixed moved/unmoved partitioning exactly.
        """
        self._install_base_meta(hybrid_meta)

    def complete_migration(self, plan) -> None:
        """The last move landed: snap to the target layout through the
        same path :meth:`activate` takes (bitwise the atomic end state,
        even if the target state was evicted mid-flight)."""
        self._migration = None
        d = self._delta
        if d is not None:
            # The completed target covers exactly the rows the plan
            # routed; mid-flight batches stay pending delta partitions.
            d.absorb_up_to(len(plan.target_assignment))
            self._serving = plan.target
            self._install_base_meta(plan.target_meta)
        else:
            self._activate_layout(plan.target)

    def estimate_costs(self, state_ids: Sequence[int],
                       query: wl.Query) -> Dict[int, float]:
        """Batched metadata-only c(s, q) for every requested state; the
        serving shadow's score rides along and memoizes :meth:`serve`."""
        m = self._matrix
        costs = self._primed_costs(query)
        if costs is None:
            costs = self._fresh_costs(query)
            out = {s: float(costs[m.slot(s)]) for s in state_ids}
        else:
            out = self._primed_dict(costs, state_ids)
        if self.SERVING_SHADOW in m:
            # The kernel is exact, so the shadow's estimate *is* the serve
            # cost: remember it so serve() on this query is a lookup.
            self._serve_memo = (query,
                                float(costs[m.slot(self.SERVING_SHADOW)]))
        return out

    def estimate_vector(self, query: wl.Query) -> np.ndarray:
        """All registered states' c(s, q) as one float64 per-slot vector
        (slot order is :attr:`StateMatrix.state_ids`); primed costs are
        consumed, and the serving shadow's score memoizes :meth:`serve`."""
        m = self._matrix
        primed = self._primed
        version = m.version
        if (primed is not None and primed[0] is query
                and primed[1] == version):
            return primed[2]
        costs = self._fresh_costs(query)
        shadow = self.shadow_slot(version)
        if shadow >= 0:
            self._serve_memo = (query, float(costs[shadow]))
        return costs

    def shadow_slot(self, version: int) -> int:
        """Packed slot of the serving-shadow state (-1 if absent), cached
        per plane version."""
        shadow = self._shadow_slot
        if shadow is None or shadow[0] != version:
            m = self._matrix
            slot = (m.slot(self.SERVING_SHADOW)
                    if self.SERVING_SHADOW in m else -1)
            self._shadow_slot = (version, slot)
            return slot
        return shadow[1]

    def serve(self, query: wl.Query) -> float:
        memo = self._serve_memo
        if memo is not None and memo[0] is query:
            return memo[1]
        mins, maxs, rows, total = self._serving_cache
        acc = compute.masked_overlap(mins, maxs, query.lo, query.hi)
        return float(L.scanned_dot(acc, rows) / total)

    def serve_block(self, q_lo: np.ndarray, q_hi: np.ndarray) -> np.ndarray:
        """Serve a (B, C) block of queries against the current layout.

        Used by ``LayoutEngine.run``'s batched fast path between layout
        swaps: one B x P scan, and each element bit-identical to the
        per-query :meth:`serve`.
        """
        if len(q_lo) == 0:
            return np.zeros(0)
        mins, maxs, rows, total = self._serving_cache
        acc = compute.scan_matrix(q_lo, q_hi, mins, maxs)
        return L.scanned_dot(acc, rows) / total


class DiskBackend(_RegistryMixin):
    """On-disk backend over
    :class:`repro_torch.data.partition_store.PartitionStore`.

    Every materialized layout lives in its own versioned directory under
    ``root``; :meth:`prepare` rewrites the table into a *fresh* directory on
    a background thread while queries keep scanning the old one, and
    :meth:`activate` flips the serving pointer (joining the writer first if
    the Δ-delay elapsed before the rewrite finished).  This gives the
    paper's §VI-D5 semantics for real files: reorganization cost is incurred
    at decision time, the swap is deferred, and serving is never interrupted.

    ``data`` is the table as a float64 tensor on its device: the writer
    routes and gathers it there (on the writer thread, for a background
    rewrite) and copies each partition to the host once.  A rewrite that
    raises is re-raised by :meth:`activate`, so a failed write is never
    served.

    ``durable=True`` logs every manifest mutation — initial write, layout
    swap, delta append, migration micro-batch — to a crash-safe manifest
    WAL (:class:`repro_torch.data.wal.ManifestWAL`, snapshots every
    ``wal_snapshot_every`` records) *before* it takes effect, so
    :meth:`recover_state` replays to a bitwise-identical manifest.
    Streaming ingest (:meth:`enable_ingest`) appends rows to the device
    table and writes each batch as an on-disk delta file.
    """

    def __init__(self, data: torch.Tensor, root: str, compress: bool = True,
                 background: bool = True, durable: bool = False,
                 wal_snapshot_every: int = 64):
        if not isinstance(data, torch.Tensor) or data.dtype != torch.float64:
            raise TypeError("DiskBackend needs the table as a float64 "
                            "tensor on its device (see repro_torch.data)")
        self.data = data
        self.root = root
        self.compress = compress
        self.background = background
        os.makedirs(root, exist_ok=True)
        self._init_registry(data.device)
        self._serving_layout: Optional[L.Layout] = None
        self._serving_store: Optional[PartitionStore] = None
        self._version = 0
        self._lock = threading.Lock()
        self._pending: Dict[int, Tuple[Optional[threading.Thread],
                                       PartitionStore, dict]] = {}
        self.initial_write_seconds = 0.0
        self.reorg_seconds: List[float] = []
        # In-flight incremental migration (see repro_torch.engine.reorg):
        # (plan, partial target store, done mask, hybrid metadata).
        self._migration: Optional[tuple] = None
        # Streaming ingest: pending delta batches are files under deltas/.
        self._delta_dir = os.path.join(root, "deltas")
        #: Crash-safe manifest WAL (``durable=True``): every manifest
        #: mutation is logged *before* it takes effect, with periodic
        #: snapshots, so recovery replays to a bitwise-identical manifest.
        self.wal = None
        if durable:
            from repro_torch.data.wal import ManifestWAL
            self.wal = ManifestWAL(os.path.join(root, "wal"),
                                   snapshot_every=wal_snapshot_every)

    # ------------------------------------------------------------------
    def _new_store(self) -> PartitionStore:
        self._version += 1
        return PartitionStore(os.path.join(self.root,
                                           f"v{self._version:05d}"),
                              device=self.data.device)

    def _save(self):
        return np.savez_compressed if self.compress else np.savez

    def deregister(self, state_id: int) -> None:
        super().deregister(state_id)
        pending = self._pending.pop(state_id, None)
        if pending is None:
            return
        thread, store, entry = pending
        # Never block serving on an in-flight rewrite whose output is being
        # discarded: flag it cancelled and let the writer thread delete its
        # own directory; only clean up here if the write already finished.
        with self._lock:
            entry["cancelled"] = True
            finished = entry["done"] or thread is None
        if finished:
            shutil.rmtree(store.root, ignore_errors=True)

    def prepare(self, state_id: int) -> None:
        if state_id in self._pending or state_id not in self._layouts:
            return
        layout = self._layouts[state_id]
        store = self._new_store()
        entry = {"done": False, "cancelled": False, "error": None}
        # The writer reads the table as it is now: an append grows the
        # table past this view without touching its rows (and cancels the
        # write, whose output would be stale).
        data = self.data
        device = data.device

        def work() -> None:
            try:
                if device.type == "cuda":
                    # The writer thread launches on the table's card.
                    with torch.cuda.device(device):
                        secs = store.write(data, layout,
                                           compress=self.compress)
                else:
                    secs = store.write(data, layout, compress=self.compress)
            except Exception as exc:
                with self._lock:
                    entry["error"] = exc
                    entry["done"] = True
                if not self.background:
                    raise
                return              # activate() re-raises it
            with self._lock:
                entry["done"] = True
                cancelled = entry["cancelled"]
            if cancelled:
                shutil.rmtree(store.root, ignore_errors=True)
            else:
                self.reorg_seconds.append(secs)

        if self.background:
            thread = threading.Thread(target=work, daemon=True)
            thread.start()
        else:
            work()
            thread = None
        self._pending[state_id] = (thread, store, entry)

    def activate(self, state_id: int) -> None:
        layout = self._layouts[state_id]
        pending = self._pending.pop(state_id, None)
        if pending is None:
            store = self._new_store()
            secs = store.write(self.data, layout, compress=self.compress)
            if self._serving_store is None:
                # First materialization: the initial table load, not a reorg.
                self.initial_write_seconds += secs
            else:
                self.reorg_seconds.append(secs)
        else:
            thread, store, entry = pending
            if thread is not None:
                thread.join()
            if entry["error"] is not None:
                shutil.rmtree(store.root, ignore_errors=True)
                raise RuntimeError(
                    f"DiskBackend: the background rewrite of state "
                    f"{state_id} failed") from entry["error"]
        self._log_swap(store)
        old = self._serving_store
        self._serving_store, self._serving_layout = store, layout
        if old is not None:
            shutil.rmtree(old.root, ignore_errors=True)
        self._absorb_deltas()

    def _log_swap(self, store: PartitionStore) -> None:
        """WAL-commit a layout swap *before* the pointer flips: the record
        carries the new store's exact manifest, so replay reconstructs it
        bitwise even if the crash lands mid-flip."""
        if self.wal is None:
            return
        with open(os.path.join(store.root, "manifest.json")) as f:
            manifest = json.load(f)
        op = "init" if self._serving_store is None else "swap"
        self.wal.append({"op": op,
                         "store": os.path.basename(store.root),
                         "manifest": manifest})

    def _absorb_deltas(self) -> None:
        """A full (re)write just routed every pending delta row into the
        new clustered store: retire the delta files."""
        d = self._delta
        if d is None or not d.pending:
            return
        for batch in d.batches:
            os.remove(os.path.join(self._delta_dir,
                                   f"delta_{batch.batch_id:05d}.npz"))
        d.absorb_up_to(len(self.data))

    @property
    def serving_state(self) -> Optional[int]:
        return (None if self._serving_layout is None
                else self._serving_layout.layout_id)

    @property
    def pending_states(self) -> List[int]:
        """State ids with an in-flight (prepared) background rewrite."""
        return sorted(self._pending)

    def materializing(self, state_id: int) -> bool:
        """True while ``state_id``'s background rewrite has not finished.

        Used by fleet schedulers to observe in-flight physical work; a
        state that was never prepared, or whose write completed, is False.
        """
        pending = self._pending.get(state_id)
        if pending is None:
            return False
        _, _, entry = pending
        with self._lock:
            return not entry["done"]

    # -- streaming ingest (see repro_torch.engine.ingest) ---------------
    def enable_ingest(self):
        """Open the write path: appended rows land as on-disk delta files
        (``deltas/delta_*.npz``) that scans read alongside the clustered
        store until the next full (re)write absorbs them."""
        if self._delta is None:
            from .ingest import DeltaLog
            self._delta = DeltaLog(len(self.data))
            os.makedirs(self._delta_dir, exist_ok=True)
        return self._delta

    @property
    def ingest_base_meta(self) -> Optional[L.PartitionMetadata]:
        """Zone maps of the clustered base store (manifest-derived)."""
        if self._serving_store is None:
            return None
        return self._serving_store.metadata()

    def ingest_rows(self, rows):
        """Append one batch as an unclustered on-disk delta partition.

        Commit protocol (crash-safe under ``durable=True``): the delta
        file is written first, then the WAL record — the record is the
        commit point, so a crash between the two leaves an orphaned file
        that replay simply never references.
        """
        d = self._delta
        if d is None:
            raise RuntimeError("enable_ingest() first")
        rows, start = self._append_rows(rows)
        batch = d.append(rows, start)
        fname = f"delta_{batch.batch_id:05d}.npz"
        self._save()(os.path.join(self._delta_dir, fname),
                     rows=rows.cpu().numpy())
        if self.wal is not None:
            self.wal.append({"op": "append_delta",
                             "batch_id": batch.batch_id,
                             "file": fname,
                             "mins": batch.mins.tolist(),
                             "maxs": batch.maxs.tolist(),
                             "rows": batch.rows})
        # Prepared stores were written against the pre-append table: their
        # output is stale.  Cancel them; activation rewrites from scratch.
        for sid in list(self._pending):
            thread, store, entry = self._pending.pop(sid)
            with self._lock:
                entry["cancelled"] = True
                finished = entry["done"] or thread is None
            if finished:
                shutil.rmtree(store.root, ignore_errors=True)
        for lay in self._layouts.values():
            lay.true_meta = None
        return batch

    @staticmethod
    def recover_state(root: str) -> dict:
        """Replay the manifest WAL under ``root`` after a crash.

        Returns the reduced manifest state (serving store + manifest,
        pending delta batches, in-flight migration) — bitwise identical,
        via :func:`repro_torch.data.wal.canonical_manifest`, to the state
        an uninterrupted run would have logged.
        """
        from repro_torch.data.wal import ManifestWAL
        return ManifestWAL(os.path.join(root, "wal")).replay()

    # -- incremental migration (see repro_torch.engine.reorg) -----------
    @property
    def serving_layout(self) -> Optional[L.Layout]:
        """The Layout object behind :attr:`serving_state`."""
        return self._serving_layout

    @property
    def supports_incremental(self) -> bool:
        return True

    @property
    def migrating(self) -> bool:
        return self._migration is not None

    def begin_migration(self, plan) -> None:
        """Open a partial target store; partition files land move by move."""
        if self._migration is not None:
            raise RuntimeError("a migration is already in flight")
        store = self._new_store()
        done = np.zeros(plan.num_target_partitions, dtype=bool)
        self._migration = (plan, store, done, None)
        if self.wal is not None:
            self.wal.append({"op": "migration_begin",
                             "store": os.path.basename(store.root),
                             "target_state": plan.target.layout_id,
                             "num_targets": plan.num_target_partitions})

    def _write_target_partition(self, plan, store: PartitionStore,
                                j: int) -> None:
        self._save()(os.path.join(store.root, f"part_{j:05d}.npz"),
                     rows=plan.target_partition_rows(self.data, j)
                     .cpu().numpy())

    def apply_migration(self, hybrid_meta: L.PartitionMetadata,
                        newly_done: Sequence[int]) -> None:
        """A micro-batch of moves completed: write the moved target
        partitions' files and serve the hybrid state from here on.

        Moved rows physically live in the partial target store; the old
        store's files are left untouched and their moved rows are filtered
        out logically at scan time (rewriting every touched source file
        per micro-batch would re-pay the move many times over — the same
        reasoning the skip-aware ``PartitionStore.reorganize`` applies).
        """
        plan, store, done, _ = self._migration
        for j in newly_done:
            self._write_target_partition(plan, store, j)
        if self.wal is not None:
            # Logged after the files land: a crash before this record
            # replays to the pre-batch done set, and the orphaned partition
            # files are rewritten when the moves re-run.
            self.wal.append({"op": "migration_apply",
                             "done": [int(j) for j in newly_done]})
        done[list(newly_done)] = True
        self._migration = (plan, store, done, hybrid_meta)

    def complete_migration(self, plan) -> None:
        """The last move landed: finish the target store and flip to it.

        Identical partitions (never moved) are copied file-for-file from
        the old store; remaining empty partitions get empty files; the
        manifest is the target's exact metadata.  No full rewrite happens.
        """
        _, store, done, _ = self._migration
        self._migration = None
        meta = plan.target_meta
        for j in range(plan.num_target_partitions):
            if done[j]:
                continue
            src = plan.identical.get(j)
            if src is not None and self._serving_store is not None:
                shutil.copyfile(
                    os.path.join(self._serving_store.root,
                                 f"part_{src:05d}.npz"),
                    os.path.join(store.root, f"part_{j:05d}.npz"))
            else:
                # Only empty target partitions reach here (every non-empty
                # non-identical partition was a planned move).
                self._write_target_partition(plan, store, j)
        mins, maxs = meta.mins.cpu().tolist(), meta.maxs.cpu().tolist()
        write_manifest(store.root, plan.num_target_partitions, mins, maxs,
                       meta.rows_host, plan.target.name)
        if self.wal is not None:
            self.wal.append({"op": "swap",
                             "store": os.path.basename(store.root),
                             "manifest": manifest_dict(
                                 plan.num_target_partitions, mins, maxs,
                                 meta.rows_host, plan.target.name)})
        old = self._serving_store
        self._serving_store, self._serving_layout = store, plan.target
        if old is not None:
            shutil.rmtree(old.root, ignore_errors=True)

    def _serve_hybrid(self, query: wl.Query) -> float:
        """Scan the hybrid state: residual source partitions (moved rows
        filtered out) + moved target partitions, skipped by the hybrid
        zone maps.  ``rows_read`` counts logical hybrid rows, matching the
        metadata cost model the in-memory backend charges."""
        plan, store, done, hybrid_meta = self._migration
        scanned = L.partitions_scanned(hybrid_meta, query.lo, query.hi)
        p_s = plan.num_source_partitions
        rows_read = 0
        for p in np.nonzero(scanned)[0]:
            if p < p_s:
                path = os.path.join(self._serving_store.root,
                                    f"part_{p:05d}.npz")
                # The physical read (scan realism for wall-clock numbers);
                # the *logical* row count comes from the mask alone — no
                # filtered copy is materialized just to be measured.
                with np.load(path) as z:
                    rows_in_file = len(z["rows"])
                moved = plan.source_moved_mask(int(p), done)
                rows_read += rows_in_file - int(moved.sum())
            else:
                j = int(p) - p_s
                with np.load(os.path.join(store.root,
                                          f"part_{j:05d}.npz")) as z:
                    rows_read += len(z["rows"])
        return rows_read / max(len(self.data), 1)

    def _serve_deltas(self, query: wl.Query) -> int:
        """Rows read from pending delta files the query cannot skip (the
        skip test scans the batches' zone maps on the table's device)."""
        d = self._delta
        if d is None or not d.pending:
            return 0
        scanned = compute.scan_matrix(
            query.lo[None], query.hi[None],
            torch.stack([b.mins for b in d.batches]),
            torch.stack([b.maxs for b in d.batches]))[0]
        rows_read = 0
        for batch, hit in zip(d.batches, scanned):
            if hit:
                path = os.path.join(self._delta_dir,
                                    f"delta_{batch.batch_id:05d}.npz")
                with np.load(path) as z:
                    rows_read += len(z["rows"])
        return rows_read

    def serve(self, query: wl.Query) -> float:
        if self._migration is not None and self._migration[3] is not None:
            return self._serve_hybrid(query)
        _, stats = self._serving_store.scan(query)
        return ((stats.rows_read + self._serve_deltas(query))
                / max(len(self.data), 1))

    def close(self) -> None:
        """Join background writers and remove all materialized directories."""
        for state_id in list(self._pending):
            thread, store, entry = self._pending.pop(state_id)
            with self._lock:
                entry["cancelled"] = True
            if thread is not None:
                thread.join()
            shutil.rmtree(store.root, ignore_errors=True)
        if self._migration is not None:
            _, store, _, _ = self._migration
            shutil.rmtree(store.root, ignore_errors=True)
            self._migration = None
        if self._serving_store is not None:
            shutil.rmtree(self._serving_store.root, ignore_errors=True)
            self._serving_store = self._serving_layout = None
        shutil.rmtree(self._delta_dir, ignore_errors=True)
