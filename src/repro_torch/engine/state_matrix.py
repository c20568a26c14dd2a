"""StateMatrix: the incrementally-maintained packed metadata plane.

OREO's decision loop is metadata-only: every query is scored against every
candidate layout's zone maps.  :class:`StateMatrix` keeps them packed and
*persistent* on the device — padded ``(S_cap, P_cap, C)`` float64
``mins``/``maxs`` plus id <-> slot maps — updated in O(P*C) on
:meth:`register` / :meth:`deregister` instead of rebuilt per query.

Scoring: the ``(n * P_cap, C)`` view of the plane goes to the scan kernel
(:func:`repro_torch.engine.compute.masked_overlap`) without a copy; padding
partitions hold [+inf, -inf] bounds and are never scanned.  The
``(n, P_cap)`` bool scan matrix comes back to the host, where the
row-weighted reduction runs through the same numpy einsum as the reference
package (the row counts live on the host for that), so estimates are
bit-identical to ``eval_cost_states`` and per-state ``eval_cost``.

Block estimates: :meth:`StateMatrix.scan_block` scores a block of queries
against the plane in one launch, and :class:`BlockEstimates` (a run's
lookahead, opened by ``LayoutEngine.run``) hands out its rows one query at
a time while the plane stays at the version the block was scanned at.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import layouts as L

from . import compute


class StateMatrix:
    """Persistent packed zone maps for all registered layout states."""

    def __init__(self, device: torch.device, state_capacity: int = 8):
        self.device = torch.device(device)
        if self.device.type not in compute.DEVICES:
            raise ValueError(f"unsupported device: {self.device}")
        self._scap = max(int(state_capacity), 1)
        self._pcap = 0
        self._c: Optional[int] = None
        self._n = 0
        self._ids: List[int] = []              # slot -> state id
        self._slots: Dict[int, int] = {}       # state id -> slot
        self._counts: List[int] = []           # slot -> partition count
        self._totals: List[int] = []           # slot -> max(total_rows, 1)
        self._rows_exact: List[np.ndarray] = []  # slot -> contiguous (P_s,) f64
        self._mins: Optional[torch.Tensor] = None    # (S_cap, P_cap, C) device
        self._maxs: Optional[torch.Tensor] = None
        self._rows: Optional[np.ndarray] = None      # (S_cap, P_cap) f64 host
        self._totals_arr: Optional[np.ndarray] = None  # (S_cap,) f64 host
        self._uniform = True    # all counts == P_cap -> batched reduction
        #: Bumped on every register/deregister; consumers may key caches on it.
        self.version = 0
        #: Mirror hooks: each listener's ``on_register(state_id, meta)`` /
        #: ``on_deregister(state_id)`` fires *after* the plane update, in the
        #: same order the plane saw it, so a mirror replaying the events with
        #: the same swap-with-last algorithm assigns identical slots.
        self._listeners: List = []

    def _add_listener(self, listener) -> None:
        self._listeners.append(listener)

    def _remove_listener(self, listener) -> None:
        self._listeners.remove(listener)

    def add_listener(self, listener) -> None:
        """Deprecated alias of the internal ``_add_listener`` hook."""
        warnings.warn("StateMatrix listener plumbing is internal mirror "
                      "machinery; add_listener is now _add_listener",
                      DeprecationWarning, stacklevel=2)
        self._add_listener(listener)

    def remove_listener(self, listener) -> None:
        """Deprecated alias of the internal ``_remove_listener`` hook."""
        warnings.warn("StateMatrix listener plumbing is internal mirror "
                      "machinery; remove_listener is now _remove_listener",
                      DeprecationWarning, stacklevel=2)
        self._remove_listener(listener)

    # -- introspection --------------------------------------------------
    def __len__(self) -> int:
        return self._n

    def __contains__(self, state_id: int) -> bool:
        return state_id in self._slots

    @property
    def state_ids(self) -> List[int]:
        """Registered state ids in slot order."""
        return list(self._ids)

    @property
    def num_columns(self) -> Optional[int]:
        return self._c

    @property
    def partition_capacity(self) -> int:
        return self._pcap

    @property
    def uniform(self) -> bool:
        """True when every registered state fills the full partition width,
        i.e. :meth:`estimate` reduces via the batched einsum path."""
        return self._uniform

    def slot(self, state_id: int) -> int:
        """Packed slot index of a registered state (KeyError if unknown)."""
        return self._slots[state_id]

    def metadata(self, state_id: int) -> L.PartitionMetadata:
        """The registered state's exact zone maps (views into the plane)."""
        slot = self._slots[state_id]
        p = self._counts[slot]
        rows = self._rows[slot, :p].copy()
        return L.PartitionMetadata(
            mins=self._mins[slot, :p], maxs=self._maxs[slot, :p],
            rows=torch.from_numpy(rows).to(self.device), rows_host=rows)

    # -- allocation -----------------------------------------------------
    def _alloc(self, scap: int, pcap: int) -> None:
        c = self._c
        kw = dict(dtype=torch.float64, device=self.device)
        mins = torch.full((scap, pcap, c), np.inf, **kw)
        maxs = torch.full((scap, pcap, c), -np.inf, **kw)
        rows = np.zeros((scap, pcap))
        totals = np.ones(scap)
        n = self._n
        if n and self._mins is not None:
            old_p = self._pcap
            mins[:n, :old_p] = self._mins[:n]
            maxs[:n, :old_p] = self._maxs[:n]
            rows[:n, :old_p] = self._rows[:n]
            totals[:n] = self._totals_arr[:n]
        self._mins, self._maxs = mins, maxs
        self._rows, self._totals_arr = rows, totals
        self._scap, self._pcap = scap, pcap

    def _refresh_uniform(self) -> None:
        self._uniform = all(p == self._pcap for p in self._counts)

    # -- maintenance (O(P*C) per call) ----------------------------------
    def register(self, state_id: int, meta: L.PartitionMetadata) -> None:
        """Add (or overwrite) one state's zone maps in the packed plane."""
        if self._c is None:
            self._c = meta.num_columns
        elif meta.num_columns != self._c:
            raise ValueError(
                f"state {state_id}: {meta.num_columns} columns, plane has "
                f"{self._c}")
        p = meta.num_partitions
        slot = self._slots.get(state_id)
        if slot is None:
            if self._mins is None or self._n == self._scap or p > self._pcap:
                self._alloc(max(self._scap, 2 * self._n, 1),
                            max(self._pcap, p))
            slot = self._n
            self._n += 1
            self._ids.append(state_id)
            self._slots[state_id] = slot
            self._counts.append(p)
            self._totals.append(1)
            self._rows_exact.append(np.zeros(0))
        elif p > self._pcap:
            self._alloc(self._scap, p)
        self._mins[slot, :p] = meta.mins
        self._mins[slot, p:] = np.inf
        self._maxs[slot, :p] = meta.maxs
        self._maxs[slot, p:] = -np.inf
        self._rows[slot, :p] = meta.rows_host
        self._rows[slot, p:] = 0.0
        total = max(meta.total_rows, 1)
        self._counts[slot] = p
        self._totals[slot] = total
        self._totals_arr[slot] = total
        self._rows_exact[slot] = L.self_rows(meta)
        self._refresh_uniform()
        self.version += 1
        for listener in self._listeners:
            listener.on_register(state_id, meta)

    def deregister(self, state_id: int) -> None:
        """Drop one state; the last slot is swapped into the hole (O(P*C)).
        Unknown ids are a no-op."""
        slot = self._slots.pop(state_id, None)
        if slot is None:
            return
        last = self._n - 1
        if slot != last:
            self._mins[slot] = self._mins[last]
            self._maxs[slot] = self._maxs[last]
            self._rows[slot] = self._rows[last]
            self._totals_arr[slot] = self._totals_arr[last]
            moved = self._ids[last]
            self._ids[slot] = moved
            self._slots[moved] = slot
            self._counts[slot] = self._counts[last]
            self._totals[slot] = self._totals[last]
            self._rows_exact[slot] = self._rows_exact[last]
        self._ids.pop()
        self._counts.pop()
        self._totals.pop()
        self._rows_exact.pop()
        self._n = last
        # Wipe the vacated slot back to the identity fill values.  Every
        # reader slices [:n], so stale bounds would be latent — but a later
        # register that reuses the slot for a *narrower* state relies on
        # register() overwriting [p:] tails, and keeping the plane identical
        # under register/deregister churn keeps snapshots byte-comparable.
        self._mins[last] = np.inf
        self._maxs[last] = -np.inf
        self._rows[last] = 0.0
        self._totals_arr[last] = 1.0
        self._refresh_uniform()
        self.version += 1
        for listener in self._listeners:
            listener.on_deregister(state_id)

    # -- scoring --------------------------------------------------------
    def _scanned(self, q_lo: np.ndarray, q_hi: np.ndarray) -> np.ndarray:
        """(n, P_cap) host bool scan matrix over all registered states: the
        plane's ``(n * P_cap, C)`` view against one query, in one launch."""
        n = self._n
        return compute.masked_overlap(self._mins[:n], self._maxs[:n],
                                      q_lo, q_hi)

    def scan_block(self, q_lo: torch.Tensor, q_hi: torch.Tensor) -> np.ndarray:
        """(B, n, P_cap) host bool scan of a block of queries: (B, C) bounds
        on the plane's device (read in place) against the plane's
        ``(n * P_cap, C)`` view, in one launch and one copy back.  Each
        row is C-contiguous, as :meth:`reduce_scanned` needs."""
        n = self._n
        return compute.block_overlap(self._mins[:n], self._maxs[:n],
                                     q_lo, q_hi)

    def reduce_scanned(self, scanned: np.ndarray) -> np.ndarray:
        """Row-weighted reduction of an (n, P_cap) scan matrix to (n,) costs.

        The single reduction behind :meth:`estimate`, on the host.
        ``scanned`` must be C-contiguous, exactly as :meth:`_scanned` emits.
        """
        n = self._n
        if self._uniform:
            # All states fill the full partition width: one batched einsum
            # (same contiguous kernel as scanned_dot, so still bit-exact).
            return (np.einsum("sp,sp->s", scanned, self._rows[:n])
                    / self._totals_arr[:n])
        out = np.empty(n)
        for s in range(n):
            out[s] = (L.scanned_dot(scanned[s, :self._counts[s]],
                                    self._rows_exact[s]) / self._totals[s])
        return out

    def estimate(self, q_lo: np.ndarray, q_hi: np.ndarray) -> np.ndarray:
        """Service cost c(s, q) of one query under every registered state.

        Returns float64 (n,) in slot order — bit-identical to
        ``eval_cost_states`` / per-state ``eval_cost`` over the same
        metadata.
        """
        if self._n == 0:
            return np.zeros(0)
        return self.reduce_scanned(self._scanned(q_lo, q_hi))

    def estimate_costs(self, state_ids: Sequence[int], q_lo: np.ndarray,
                       q_hi: np.ndarray) -> Dict[int, float]:
        """Per-id costs for the requested states (scored all at once)."""
        ids = list(state_ids)
        if not ids:
            return {}
        costs = self.estimate(q_lo, q_hi)
        slots = self._slots
        return {s: float(costs[slots[s]]) for s in ids}


class BlockEstimates:
    """A run's lookahead: its queries' estimates scanned a block at a time.

    Holds the stream's queries and their stacked bounds, copied to the
    plane's device once.  The engine moves :attr:`cursor` to the query it
    is deciding; :meth:`costs` then gives that query's per-slot costs from
    the cached block when the block was scanned at the plane's current
    :attr:`StateMatrix.version`, and otherwise scans a new block of
    :attr:`rows` queries from the cursor on against the current plane.
    Every register and deregister bumps the version, so a row scanned
    against an older plane is never consumed.  Each row goes through
    :meth:`StateMatrix.reduce_scanned`, so its costs are bit-identical to
    :meth:`StateMatrix.estimate` on that query.
    """

    #: Queries per block scan.  A plane change discards the rest of the
    #: block (a candidate lands every ``gen_every`` = 100 queries under
    #: OREO and Regret; MTS Optimal's plane changes only at its moves);
    #: ``chip_smoke.py`` measures 64 and 1,024 beside it on OREO's stream.
    rows = 256

    def __init__(self, queries: Sequence, q_lo: np.ndarray, q_hi: np.ndarray,
                 device: torch.device):
        self.queries = queries
        bounds = torch.as_tensor(np.stack([q_lo, q_hi]), dtype=torch.float64,
                                 device=device)
        self._lo, self._hi = bounds[0], bounds[1]
        #: Position in :attr:`queries` of the query being decided.
        self.cursor = 0
        self._block: Optional[tuple] = None    # (start, version, scan)
        self._used = 0                         # distinct rows consumed
        self._last = -1
        #: Block scans made, and scanned rows never consumed.
        self.blocks = 0
        self.rows_discarded = 0

    def covers(self, query) -> bool:
        """True when ``query`` is the query at the cursor."""
        k = self.cursor
        return k < len(self.queries) and self.queries[k] is query

    def _drop(self) -> None:
        if self._block is not None:
            self.rows_discarded += len(self._block[2]) - self._used
            self._block = None

    def costs(self, matrix: StateMatrix) -> np.ndarray:
        """Per-slot costs of the query at the cursor, in slot order."""
        k = self.cursor
        block = self._block
        if (block is not None and block[1] == matrix.version
                and block[0] <= k < block[0] + len(block[2])):
            scan = block[2][k - block[0]]
        else:
            self._drop()
            if len(matrix) == 0:
                return np.zeros(0)
            stop = min(k + self.rows, len(self.queries))
            scan = matrix.scan_block(self._lo[k:stop], self._hi[k:stop])
            self._block = (k, matrix.version, scan)
            self.blocks += 1
            self._used, self._last = 0, -1
            scan = scan[0]
        if k != self._last:
            self._used += 1
            self._last = k
        return matrix.reduce_scanned(scan)

    def close(self) -> None:
        """Count the last block's unconsumed rows and release it."""
        self._drop()
