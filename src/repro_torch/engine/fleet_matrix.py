"""FleetMatrix: one packed decision plane for every tenant in a fleet.

:class:`repro_torch.engine.state_matrix.StateMatrix` keeps one table's
candidate zone maps packed on the device.  A fleet of T tenants would
still pay T separate scans per round of traffic; :class:`FleetMatrix`
stacks every tenant's plane into one ``(T_cap, S_cap, P_cap, C)`` float64
tensor pair on the device and scores *all* tenants' candidate states
against *each tenant's own* query in one launch per frame
(:func:`repro_torch.engine.compute.fleet_scan_matrix`, lane
``"fleet_scan"``) or one launch per pass of frames
(:func:`repro_torch.engine.compute.fused_frames_scan`, lane
``"decision_fused"``, the default).

Maintenance is strictly incremental — the plane is **never rebuilt or
re-uploaded per tick**:

* tenant attach/detach adds/removes one tenant *row* (swap-with-last, like
  a StateMatrix slot);
* per-tenant state add/evict events stream in through a listener installed
  on each attached :class:`StateMatrix` (``StateMatrix._add_listener``),
  replaying the same append / swap-with-last slot algorithm, so fleet slots
  coincide with each tenant's local slots; a registered state's ``(P, C)``
  zone maps, already on the device, are copied into the plane there;
* capacity growth (more tenants, more states, wider partitions) is
  geometric and amortized, on exactly the reference package's schedule.

Bit-identity contract: both kernels compare in float64, so for each
tenant the fused scan restricted to its ``(n, P_cap_local)`` window equals
the booleans its own plane computes — padded slots carry ``[+inf, -inf]``
bounds and query-less tenants ``[-inf, +inf]``, and neither is a special
case.  The bool scan comes back to the host as a C-contiguous
``(B, T_cap, S_cap, P_cap)`` array, the reference's shape exactly, and the
row-weighted reduction runs there through the reference's einsum (rows and
totals stay host numpy) or, for tenants whose plane is not uniform, through
the tenant's own :meth:`StateMatrix.reduce_scanned`.  Estimates are
therefore bit-for-bit the ones the per-tenant loop computes, which is what
lets :meth:`repro_torch.engine.FleetEngine.run_batched` reproduce the
stepwise fleet trace exactly.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import layouts as L
from repro_torch.kernels._backend import resolve_device

from . import compute
from .state_matrix import StateMatrix


class _TenantMirror:
    """Listener bridging one tenant's StateMatrix events into the plane."""

    __slots__ = ("fleet", "tenant_id")

    def __init__(self, fleet: "FleetMatrix", tenant_id: str):
        self.fleet = fleet
        self.tenant_id = tenant_id

    def on_register(self, state_id: int, meta: L.PartitionMetadata) -> None:
        self.fleet._register(self.tenant_id, state_id, meta)

    def on_deregister(self, state_id: int) -> None:
        self.fleet._deregister(self.tenant_id, state_id)


class FleetMatrix:
    """Packed multi-tenant zone-map plane with incremental maintenance.

    ``device`` is where the plane lives (the card by default); every
    attached tenant's StateMatrix must live there too.
    """

    def __init__(self, device: Union[None, str, torch.device] = None,
                 compute_backend: str = "decision_fused",
                 tenant_capacity: int = 4, state_capacity: int = 8):
        self.device = resolve_device(device)
        self.set_compute_backend(compute_backend)
        self._tcap = max(int(tenant_capacity), 1)
        self._scap = max(int(state_capacity), 1)
        self._pcap = 0
        self._c: Optional[int] = None
        self._t = 0                                  # attached tenant rows
        self._tids: List[str] = []                   # row -> tenant id
        self._trows: Dict[str, int] = {}             # tenant id -> row
        self._sms: Dict[str, StateMatrix] = {}       # attached local planes
        self._mirrors: Dict[str, _TenantMirror] = {}
        self._ids: Dict[str, List[int]] = {}         # tenant -> slot -> sid
        self._slots: Dict[str, Dict[int, int]] = {}  # tenant -> sid -> slot
        self._counts: Dict[str, List[int]] = {}      # tenant -> slot -> P_s
        self._mins: Optional[torch.Tensor] = None    # (T_cap,S_cap,P_cap,C)
        self._maxs: Optional[torch.Tensor] = None
        self._rows: Optional[np.ndarray] = None      # (T_cap,S_cap,P_cap) host
        self._totals: Optional[np.ndarray] = None    # (T_cap,S_cap) f64 host
        #: Bumped on every plane mutation (any tenant's register/deregister,
        #: attach, detach); consumers may key caches on it.
        self.version = 0
        #: Dense view of the most recent :meth:`estimate_frames` pass —
        #: ``(batched, {tid: (row, n_states, version, shadow_slot)})`` for
        #: the tenants whose costs came out of the batched (B, T, S)
        #: reduction with a mirrored serving shadow, or None.  Consumers
        #: (the fleet's bulk decide path) read whole per-tenant cost
        #: matrices as ``batched[:, row, :n]`` instead of re-stacking B
        #: per-frame prime vectors; reset at the start of every pass.
        self.last_pass_dense: Optional[tuple] = None

    def set_compute_backend(self, compute_backend: str) -> None:
        """Switch the scoring lane (validated; the plane is shared)."""
        if compute_backend not in compute.BACKENDS:
            raise ValueError(f"unknown compute backend: {compute_backend!r} "
                             f"(expected one of {compute.BACKENDS})")
        self.compute_backend = compute_backend

    # -- introspection --------------------------------------------------
    def __len__(self) -> int:
        return self._t

    def __contains__(self, tenant_id: str) -> bool:
        return tenant_id in self._trows

    @property
    def tenant_ids(self) -> List[str]:
        """Attached tenant ids in row order."""
        return list(self._tids)

    @property
    def num_columns(self) -> Optional[int]:
        return self._c

    @property
    def state_capacity(self) -> int:
        return self._scap

    @property
    def partition_capacity(self) -> int:
        return self._pcap

    def tenant_row(self, tenant_id: str) -> int:
        """Packed row index of an attached tenant (KeyError if unknown)."""
        return self._trows[tenant_id]

    def slot(self, tenant_id: str, state_id: int) -> int:
        """Packed slot of a tenant's state (KeyError if unknown)."""
        return self._slots[tenant_id][state_id]

    def state_ids(self, tenant_id: str) -> List[int]:
        """A tenant's registered state ids in fleet slot order."""
        return list(self._ids[tenant_id])

    # -- allocation -----------------------------------------------------
    def _alloc(self, tcap: int, scap: int, pcap: int) -> None:
        c = self._c
        kw = dict(dtype=torch.float64, device=self.device)
        mins = torch.full((tcap, scap, pcap, c), np.inf, **kw)
        maxs = torch.full((tcap, scap, pcap, c), -np.inf, **kw)
        rows = np.zeros((tcap, scap, pcap))
        totals = np.ones((tcap, scap))
        self._qlo_buf = np.empty((tcap, c))
        self._qhi_buf = np.empty((tcap, c))
        # A freshly-attached tenant row may not exist in the old arrays
        # yet (attach bumps the row count before ensuring capacity).
        t = min(self._t, 0 if self._mins is None else self._mins.shape[0])
        if t and self._mins is not None:
            old_s, old_p = self._scap, self._pcap
            mins[:t, :old_s, :old_p] = self._mins[:t]
            maxs[:t, :old_s, :old_p] = self._maxs[:t]
            rows[:t, :old_s, :old_p] = self._rows[:t]
            totals[:t, :old_s] = self._totals[:t]
        self._mins, self._maxs = mins, maxs
        self._rows, self._totals = rows, totals
        self._tcap, self._scap, self._pcap = tcap, scap, pcap

    def _ensure_capacity(self, t: int, s: int, p: int) -> None:
        if self._c is None:
            raise RuntimeError("column count unknown before first register")
        if (self._mins is None or t > self._tcap or s > self._scap
                or p > self._pcap):
            # Geometric growth on every axis keeps reallocation (an
            # O(plane) copy) amortized O(1) per register; the state axis
            # grows by 1.25x+4 rather than doubling.  The schedule is the
            # reference package's, so the plane's shape — and with it the
            # host reduction's shape — is the same at every step.
            scap = self._scap
            if s > scap:
                scap = max(s, scap + max(scap >> 2, 4))
            self._alloc(max(self._tcap, 2 * self._t, t), scap,
                        max(self._pcap, 2 * self._pcap if p > self._pcap
                            else self._pcap, p))

    # -- tenant attach/detach -------------------------------------------
    def attach(self, tenant_id: str, matrix: StateMatrix) -> None:
        """Mirror one tenant's StateMatrix into the plane, then follow its
        register/deregister events until :meth:`detach`."""
        if tenant_id in self._trows:
            raise ValueError(f"tenant {tenant_id!r} already attached")
        if matrix.device != self.device:
            raise ValueError(f"tenant {tenant_id!r}: its plane is on "
                             f"{matrix.device}, the fleet's on {self.device}")
        if (matrix.num_columns is not None and self._c is not None
                and matrix.num_columns != self._c):
            raise ValueError(
                f"tenant {tenant_id!r}: {matrix.num_columns} columns, "
                f"fleet plane has {self._c}")
        row = self._t
        self._t += 1
        self._tids.append(tenant_id)
        self._trows[tenant_id] = row
        self._sms[tenant_id] = matrix
        self._ids[tenant_id] = []
        self._slots[tenant_id] = {}
        self._counts[tenant_id] = []
        if self._c is None:
            self._c = matrix.num_columns       # may still be None: learned
        if self._mins is not None and row >= self._tcap:
            self._ensure_capacity(self._t, self._scap, self._pcap)
        for sid in matrix.state_ids:           # initial sync, in slot order
            self._register(tenant_id, sid, matrix.metadata(sid))
        mirror = _TenantMirror(self, tenant_id)
        self._mirrors[tenant_id] = mirror
        matrix._add_listener(mirror)
        self.version += 1

    def detach(self, tenant_id: str) -> None:
        """Stop mirroring a tenant and drop its row (swap-with-last).
        Unknown ids are a no-op."""
        row = self._trows.pop(tenant_id, None)
        if row is None:
            return
        self._sms.pop(tenant_id)._remove_listener(
            self._mirrors.pop(tenant_id))
        self._ids.pop(tenant_id)
        self._slots.pop(tenant_id)
        self._counts.pop(tenant_id)
        last = self._t - 1
        if row != last:
            if self._mins is not None:
                self._mins[row] = self._mins[last]
                self._maxs[row] = self._maxs[last]
                self._rows[row] = self._rows[last]
                self._totals[row] = self._totals[last]
            moved = self._tids[last]
            self._tids[row] = moved
            self._trows[moved] = row
        if self._mins is not None:
            # Reset the vacated last row to padding so a future attach
            # starts clean without an O(plane) wipe at attach time.
            self._mins[last] = np.inf
            self._maxs[last] = -np.inf
            self._rows[last] = 0.0
            self._totals[last] = 1.0
        self._tids.pop()
        self._t = last
        self.version += 1

    def detach_all(self) -> None:
        """Detach every tenant (each stops mirroring its StateMatrix)."""
        for tid in list(self._tids):
            self.detach(tid)

    # -- per-state maintenance (O(P*C) per event, on the device) --------
    def _register(self, tid: str, state_id: int,
                  meta: L.PartitionMetadata) -> None:
        if self._c is None:
            self._c = meta.num_columns
        elif meta.num_columns != self._c:
            raise ValueError(
                f"tenant {tid!r} state {state_id}: {meta.num_columns} "
                f"columns, fleet plane has {self._c}")
        p = meta.num_partitions
        ids, slots, counts = self._ids[tid], self._slots[tid], self._counts[tid]
        slot = slots.get(state_id)
        if slot is None:
            slot = len(ids)
            self._ensure_capacity(self._t, slot + 1, p)
            ids.append(state_id)
            slots[state_id] = slot
            counts.append(p)
        else:
            self._ensure_capacity(self._t, slot + 1, p)
            counts[slot] = p
        row = self._trows[tid]
        self._mins[row, slot, :p] = meta.mins
        self._mins[row, slot, p:] = np.inf
        self._maxs[row, slot, :p] = meta.maxs
        self._maxs[row, slot, p:] = -np.inf
        self._rows[row, slot, :p] = meta.rows_host
        self._rows[row, slot, p:] = 0.0
        self._totals[row, slot] = max(meta.total_rows, 1)
        self.version += 1

    def _deregister(self, tid: str, state_id: int) -> None:
        ids, slots, counts = self._ids[tid], self._slots[tid], self._counts[tid]
        slot = slots.pop(state_id, None)
        if slot is None:
            return
        row = self._trows[tid]
        last = len(ids) - 1
        if slot != last:
            self._mins[row, slot] = self._mins[row, last]
            self._maxs[row, slot] = self._maxs[row, last]
            self._rows[row, slot] = self._rows[row, last]
            self._totals[row, slot] = self._totals[row, last]
            moved = ids[last]
            ids[slot] = moved
            slots[moved] = slot
            counts[slot] = counts[last]
        self._mins[row, last] = np.inf
        self._maxs[row, last] = -np.inf
        self._rows[row, last] = 0.0
        self._totals[row, last] = 1.0
        ids.pop()
        counts.pop()
        self.version += 1

    # -- fused scoring --------------------------------------------------
    def _scanned_all(self, q_lo: np.ndarray,
                     q_hi: np.ndarray) -> np.ndarray:
        """(B, T_cap, S_cap, P_cap) host bool fleet scan for (B, T_cap, C)
        per-frame, per-tenant host bounds.

        Detached / beyond-``self._t`` tenant rows and padded slots carry
        padding bounds and dummy unbounded queries, so their lanes compute
        noise that no caller reads — keeping every operand whole is worth
        the few wasted lanes.
        """
        if self.compute_backend == "decision_fused":
            return compute.fused_frames_scan(q_lo, q_hi, self._mins,
                                             self._maxs)
        tcap, n = self._tcap, self._scap * self._pcap
        scanned = compute.fleet_scan_matrix(
            q_lo, q_hi, self._mins.view(tcap, n, self._c),
            self._maxs.view(tcap, n, self._c))
        return scanned.reshape(q_lo.shape[0], tcap, self._scap, self._pcap)

    def estimate_frames(self, frames: Sequence[Sequence[tuple]],
                        want_primes: bool = True,
                        ) -> List[List[Optional[Tuple[int, np.ndarray,
                                                      Optional[float]]]]]:
        """Score a block of *frames* — each at most one pending query per
        tenant — in a single fused pass over the whole plane.

        Each frame is a sequence of ``(tenant_id, q_lo, q_hi)`` triples or
        ``(tenant_id, Query)`` pairs (the fleet's event tuples, accepted
        directly so the hot path never re-materializes them), tenants
        distinct within a frame.  Returns, aligned with the input, either
        ``None`` (tenant unknown or has no registered states yet — caller
        falls back to the per-tenant path) or ``(version, costs, serve)``:
        ``version`` is the tenant's :attr:`StateMatrix.version` at scoring
        time, ``costs`` the float64 per-slot cost vector, bit-identical to
        that tenant's own :meth:`StateMatrix.estimate`, and ``serve`` the
        serving-shadow slot's score as a float (None when no shadow state
        is mirrored).  A tenant whose plane changes between scoring and
        consumption (mid-decision state churn) is expected to be caught by
        the consumer's version check.

        ``want_primes=False`` skips materializing the per-event prime
        tuples (the returned lists are all ``None``) and only publishes
        :attr:`last_pass_dense` — for callers that will consume the pass
        through the bulk decide path and rescore exactly (plane unchanged,
        so bit-identically) in the rare case they cannot.
        """
        b = len(frames)
        self.last_pass_dense = None
        empty: List[List[Optional[tuple]]] = [
            [None] * len(fr) for fr in frames]
        if self._t == 0 or self._mins is None or b == 0:
            return empty
        tcap, c = self._tcap, self._c
        # Tenants without a query in a frame get fully-unbounded dummy
        # bounds: comparisons against +/-inf are identically True, so they
        # cannot perturb any other tenant's slice.
        if self._qlo_buf.shape[0] < b * tcap:
            self._qlo_buf = np.empty((b * tcap, c))
            self._qhi_buf = np.empty((b * tcap, c))
        q_lo = self._qlo_buf[:b * tcap]
        q_hi = self._qhi_buf[:b * tcap]
        q_lo.fill(-np.inf)
        q_hi.fill(np.inf)
        # Per-distinct-tenant facts resolved once per pass, not per event:
        # (row, n, version, uniform-reduce ok, StateMatrix, shadow slot).
        info: Dict[str, Optional[tuple]] = {}
        live: List[Tuple[int, int, tuple]] = []
        flat: List[int] = []
        los: List[np.ndarray] = []
        his: List[np.ndarray] = []
        for k, items in enumerate(frames):
            base = k * tcap
            for j, item in enumerate(items):
                if len(item) == 2:
                    tid, query = item
                    lo, hi = query.lo, query.hi
                else:
                    tid, lo, hi = item
                entry = info.get(tid, False)
                if entry is False:
                    row = self._trows.get(tid)
                    n = len(self._ids[tid]) if row is not None else 0
                    if row is None or n == 0:
                        entry = None
                    else:
                        sm = self._sms[tid]
                        entry = (row, n, sm.version,
                                 len(sm) == n and sm.uniform
                                 and sm.partition_capacity == self._pcap,
                                 sm, self._slots[tid].get(-1))
                    info[tid] = entry
                if entry is None:
                    continue
                flat.append(base + entry[0])
                los.append(lo)
                his.append(hi)
                live.append((k, j, entry))
        if not live:
            return empty
        idx = np.asarray(flat, dtype=np.intp)
        q_lo[idx] = np.stack(los)
        q_hi[idx] = np.stack(his)
        scanned = self._scanned_all(q_lo.reshape(b, tcap, c),
                                    q_hi.reshape(b, tcap, c))
        batched: Optional[np.ndarray] = None
        out = empty
        if not want_primes:
            # Dense-only pass: one batched reduction, no per-event tuples.
            if any(entry[3] for _, _, entry in live):
                batched = (np.einsum("btsp,tsp->bts", scanned,
                                     self._rows) / self._totals[None])
                self.last_pass_dense = (batched, {
                    tid: (entry[0], entry[1], entry[2], entry[5])
                    for tid, entry in info.items()
                    if entry is not None and entry[3]
                    and entry[5] is not None})
            return out
        for k, j, (row, n, version, fused_ok, sm, shadow) in live:
            if fused_ok:
                # Equal reduce width and contiguity on both paths: the
                # batched (B, T, S, P) einsum accumulates each output
                # element exactly like the tenant's own (n, P) einsum, so
                # one fused reduction covers every such tenant bit-exactly.
                # (Unequal widths would change numpy's accumulator grouping
                # — those tenants take the per-tenant reduction below.)
                if batched is None:
                    batched = (np.einsum("btsp,tsp->bts", scanned,
                                         self._rows) / self._totals[None])
                costs = batched[k, row, :n]
            elif len(sm) == n:
                costs = sm.reduce_scanned(np.ascontiguousarray(
                    scanned[k, row, :n, :sm.partition_capacity]))
            else:
                continue            # plane out of sync mid-churn: fall back
            # The serving-shadow slot (state id -1), when mirrored, rides
            # along as a ready-made serve score: the scan is exact, so it
            # is the serve cost.
            out[k][j] = (version, costs,
                         float(costs[shadow]) if shadow is not None else None)
        if batched is not None:
            dense_info = {
                tid: (entry[0], entry[1], entry[2], entry[5])
                for tid, entry in info.items()
                if entry is not None and entry[3] and entry[5] is not None}
            self.last_pass_dense = (batched, dense_info)
        return out

    def estimate_frame(self, items: Sequence[Tuple[str, np.ndarray,
                                                   np.ndarray]],
                       ) -> List[Optional[Tuple[int, np.ndarray,
                                                Optional[float]]]]:
        """Single-frame convenience wrapper over :meth:`estimate_frames`."""
        return self.estimate_frames([items])[0]
