"""Crash-safe manifest write-ahead log for on-disk partition stores.

A :class:`ManifestWAL` makes the *metadata* side of a store durable: every
mutation of the logical manifest state — the initial table write, a delta
batch landing from streaming ingest, an incremental-migration micro-batch,
a layout swap — is appended to ``log.jsonl`` **before** the mutation is
considered applied, and a periodic ``snapshot.json`` bounds replay work.

The manifest state is a plain JSON dict and recovery is a *pure left fold*
over the logged records (:func:`apply_record`), which gives the two
properties the crash tests pin down:

* **idempotent / crash-point-invariant replay** — for any prefix of the
  log, replaying the prefix and then continuing with the remaining
  records yields a state bitwise equal (via :func:`canonical_manifest`)
  to the uninterrupted fold, so it never matters where the crash landed;
* **torn-tail tolerance** — a crash mid-append leaves at most one
  incomplete final line, which replay discards (every complete record was
  durably applied before the mutation it describes took effect).

Snapshots are written atomically (tmp file + rename) and record how many
log records they already include (``applied``), so a crash between the
snapshot rename and any subsequent append cannot double-apply records.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Tuple

#: The empty manifest state every fold starts from.
INITIAL_STATE: Dict = {"serving": None, "manifest": None, "deltas": [],
                       "migration": None}


def _fresh_state() -> Dict:
    return json.loads(json.dumps(INITIAL_STATE))


def apply_record(state: Dict, record: Dict) -> Dict:
    """Pure reducer: one logged record folded into the manifest state.

    Ops:

    * ``init`` / ``swap`` — a store became the serving table (initial
      write, atomic reorg, or incremental-migration completion): install
      its manifest, clear absorbed deltas and any in-flight migration.
    * ``append_delta`` — a streaming-ingest batch landed as an
      unclustered delta partition (exact zone maps in the record).
    * ``migration_begin`` / ``migration_apply`` — an incremental
      migration opened a partial target store / completed a micro-batch
      of target partitions.
    * ``snapshot_marker`` — no-op (kept for log readability).
    """
    state = dict(state)
    op = record.get("op")
    if op in ("init", "swap"):
        state["serving"] = record.get("store")
        state["manifest"] = record["manifest"]
        state["deltas"] = []
        state["migration"] = None
    elif op == "append_delta":
        state["deltas"] = list(state["deltas"]) + [{
            "batch_id": record["batch_id"],
            "file": record.get("file"),
            "mins": record["mins"],
            "maxs": record["maxs"],
            "rows": record["rows"],
        }]
    elif op == "migration_begin":
        state["migration"] = {"store": record.get("store"),
                              "target_state": record.get("target_state"),
                              "num_targets": record.get("num_targets"),
                              "done": []}
    elif op == "migration_apply":
        mig = dict(state["migration"] or {"done": []})
        mig["done"] = sorted(set(mig.get("done", []))
                             | set(record.get("done", [])))
        state["migration"] = mig
    elif op == "snapshot_marker":
        pass
    else:
        raise ValueError(f"unknown WAL op: {op!r}")
    return state


def canonical_manifest(state: Dict) -> bytes:
    """Canonical byte serialization of a manifest state.

    Two states are *the same manifest* iff their canonical bytes are
    equal — the bitwise-identity the crash-injection tests assert.
    """
    return json.dumps(state, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


class ManifestWAL:
    """Append-only JSONL log + atomic snapshots under one directory."""

    LOG = "log.jsonl"
    SNAPSHOT = "snapshot.json"

    def __init__(self, root: str, snapshot_every: int = 64,
                 sync: bool = False):
        self.root = root
        self.snapshot_every = max(int(snapshot_every), 1)
        self.sync = sync
        os.makedirs(root, exist_ok=True)
        # Reclaim a torn snapshot tmp left by a crash mid-snapshot.
        tmp = os.path.join(root, self.SNAPSHOT + ".tmp")
        if os.path.exists(tmp):
            os.remove(tmp)
        self._log_path = os.path.join(root, self.LOG)
        self._records_since_snapshot = 0

    # -- writing -------------------------------------------------------
    def append(self, record: Dict) -> None:
        """Durably log one record (the mutation may only proceed after)."""
        line = json.dumps(record, sort_keys=True) + "\n"
        with open(self._log_path, "a") as f:
            f.write(line)
            f.flush()
            if self.sync:
                os.fsync(f.fileno())
        self._records_since_snapshot += 1
        if self._records_since_snapshot >= self.snapshot_every:
            self.snapshot(self.replay())

    def snapshot(self, state: Dict) -> None:
        """Atomically persist ``state`` as the new replay starting point."""
        applied = len(self.records())
        tmp = os.path.join(self.root, self.SNAPSHOT + ".tmp")
        with open(tmp, "w") as f:
            json.dump({"applied": applied, "state": state}, f,
                      sort_keys=True)
            f.flush()
            if self.sync:
                os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.root, self.SNAPSHOT))
        self._records_since_snapshot = 0

    # -- reading -------------------------------------------------------
    def records(self) -> List[Dict]:
        """Every complete logged record, oldest first (torn tail dropped)."""
        if not os.path.exists(self._log_path):
            return []
        out: List[Dict] = []
        with open(self._log_path) as f:
            for line in f:
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    break           # torn tail from a crash mid-append
        return out

    def _snapshot_point(self) -> Tuple[int, Dict]:
        path = os.path.join(self.root, self.SNAPSHOT)
        if not os.path.exists(path):
            return 0, _fresh_state()
        with open(path) as f:
            snap = json.load(f)
        return int(snap["applied"]), snap["state"]

    def replay(self, apply_fn: Optional[Callable[[Dict, Dict], Dict]] = None,
               ) -> Dict:
        """Fold snapshot + remaining log records into the manifest state."""
        apply_fn = apply_fn or apply_record
        applied, state = self._snapshot_point()
        for record in self.records()[applied:]:
            state = apply_fn(state, record)
        return state


def replay_records(records: List[Dict],
                   state: Optional[Dict] = None) -> Dict:
    """Pure fold over an in-memory record list (the property-test oracle)."""
    out = _fresh_state() if state is None else state
    for record in records:
        out = apply_record(out, record)
    return out


__all__ = ["INITIAL_STATE", "ManifestWAL", "apply_record",
           "canonical_manifest", "replay_records"]
