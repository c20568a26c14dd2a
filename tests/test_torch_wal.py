"""The port's crash-safe manifest WAL held against the JAX package's, on
the CPU.

Every case of ``tests/test_wal.py`` runs on the port's
:mod:`repro_torch.data.wal` and must give the bytes ``repro.data.wal``
gives: record lines, snapshots and ``canonical_manifest`` of every
replayed state.  The reference's Hypothesis case is a seeded sweep here,
so the count of cases never varies between runs.  Across packages: a WAL
written by either package's durable ``DiskBackend`` (ingest, compactions,
swaps) replays in the other to equal ``canonical_manifest`` bytes, and
one package can go on appending to a log the other wrote.
"""
import json
import os

import numpy as np
import pytest
import torch

import repro.core as rc
import repro.engine as re_
from repro.core import layout_manager as rlm
from repro.data import wal as rwal

import repro_torch.core as tc
import repro_torch.engine as te
from repro_torch.core import layout_manager as tlm
from repro_torch.data import wal as twal
from repro_torch.data.wal import (INITIAL_STATE, ManifestWAL, apply_record,
                                  canonical_manifest, replay_records)

PKGS = {"ref": (rc, re_, rlm), "port": (tc, te, tlm)}
WALS = {"ref": rwal, "port": twal}


def _manifest(k, p):
    return {"num_partitions": p,
            "mins": [[float(k)]] * p, "maxs": [[float(k + 1)]] * p,
            "rows": [1] * p, "layout": f"L{k}"}


def _random_records(rng, n):
    """A plausible mutation history: swaps, deltas, migrations."""
    records = []
    batch_id = 0
    for k in range(n):
        roll = rng.integers(0, 4)
        if roll == 0:
            records.append({"op": "init" if not records else "swap",
                            "store": f"v{k:05d}",
                            "manifest": _manifest(k, int(rng.integers(1, 4)))})
        elif roll == 1:
            records.append({"op": "append_delta", "batch_id": batch_id,
                            "file": f"delta_{batch_id:05d}.npz",
                            "mins": [float(rng.integers(0, 5))],
                            "maxs": [float(rng.integers(5, 10))],
                            "rows": int(rng.integers(1, 50))})
            batch_id += 1
        elif roll == 2:
            records.append({"op": "migration_begin", "store": f"m{k:05d}",
                            "target_state": int(rng.integers(0, 6)),
                            "num_targets": int(rng.integers(1, 8))})
        else:
            records.append({"op": "migration_apply",
                            "done": [int(j) for j in
                                     rng.integers(0, 8,
                                                  int(rng.integers(1, 4)))]})
    return records


def same_fold(records):
    """The port's fold of ``records``, asserted equal to the reference's."""
    got = canonical_manifest(replay_records(records))
    assert got == rwal.canonical_manifest(rwal.replay_records(records))
    return got


def dir_bytes(root):
    out = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as f:
            out[name] = f.read()
    return out


# ---------------------------------------------------------------------------
# Reducer semantics
# ---------------------------------------------------------------------------

def test_apply_record_is_pure():
    assert INITIAL_STATE == rwal.INITIAL_STATE
    state = dict(INITIAL_STATE)
    before = canonical_manifest(state)
    record = {"op": "append_delta", "batch_id": 0, "file": "f",
              "mins": [0.0], "maxs": [1.0], "rows": 3}
    after = apply_record(state, record)
    assert canonical_manifest(state) == before      # input untouched
    assert (canonical_manifest(after)
            == rwal.canonical_manifest(rwal.apply_record(dict(state),
                                                         record)))


def test_swap_clears_deltas_and_migration():
    records = [
        {"op": "init", "store": "v1", "manifest": _manifest(0, 2)},
        {"op": "append_delta", "batch_id": 0, "file": "d0",
         "mins": [0.0], "maxs": [1.0], "rows": 5},
        {"op": "migration_begin", "store": "v2", "target_state": 3,
         "num_targets": 4},
        {"op": "migration_apply", "done": [1, 2]},
        {"op": "swap", "store": "v2", "manifest": _manifest(1, 4)},
    ]
    state = replay_records(records)
    assert state["serving"] == "v2"
    assert state["deltas"] == [] and state["migration"] is None
    mid = replay_records(records[:4])
    assert [d["batch_id"] for d in mid["deltas"]] == [0]
    assert mid["migration"]["done"] == [1, 2]
    for cut in range(len(records) + 1):
        same_fold(records[:cut])


def test_migration_apply_accumulates_sorted_union():
    records = [
        {"op": "migration_begin", "store": "m", "target_state": 0,
         "num_targets": 8},
        {"op": "migration_apply", "done": [5, 2]},
        {"op": "migration_apply", "done": [2, 7]},
    ]
    assert replay_records(records)["migration"]["done"] == [2, 5, 7]
    same_fold(records)


def test_unknown_op_raises():
    with pytest.raises(ValueError, match="unknown WAL op"):
        apply_record(dict(INITIAL_STATE), {"op": "frobnicate"})


# ---------------------------------------------------------------------------
# File-level WAL
# ---------------------------------------------------------------------------

def test_wal_roundtrip_matches_pure_fold(tmp_path):
    records = _random_records(np.random.default_rng(0), 40)
    for pkg, mod in WALS.items():
        wal = mod.ManifestWAL(str(tmp_path / pkg), snapshot_every=7)
        for r in records:
            wal.append(r)
    oracle = same_fold(records)
    assert canonical_manifest(ManifestWAL(str(tmp_path / "port"),
                                          snapshot_every=7).replay()) == oracle
    # the two logs and snapshots are the same bytes
    assert dir_bytes(tmp_path / "port") == dir_bytes(tmp_path / "ref")


def test_wal_snapshot_bounds_replay(tmp_path):
    wal = ManifestWAL(str(tmp_path / "wal"), snapshot_every=5)
    records = _random_records(np.random.default_rng(1), 23)
    for r in records:
        wal.append(r)
    assert os.path.exists(str(tmp_path / "wal" / ManifestWAL.SNAPSHOT))
    applied, snap_state = wal._snapshot_point()
    assert applied >= 20                    # 4 snapshots happened
    assert canonical_manifest(wal.replay()) == same_fold(records)
    assert canonical_manifest(snap_state) == same_fold(records[:applied])
    ref = rwal.ManifestWAL(str(tmp_path / "wal"), snapshot_every=5)
    assert ref._snapshot_point()[0] == applied


def test_wal_drops_torn_tail(tmp_path):
    wal = ManifestWAL(str(tmp_path / "wal"), snapshot_every=1000)
    records = _random_records(np.random.default_rng(2), 10)
    for r in records:
        wal.append(r)
    with open(wal._log_path, "a") as f:
        f.write('{"op": "swap", "store": "vXX", "manif')   # crash mid-append
    reopened = ManifestWAL(str(tmp_path / "wal"), snapshot_every=1000)
    assert len(reopened.records()) == 10
    assert canonical_manifest(reopened.replay()) == same_fold(records)
    ref = rwal.ManifestWAL(str(tmp_path / "wal"), snapshot_every=1000)
    assert ref.records() == reopened.records()


def test_wal_removes_torn_snapshot_tmp(tmp_path):
    root = tmp_path / "wal"
    root.mkdir()
    torn = root / (ManifestWAL.SNAPSHOT + ".tmp")
    torn.write_text('{"applied": 3, "sta')          # crash mid-snapshot
    wal = ManifestWAL(str(root))
    assert not torn.exists()
    assert canonical_manifest(wal.replay()) == canonical_manifest(
        json.loads(json.dumps(INITIAL_STATE)))


# ---------------------------------------------------------------------------
# Replay is idempotent and crash-point-invariant
# ---------------------------------------------------------------------------

def _crash_then_continue(root, records, cut, snapshot_every):
    """Write a prefix, 'crash' (drop the handle), recover by replaying,
    then continue appending through the recovered WAL.  Returns the final
    replayed state's canonical bytes."""
    wal = ManifestWAL(root, snapshot_every=snapshot_every)
    for r in records[:cut]:
        wal.append(r)
    del wal                                         # the crash
    recovered = ManifestWAL(root, snapshot_every=snapshot_every)
    mid = recovered.replay()
    assert canonical_manifest(recovered.replay()) == canonical_manifest(mid)
    assert canonical_manifest(mid) == same_fold(records[:cut])
    for r in records[cut:]:
        recovered.append(r)
    return canonical_manifest(recovered.replay())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_replay_crash_point_invariant_sweep(tmp_path, seed):
    """Every crash point of a random history replays-then-continues to the
    uninterrupted fold, bitwise, across snapshot cadences."""
    rng = np.random.default_rng(100 + seed)
    records = _random_records(rng, 25)
    oracle = same_fold(records)
    for snapshot_every in (1, 3, 1000):
        for cut in range(len(records) + 1):
            root = str(tmp_path / f"wal_{snapshot_every}_{cut}")
            assert _crash_then_continue(root, records, cut,
                                        snapshot_every) == oracle


def test_replay_crash_point_invariant_seeded_histories(tmp_path):
    """The reference's Hypothesis property over 30 seeded draws of the
    same ranges (history seed, length 1-40, crash point, snapshot cadence
    1-9), so the cases are the same on every run."""
    draws = np.random.default_rng(2024)
    for k in range(30):
        seed = int(draws.integers(0, 10_001))
        n = int(draws.integers(1, 41))
        cut_frac = float(draws.uniform(0.0, 1.0))
        snapshot_every = int(draws.integers(1, 10))
        records = _random_records(np.random.default_rng(seed), n)
        cut = int(round(cut_frac * len(records)))
        assert (_crash_then_continue(str(tmp_path / f"hyp_{k}"), records,
                                     cut, snapshot_every)
                == same_fold(records))


# ---------------------------------------------------------------------------
# Across packages: a WAL written by either package replays in the other
# ---------------------------------------------------------------------------

def durable_run(pkg, root, data, queries, batches):
    core, eng, lm = PKGS[pkg]
    tdata = torch.as_tensor(data) if pkg == "port" else data
    backend = eng.DiskBackend(tdata, root, background=False, durable=True,
                              wal_snapshot_every=4)
    cfg = core.OreoConfig(alpha=2.0, seed=2, delta=1,
                          manager=lm.LayoutManagerConfig(target_partitions=8,
                                                         window_size=60,
                                                         gen_every=30))
    engine = eng.LayoutEngine(
        eng.OreoPolicy(tdata, core.build_default_layout(0, tdata, 8),
                       core.make_generator("qdtree"), cfg),
        backend, delta=1, ingest=eng.IngestConfig(debt_threshold=0.0))
    for k, q in enumerate(queries):
        if pkg == "port":
            q = tc.Query(lo=q.lo, hi=q.hi, template_id=q.template_id)
        engine.step(q)
        if k in batches:
            engine.ingest(batches[k])
    assert engine.compaction_indices
    return backend


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_wal_written_by_one_package_replays_in_the_other(tmp_path, writer):
    rng = np.random.default_rng(30)
    data = rng.uniform(0, 100, size=(600, 3))
    tmpl = rc.make_templates(1, 3, rng, cols_per_template=(2, 2))[0]
    queries = [tmpl.sample(rng, data.min(0), data.max(0)) for _ in range(30)]
    batches = {k: rng.uniform(0, 100, size=(40, 3)) for k in range(30)
               if k % 6 == 4}
    roots = {pkg: str(tmp_path / pkg) for pkg in PKGS}
    backends = {pkg: durable_run(pkg, roots[pkg], data, queries, batches)
                for pkg in PKGS}
    reader = "port" if writer == "ref" else "ref"
    wal_dir = os.path.join(roots[writer], "wal")
    written = dir_bytes(wal_dir)
    assert written == dir_bytes(os.path.join(roots[reader], "wal"))
    replayed = WALS[reader].ManifestWAL(wal_dir).replay()
    own = PKGS[writer][1].DiskBackend.recover_state(roots[writer])
    assert (WALS[reader].canonical_manifest(replayed)
            == WALS[writer].canonical_manifest(own))
    with open(os.path.join(backends[writer]._serving_store.root,
                           "manifest.json")) as f:
        assert replayed["manifest"] == json.load(f)
    # the reader goes on appending to the writer's log; both replay it alike
    extra = _random_records(np.random.default_rng(31), 6)
    log = WALS[reader].ManifestWAL(wal_dir, snapshot_every=4)
    for r in extra:
        log.append(r)
    assert (rwal.canonical_manifest(rwal.ManifestWAL(wal_dir).replay())
            == canonical_manifest(ManifestWAL(wal_dir).replay()))
    for backend in backends.values():
        backend.close()
