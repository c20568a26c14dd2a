"""The port's on-disk layer held against the JAX package's, on the CPU.

``PartitionStore`` must write the same partition files (loading to equal
arrays) and a byte-identical ``manifest.json`` for the same table and
layout, skip the same partitions when it reorganizes, and scan the same
rows.  ``DiskBackend`` traces — atomic, incremental with an unbounded
budget, and incremental under a tight row budget, with and without the
background writer — must equal ``repro``'s ``DiskBackend`` bit for bit,
migration ledgers included.
"""
import os

import numpy as np
import pytest
import torch

import repro.core as rc
import repro.engine as re_
from repro.core import layout_manager as rlm
from repro.data.partition_store import PartitionStore as RefStore

import repro_torch.core as tc
import repro_torch.engine as te
from repro_torch.core import layout_manager as tlm
from repro_torch.data import PartitionStore

PKGS = {"ref": (rc, re_, rlm), "port": (tc, te, tlm)}


def table(pkg, data):
    return torch.as_tensor(data) if pkg == "port" else data


def store_pair(tmp_path, name):
    return (RefStore(str(tmp_path / f"ref-{name}")),
            PartitionStore(str(tmp_path / f"port-{name}"), device="cpu"))


def assert_same_store(got, ref):
    with open(os.path.join(got.root, "manifest.json"), "rb") as f:
        got_bytes = f.read()
    with open(os.path.join(ref.root, "manifest.json"), "rb") as f:
        assert got_bytes == f.read()
    meta = ref.metadata()
    for p in range(meta.num_partitions):
        name = f"part_{p:05d}.npz"
        with np.load(os.path.join(got.root, name)) as a, \
                np.load(os.path.join(ref.root, name)) as b:
            assert a["rows"].dtype == b["rows"].dtype
            assert np.array_equal(a["rows"], b["rows"])
    got_meta = got.metadata()
    assert np.array_equal(got_meta.mins.numpy(), meta.mins)
    assert np.array_equal(got_meta.maxs.numpy(), meta.maxs)
    assert np.array_equal(got_meta.rows_host, meta.rows)


def squeezed(pkg, data, k):
    """A layout of ``k`` partitions whose last one is empty."""
    core = PKGS[pkg][0]
    wide = core.build_default_layout(1, data, k)
    route = wide.route
    clamp = torch.clamp_max if pkg == "port" else np.minimum

    def squeeze(rows):
        return clamp(route(rows), k - 2)
    return core.layouts.Layout(
        layout_id=1, name="squeezed", technique="test",
        meta=core.layouts.metadata_from_assignment(data, squeeze(data), k),
        route=squeeze)


def test_partition_store_write_reorganize_scan_equal_reference(tmp_path):
    rng = np.random.default_rng(9)
    data = rng.uniform(0, 100, (3000, 4))
    data[:5] = data[5]                      # duplicate rows keep order
    ref, got = store_pair(tmp_path, "tbl")
    tdata = table("port", data)
    ref.write(data, rc.build_default_layout(0, data, 6))
    got.write(tdata, tc.build_default_layout(0, tdata, 6))
    assert_same_store(got, ref)
    for layout_id, sort_col in ((1, None), (2, 1)):
        want = ref.reorganize(rc.build_default_layout(layout_id, data, 6,
                                                      sort_col=sort_col))
        have = got.reorganize(tc.build_default_layout(layout_id, tdata, 6,
                                                      sort_col=sort_col))
        assert (have.partitions_rewritten, have.partitions_skipped,
                have.rows_rewritten) == (want.partitions_rewritten,
                                         want.partitions_skipped,
                                         want.rows_rewritten)
        assert float(have) == have.seconds
        assert_same_store(got, ref)
    assert have.partitions_rewritten > 0
    # Growing the partition count, with an added empty partition.
    want = ref.reorganize(squeezed("ref", data, 8))
    have = got.reorganize(squeezed("port", tdata, 8))
    assert have.partitions_rewritten + have.partitions_skipped == 8
    assert have.partitions_skipped == want.partitions_skipped
    assert_same_store(got, ref)
    tmpl = rc.make_templates(1, 4, rng)[0]
    for _ in range(10):
        q = tmpl.sample(rng, data.min(0), data.max(0))
        (rows_a, stats_a), (rows_b, stats_b) = got.scan(q), ref.scan(q)
        assert np.array_equal(rows_a, rows_b)
        assert (stats_a.partitions_read, stats_a.partitions_total,
                stats_a.rows_read) == (stats_b.partitions_read,
                                       stats_b.partitions_total,
                                       stats_b.rows_read)
    rows, _ = got.scan(tc.Query(lo=data.min(0), hi=data.max(0)))
    assert len(rows) == len(data)
    assert got.full_scan_seconds() >= 0.0
    # An orphaned staging directory is reclaimed on open.
    os.makedirs(got.root + ".tmp/junk")
    PartitionStore(got.root, device="cpu")
    assert not os.path.exists(got.root + ".tmp")


def disk_run(pkg, data, stream, root, incremental, rows_per_tick=None,
             background=False):
    core, eng, lm = PKGS[pkg]
    data = table(pkg, data)
    cfg = core.OreoConfig(alpha=8.0, delta=6, seed=1,
                          manager=lm.LayoutManagerConfig(
                              target_partitions=6, window_size=30,
                              gen_every=15))
    backend = eng.DiskBackend(data, root, background=background)
    policy = eng.OreoPolicy(data, core.build_default_layout(0, data, 6),
                            core.make_generator("qdtree"), cfg)
    engine = eng.LayoutEngine(policy, backend, delta=cfg.delta,
                              incremental=incremental,
                              rows_per_tick=rows_per_tick)
    result = engine.run(stream)
    ledgers = ([] if engine.reorg_executor is None else
               [(m.begun_at, m.completed_at, m.charges, m.charged)
                for m in engine.reorg_executor.migrations])
    backend.close()
    assert not any(name.startswith("v") for name in os.listdir(root))
    return result, ledgers


@pytest.fixture(scope="module")
def disk_bench():
    rng = np.random.default_rng(1)
    data = rng.uniform(0, 100, size=(5000, 4))
    stream = rc.generate_workload(rc.make_templates(2, 4, rng), data.min(0),
                                  data.max(0), total_queries=80, seed=2,
                                  segment_length=(30, 50))
    return data, stream


@pytest.mark.parametrize("background", [False, True])
@pytest.mark.parametrize("mode", ["atomic", "incremental", "tight"])
def test_disk_backend_traces_equal_reference(mode, background, disk_bench,
                                             tmp_path):
    data, stream = disk_bench
    incremental = mode != "atomic"
    rpt = 1000 if mode == "tight" else None
    ref, ref_ledgers = disk_run("ref", data, stream, str(tmp_path / "ref"),
                                incremental, rpt, background)
    got, ledgers = disk_run("port", data, stream, str(tmp_path / "port"),
                            incremental, rpt, background)
    assert np.array_equal(got.query_costs, ref.query_costs)
    assert got.reorg_indices == ref.reorg_indices
    assert np.array_equal(got.state_seq, ref.state_seq)
    assert ledgers == ref_ledgers
    assert got.num_reorgs > 0
    if mode == "incremental":
        atomic, _ = disk_run("port", data, stream, str(tmp_path / "atomic"),
                             False, None, background)
        assert np.array_equal(got.query_costs, atomic.query_costs)
    if mode == "tight":
        assert any(end > begin for begin, end, _, _ in ledgers)
        assert all(charged == 8.0 for _, end, _, charged in ledgers
                   if end >= 0)


def test_disk_backend_hybrid_serving_and_completion_files(disk_bench,
                                                          tmp_path):
    """Mid-migration the served fraction equals the in-memory backend's
    hybrid cost, and the completed store is the target's exact layout."""
    data, stream = disk_bench
    tdata = table("port", data)
    engines = {}
    for name, backend in (("disk", te.DiskBackend(tdata, str(tmp_path),
                                                  background=False)),
                          ("mem", te.InMemoryBackend(tdata))):
        cfg = tc.OreoConfig(alpha=8.0, delta=6, seed=1,
                            manager=tlm.LayoutManagerConfig(
                                target_partitions=6, window_size=30,
                                gen_every=15))
        policy = te.OreoPolicy(tdata, tc.build_default_layout(0, tdata, 6),
                               tc.make_generator("qdtree"), cfg)
        engines[name] = te.LayoutEngine(policy, backend, delta=cfg.delta,
                                        incremental=True, rows_per_tick=700)
    hybrid_steps = 0
    for q in stream:
        costs = {name: e.step(q).query_cost for name, e in engines.items()}
        assert costs["disk"] == costs["mem"]
        disk = engines["disk"].backend
        hybrid_steps += disk.migrating and disk._migration[3] is not None
        if not disk.migrating and disk.serving_state is not None:
            store = disk._serving_store
            meta = disk.serving_layout.serving_meta()
            assert np.array_equal(store.metadata().mins.numpy(),
                                  meta.mins.numpy())
    assert hybrid_steps > 0
    engines["disk"].backend.close()


def test_disk_backend_refusals_and_failed_writes(tmp_path):
    data = torch.as_tensor(np.random.default_rng(0).uniform(0, 1, (200, 3)))
    durable = te.DiskBackend(data, str(tmp_path / "d"), durable=True)
    assert durable.wal is not None and durable.delta_log is None
    durable.close()
    with pytest.raises(TypeError, match="float64"):
        te.DiskBackend(data.float(), str(tmp_path / "f"))
    backend = te.DiskBackend(data, str(tmp_path / "b"), background=True)
    assert backend.wal is None
    with pytest.raises(RuntimeError, match="enable_ingest"):
        backend.ingest_rows(np.zeros((2, 3)))
    good = tc.build_default_layout(0, data, 4)
    backend.register(good)
    backend.activate(0)
    assert backend.serving_state == 0 and backend.initial_write_seconds > 0

    def broken(rows):
        raise RuntimeError("route failed")
    bad = tc.layouts.Layout(layout_id=1, name="bad", technique="test",
                            meta=good.meta, route=broken)
    backend.register(bad)
    backend.prepare(1)
    assert backend.pending_states == [1]
    with pytest.raises(RuntimeError, match="failed"):
        backend.activate(1)
    assert backend.serving_state == 0         # the failed write never serves
    backend.register(tc.build_default_layout(2, data, 4, sort_col=1))
    backend.prepare(2)
    writer = backend._pending[2][0]
    backend.deregister(2)                      # cancelled: no directory kept
    writer.join()
    backend.close()
    assert os.listdir(tmp_path / "b") == []
