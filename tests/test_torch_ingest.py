"""The port's streaming ingest plane held against the JAX package's, on
the CPU.

Every case of ``tests/test_ingest.py`` runs here on both packages from the
same seeded numpy inputs: delta partitions and their immediate scan
visibility, the clustering-debt meter and debt-triggered compactions
(atomic and incremental), the mixed read/write fleet paths (``run`` and
``run_batched`` on both of the port's lanes), the zero-ingest identity
(ingest enabled but unused changes nothing, every drift scenario x
scheduler), and the durable ``DiskBackend``'s WAL recovery.  The port
must pass the reference's own assertions and equal ``repro`` bit for bit:
traces, compaction indices, ``ingest_stats()``, composed zone maps,
migration ledgers and replayed manifests.  ``repro`` runs its exact
``compute="numpy"`` mode.  Beyond the mirror: the table grows in a device
buffer (an append within capacity copies only the batch), and an ingest
between ``run``'s block estimates is never served a block row scanned
before it.
"""
import json
import os
import warnings

import numpy as np
import pytest
import torch

import repro.core as rc
import repro.engine as re_
from repro.core import layout_manager as rlm
from repro.data.partition_store import PartitionStore as RefStore
from repro.data.wal import canonical_manifest as ref_canonical
from repro.engine.ingest import DeltaLog as RefDeltaLog

import repro_torch.core as tc
import repro_torch.engine as te
from repro_torch.core import layout_manager as tlm
from repro_torch.data import PartitionStore
from repro_torch.data.wal import canonical_manifest
from repro_torch.engine.ingest import DeltaLog

PKGS = {"ref": (rc, re_, rlm), "port": (tc, te, tlm)}
LANES = ("fleet_scan", "decision_fused")
SCENARIOS = ["sudden_shift", "gradual_drift", "cyclic_diurnal",
             "flash_crowd", "template_churn"]
SCHEDULERS = {
    "unlimited": lambda eng: eng.UnlimitedScheduler(),
    "k1": lambda eng: eng.KConcurrentScheduler(1),
    "bucket": lambda eng: eng.TokenBucketScheduler(rate=0.01, capacity=1.0,
                                                   initial=0.0),
}


def table(pkg, data):
    return torch.as_tensor(data) if pkg == "port" else data


def host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def tenant_data():
    return {f"t{t}": np.random.default_rng(300 + t).uniform(
        0, 100, size=(2_000, 5)) for t in range(2)}


@pytest.fixture(scope="module")
def bounds(tenant_data):
    lo = np.min([d.min(0) for d in tenant_data.values()], axis=0)
    hi = np.max([d.max(0) for d in tenant_data.values()], axis=0)
    return lo, hi


def oreo_engine(pkg, data, incremental=False, ingest=None, alpha=10.0,
                delta=5, seed=2, backend=None, sort_col=None, lane=None):
    core, eng, lm = PKGS[pkg]
    data = table(pkg, data)
    cfg = core.OreoConfig(alpha=alpha, seed=seed, delta=delta,
                          manager=lm.LayoutManagerConfig(target_partitions=8,
                                                         window_size=60,
                                                         gen_every=30))
    policy = eng.OreoPolicy(data,
                            core.build_default_layout(0, data, 8,
                                                      sort_col=sort_col),
                            core.make_generator("qdtree"), cfg)
    kw = {} if lane is None else {"reorg_compute": lane}
    return eng.LayoutEngine(policy, backend or eng.InMemoryBackend(data),
                            delta=cfg.delta, incremental=incremental,
                            ingest=None if ingest is None
                            else eng.IngestConfig(**ingest), **kw)


def simple_engine(pkg, data, ingest=None, incremental=False, alpha=2.0,
                  delta=1, backend=None, **kw):
    return oreo_engine(pkg, data, incremental=incremental, ingest=ingest,
                       alpha=alpha, delta=delta, backend=backend, **kw)


def queries_for(rng, data, n, bounded=2):
    tmpl = rc.make_templates(1, data.shape[1], rng,
                             cols_per_template=(bounded, bounded))[0]
    return [tmpl.sample(rng, data.min(0), data.max(0)) for _ in range(n)]


def port_queries(queries):
    return [tc.Query(lo=q.lo, hi=q.hi, template_id=q.template_id)
            for q in queries]


def assert_same_trace(a, b):
    assert np.array_equal(a.query_costs, b.query_costs)
    assert a.reorg_indices == b.reorg_indices
    assert np.array_equal(a.state_seq, b.state_seq)


def assert_same_meta(got, ref):
    assert np.array_equal(host(got.mins), ref.mins)
    assert np.array_equal(host(got.maxs), ref.maxs)
    assert np.array_equal(got.rows_host, ref.rows)


def records(engine):
    ex = engine.reorg_executor
    return [(m.target_state, m.charged_at, m.begun_at, m.completed_at,
             m.alpha, m.total_rows, m.moved_rows, m.moves_total,
             m.moves_done, tuple(m.charges), m.charged)
            for m in ex.migrations]


def drive(pkg, engine, queries, ingests, rows_rng_seed):
    """Step ``queries``; before step ``k`` append the (rows, lo, hi) batch
    ``ingests[k]`` drawn from a seeded generator (same draws per package)."""
    rng = np.random.default_rng(rows_rng_seed)
    qs = port_queries(queries) if pkg == "port" else queries
    for k, q in enumerate(qs):
        if k in ingests:
            n, c, lo, hi = ingests[k]
            engine.ingest(rng.uniform(lo, hi, size=(n, c)))
        engine.step(q)


# ---------------------------------------------------------------------------
# PartitionStore reclaims orphaned tmp dirs
# ---------------------------------------------------------------------------

def test_partition_store_reclaims_orphan_tmp(tmp_path):
    """A crash mid-write/mid-reorganize leaves "<root>.tmp" behind; open
    must reclaim it (the live directory was never touched)."""
    rng = np.random.default_rng(0)
    data = rng.uniform(0, 10, size=(200, 2))
    query = queries_for(rng, data, 1, bounded=1)[0]
    stores = {}
    for pkg, make in (("ref", RefStore),
                      ("port", lambda r: PartitionStore(r, device="cpu"))):
        root = str(tmp_path / f"{pkg}-store")
        make(root).write(table(pkg, data),
                         PKGS[pkg][0].build_default_layout(0, table(pkg, data),
                                                           4))
        orphan = tmp_path / f"{pkg}-store.tmp"
        orphan.mkdir()
        (orphan / "part_00000.npz").write_bytes(b"partial garbage")
        (orphan / "manifest.json").write_text('{"torn')
        store = make(root)                            # reopen: reclaims
        assert not orphan.exists()
        assert store.metadata().num_partitions == 4
        out, stats = store.scan(query)
        assert stats.partitions_total == 4
        store.reorganize(PKGS[pkg][0].build_default_layout(
            1, table(pkg, data), 4, sort_col=1))
        assert store.metadata().num_partitions == 4
        stores[pkg] = (store, out)
    assert_same_meta(stores["port"][0].metadata(),
                     stores["ref"][0].metadata())
    assert np.array_equal(stores["port"][1], stores["ref"][1])


# ---------------------------------------------------------------------------
# DeltaLog / DebtMeter units
# ---------------------------------------------------------------------------

def test_delta_log_compose_identity_without_batches():
    rng = np.random.default_rng(1)
    data = torch.as_tensor(rng.uniform(0, 100, size=(500, 3)))
    meta = tc.build_default_layout(0, data, 4).materialize(data)
    d = DeltaLog(len(data))
    assert d.compose(meta) is meta          # the zero-ingest identity
    assert d.source_assignment(torch.zeros(500, dtype=torch.int64), 4,
                               500) is None


def test_delta_log_append_compose_absorb():
    rng = np.random.default_rng(2)
    data = rng.uniform(0, 100, size=(500, 3))
    rows1 = rng.uniform(0, 100, size=(40, 3))
    rows2 = rng.uniform(0, 100, size=(60, 3))
    out = {}
    for pkg, log in (("ref", RefDeltaLog), ("port", DeltaLog)):
        core = PKGS[pkg][0]
        layout = core.build_default_layout(0, table(pkg, data), 4)
        meta = layout.materialize(table(pkg, data))
        d = log(len(data))
        b1 = d.append(table(pkg, rows1), 500)
        b2 = d.append(table(pkg, rows2), 540)
        assert (b1.batch_id, b2.batch_id) == (0, 1)
        assert d.delta_rows == 100 and d.num_batches == 2
        composed = d.compose(meta)
        assert composed.num_partitions == 6 and composed.total_rows == 600
        assert np.array_equal(host(composed.mins[4]), rows1.min(axis=0))
        assert np.array_equal(host(composed.maxs[5]), rows2.max(axis=0))
        full = np.concatenate([data, rows1, rows2])
        assign = d.source_assignment(layout.route(table(pkg, full[:500])),
                                     4, 600)
        assert assign.shape == (600,)
        assert set(host(assign[500:540]).tolist()) == {4}
        assert set(host(assign[540:]).tolist()) == {5}
        gen = d.generation
        d.absorb_up_to(540)
        assert d.generation == gen + 1
        assert [b.batch_id for b in d.batches] == [1]
        assert d.clustered_len == 540
        half = d.compose(meta)
        d.absorb_up_to(600)
        assert not d.pending and d.compose(meta) is meta
        out[pkg] = (composed, host(assign), half)
    assert_same_meta(out["port"][0], out["ref"][0])
    assert np.array_equal(out["port"][1], out["ref"][1])
    assert_same_meta(out["port"][2], out["ref"][2])


def test_delta_log_rejects_empty_batches():
    d = DeltaLog(10)
    with pytest.raises(ValueError):
        d.append(torch.zeros((0, 3), dtype=torch.float64), 10)
    with pytest.raises(ValueError):
        d.append(torch.zeros(5, dtype=torch.float64), 10)


def test_debt_meter_accrues_only_positive_excess():
    rng = np.random.default_rng(3)
    data = rng.uniform(0, 100, size=(400, 2))
    rows = rng.uniform(0, 100, size=(50, 2))
    q_lo, q_hi = np.full(2, -np.inf), np.full(2, np.inf)
    q2_lo, q2_hi = np.array([10.0, -np.inf]), np.array([30.0, np.inf])
    out = {}
    for pkg in PKGS:
        core, eng, _ = PKGS[pkg]
        layout = core.build_default_layout(0, table(pkg, data), 4)
        meta = layout.materialize(table(pkg, data))
        meter = eng.DebtMeter()
        assert not meter.active
        assert meter.observe(0.5, np.zeros(2), np.ones(2)) == 0.0
        assign = layout.route(table(pkg, rows))
        assign = (assign.to(torch.int64) if pkg == "port"
                  else np.asarray(assign, np.int64))
        meter.on_append(meta, table(pkg, rows), assign)
        assert meter.active
        assert meter._compacted.total_rows == 450
        ideal = float(core.layouts.eval_cost(meter._compacted, q_lo, q_hi))
        inc = meter.observe(ideal + 0.25, q_lo, q_hi)
        assert inc == pytest.approx(0.25)
        assert meter.observe(ideal - 0.5, q_lo, q_hi) == 0.0
        narrow = meter.observe(0.9, q2_lo, q2_hi)
        assert meter.debt == pytest.approx(0.25 + narrow)
        cfg = eng.IngestConfig(debt_threshold=1.0)
        assert not meter.triggered(alpha=10.0, config=cfg)
        assert meter.triggered(alpha=0.2, config=cfg)
        assert not meter.triggered(alpha=0.2,
                                   config=eng.IngestConfig(auto_compact=False))
        out[pkg] = (meter._compacted, meter.debt, meter.total_excess, inc,
                    narrow)
        meter.reset()
        assert meter.debt == 0.0 and not meter.active
    assert_same_meta(out["port"][0], out["ref"][0])
    assert out["port"][1:] == out["ref"][1:]


# ---------------------------------------------------------------------------
# Engine-level ingest semantics
# ---------------------------------------------------------------------------

def test_engine_requires_ingest_capable_backend():
    rng = np.random.default_rng(4)
    data = rng.uniform(0, 100, size=(300, 3))
    for pkg in PKGS:
        eng = simple_engine(pkg, data)
        with pytest.raises(RuntimeError, match="without ingest"):
            eng.ingest(np.zeros((2, 3)))


def test_engine_rejects_incremental_ingest_on_disk_backend(tmp_path):
    rng = np.random.default_rng(5)
    data = rng.uniform(0, 100, size=(300, 3))
    for pkg in PKGS:
        backend = PKGS[pkg][1].DiskBackend(table(pkg, data),
                                           str(tmp_path / pkg),
                                           background=False)
        with pytest.raises(ValueError, match="delta_source"):
            simple_engine(pkg, data, ingest={}, incremental=True,
                          backend=backend)
        backend.close()


def test_ingested_rows_visible_to_next_query():
    """Appended rows raise the very next serve cost by exactly the delta
    partition's contribution (wide bounds -> always scanned)."""
    rng = np.random.default_rng(6)
    data = rng.uniform(0, 100, size=(1000, 3))
    queries = queries_for(rng, data, 8)
    batch = rng.uniform(0, 100, size=(250, 3))
    out = {}
    for pkg in PKGS:
        eng = simple_engine(pkg, data, ingest={"auto_compact": False})
        qs = port_queries(queries) if pkg == "port" else queries
        for q in qs[:4]:
            eng.step(q)
        before = eng.backend.serve(qs[4])
        eng.ingest(batch)
        after = eng.backend.serve(qs[4])
        assert eng.backend._serving_cache[3] == 1250
        assert after == pytest.approx((before * 1000 + 250) / 1250)
        assert eng.backend.delta_log.pending
        assert eng.ingest_stats()["pending_rows"] == 250
        out[pkg] = (before, after, eng.ingest_stats())
    assert out["port"] == out["ref"]


def test_ingest_does_not_advance_query_index():
    rng = np.random.default_rng(7)
    data = rng.uniform(0, 100, size=(500, 3))
    queries = queries_for(rng, data, 5)
    rows = rng.uniform(0, 100, size=(20, 3))
    for pkg in PKGS:
        eng = simple_engine(pkg, data, ingest={"auto_compact": False})
        for q in (port_queries(queries) if pkg == "port" else queries):
            eng.step(q)
        eng.ingest(rows)
        assert len(eng.result().query_costs) == 5
        assert eng.ingest_stats()["ingested_rows"] == 20


def test_always_compact_triggers_at_first_delta_query():
    rng = np.random.default_rng(8)
    data = rng.uniform(0, 100, size=(1000, 3))
    queries = queries_for(rng, data, 6)
    out = {}
    for pkg in PKGS:
        eng = simple_engine(pkg, data, ingest={"debt_threshold": 0.0})
        drive(pkg, eng, queries[:4], {3: (100, 3, 0, 100)}, 80)
        assert eng.ingest_stats()["compactions"] == [3]
        eng.step((port_queries if pkg == "port" else list)(queries[4:5])[0])
        assert not eng.backend.delta_log.pending        # absorbed
        assert eng.backend._serving_cache[3] == 1100
        assert 3 in eng.result().reorg_indices
        out[pkg] = (eng.result(), eng.ingest_stats())
    assert_same_trace(out["port"][0], out["ref"][0])
    assert out["port"][1] == out["ref"][1]


def test_never_compact_accrues_debt_without_reorgs():
    rng = np.random.default_rng(9)
    data = np.sort(rng.uniform(0, 100, size=(1000, 3)), axis=0)
    queries = queries_for(rng, data, 30)
    out = {}
    for pkg in PKGS:
        eng = simple_engine(pkg, data, ingest={"auto_compact": False},
                            alpha=1.5, sort_col=0)
        drive(pkg, eng, queries, {5: (200, 3, 0, 100)}, 90)
        stats = eng.ingest_stats()
        assert stats["compactions"] == []
        assert stats["clustering_debt"] > 1.5
        assert eng.backend.delta_log.pending
        assert eng.result().reorg_indices == []
        out[pkg] = (eng.result(), stats)
    assert_same_trace(out["port"][0], out["ref"][0])
    assert out["port"][1] == out["ref"][1]


def test_debt_aware_compacts_once_debt_crosses_alpha():
    rng = np.random.default_rng(10)
    data = np.sort(rng.uniform(0, 100, size=(1000, 3)), axis=0)
    queries = queries_for(rng, data, 80)
    batch = rng.uniform(0, 100, size=(400, 3))
    out = {}
    for pkg in PKGS:
        eng = simple_engine(pkg, data, ingest={"debt_threshold": 1.0},
                            alpha=1.5, sort_col=0)
        compacted_at = None
        for k, q in enumerate(port_queries(queries) if pkg == "port"
                              else queries):
            if k == 5:
                eng.ingest(batch)
            eng.step(q)
            if eng.compaction_indices and compacted_at is None:
                compacted_at = k
                assert eng.ingest_stats()["total_excess"] >= 1.5
            if compacted_at is not None and k >= compacted_at + 2:
                break
        assert compacted_at is not None and compacted_at > 5
        assert not eng.backend.delta_log.pending
        assert eng.ingest_stats()["clustering_debt"] == 0.0
        out[pkg] = (compacted_at, eng.result(), eng.ingest_stats())
    assert out["port"][0] == out["ref"][0]
    assert_same_trace(out["port"][1], out["ref"][1])
    assert out["port"][2] == out["ref"][2]


def test_drift_reorg_absorbs_deltas_and_resets_debt():
    """A policy-driven (drift) reorganization also rewrites the grown
    table: deltas absorb through the same activation path."""
    rng = np.random.default_rng(11)
    data = rng.uniform(0, 100, size=(1000, 3))
    queries = queries_for(rng, data, 4)
    batch = rng.uniform(0, 100, size=(50, 3))
    out = {}
    for pkg in PKGS:
        eng = simple_engine(pkg, data, ingest={"auto_compact": False})
        qs = port_queries(queries) if pkg == "port" else queries
        for q in qs[:2]:
            eng.step(q)
        eng.ingest(batch)
        assert eng.backend.delta_log.pending
        eng.backend.activate(eng.backend.serving_state)
        assert not eng.backend.delta_log.pending
        assert eng.backend._serving_cache[3] == 1050
        eng.step(qs[2])
        assert eng.ingest_stats()["clustering_debt"] == 0.0
        out[pkg] = (eng.result(),
                    eng.backend.serving_layout.serving_meta())
    assert_same_trace(out["port"][0], out["ref"][0])
    assert_same_meta(out["port"][1], out["ref"][1])


@pytest.mark.parametrize("lane", ["move_score", "decision_fused"])
def test_incremental_compaction_moves_only_delta_touched_partitions(lane):
    """An incremental compaction diffs the hybrid delta-bearing source
    against the re-materialized target: clustered partitions whose row
    set is unchanged are skipped; the charge ledger still telescopes to
    bitwise alpha."""
    rng = np.random.default_rng(12)
    data = np.sort(rng.uniform(0, 100, size=(2000, 1)), axis=0)
    queries = queries_for(rng, data, 10, bounded=1)
    out = {}
    for pkg in PKGS:
        eng = simple_engine(pkg, data, ingest={"debt_threshold": 0.0},
                            incremental=True, alpha=1.5, sort_col=0,
                            lane=lane if pkg == "port" else None)
        drive(pkg, eng, queries[:5], {3: (120, 1, 10.0, 12.0)}, 120)
        ex = eng.reorg_executor
        assert len(ex.migrations) == 1
        mig = ex.migrations[0]
        assert mig.completed_at >= 0 and mig.charged == mig.alpha
        k = eng.backend.ingest_base_meta.num_partitions
        assert 0 < mig.moves_total < k
        assert not eng.backend.delta_log.pending
        out[pkg] = (records(eng), eng.result(), eng.ingest_stats())
    assert out["port"][0] == out["ref"][0]
    assert_same_trace(out["port"][1], out["ref"][1])
    assert out["port"][2] == out["ref"][2]


def test_mid_flight_appends_stack_as_fresh_deltas():
    """Rows appended while a migration is in flight stay pending delta
    partitions (served immediately) and survive the completion absorb."""
    rng = np.random.default_rng(13)
    data = np.sort(rng.uniform(0, 100, size=(3000, 1)), axis=0)
    queries = queries_for(rng, data, 30, bounded=1)
    first = rng.uniform(20.0, 30.0, size=(300, 1))
    second = rng.uniform(50.0, 60.0, size=(80, 1))
    out = {}
    for pkg in PKGS:
        eng = simple_engine(pkg, data, ingest={"debt_threshold": 0.0},
                            incremental=True, alpha=1.5, sort_col=0)
        eng.reorg_executor.rows_per_tick = 40
        qs = port_queries(queries) if pkg == "port" else queries
        for q in qs[:3]:
            eng.step(q)
        eng.ingest(first)
        eng.step(qs[3])                             # trigger
        eng.step(qs[4])                             # begin (40 rows/tick)
        assert eng.backend.migrating
        mid = eng.ingest(second)
        assert eng.backend.delta_log.pending
        eng.reorg_executor.rows_per_tick = None
        k = 5
        while eng.backend.migrating and k < 30:
            eng.step(qs[k])
            k += 1
        assert not eng.backend.migrating
        assert [b.batch_id for b in eng.backend.delta_log.batches] \
            == [mid.batch_id]
        assert eng.backend._serving_cache[3] == 3380
        ex = eng.reorg_executor
        assert ex.migrations[0].charged == ex.migrations[0].alpha
        out[pkg] = (k, records(eng), eng.result(), eng.ingest_stats())
    assert out["port"][:2] == out["ref"][:2]
    assert_same_trace(out["port"][2], out["ref"][2])
    assert out["port"][3] == out["ref"][3]


def test_run_forces_stepwise_serving_under_ingest():
    rng = np.random.default_rng(14)
    data = rng.uniform(0, 100, size=(500, 3))
    queries = queries_for(rng, data, 3)
    for pkg in PKGS:
        eng = simple_engine(pkg, data, ingest={})
        qs = port_queries(queries) if pkg == "port" else queries
        with pytest.raises(ValueError, match="batch_serve"):
            eng.run(PKGS[pkg][0].WorkloadStream(queries=qs, segments=[],
                                                templates=[]),
                    batch_serve=True)


# ---------------------------------------------------------------------------
# Zero-ingest identity, every scenario x scheduler
# ---------------------------------------------------------------------------

def fleet(pkg, tenant_data, tids, sched, **kw):
    eng = PKGS[pkg][1]
    return eng.FleetEngine({tid: oreo_engine(pkg, tenant_data[tid], **kw)
                            for tid in tids}, SCHEDULERS[sched](eng))


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_zero_ingest_traces_bit_identical(scenario, tenant_data, bounds):
    """Ingest enabled but never used: atomic and incremental fleet traces
    — ``run`` and ``run_batched`` on both lanes — equal the traces without
    ingest, and ``repro``'s, under every scheduler."""
    lo, hi = bounds
    for sched in SCHEDULERS:
        kw = dict(num_tenants=2, queries_per_tenant=80, seed=7)
        ref_fs = rc.make_drift_scenario(scenario, lo, hi, **kw)
        fs = tc.make_drift_scenario(scenario, lo, hi, **kw)
        golden = fleet("ref", tenant_data, fs.tenant_ids, sched).run(ref_fs)
        arms = {
            "plain": lambda: fleet("port", tenant_data, fs.tenant_ids,
                                   sched).run(fs),
            "atomic-loop": lambda: fleet("port", tenant_data, fs.tenant_ids,
                                         sched, ingest={}).run(fs),
            "incremental-loop": lambda: fleet(
                "port", tenant_data, fs.tenant_ids, sched, incremental=True,
                ingest={}).run(fs),
        }
        for lane in LANES:
            arms[f"atomic-{lane}"] = lambda lane=lane: fleet(
                "port", tenant_data, fs.tenant_ids, sched,
                ingest={}).run_batched(fs, compute=lane)
        for label, arm in arms.items():
            res = arm()
            for tid in fs.tenant_ids:
                assert_same_trace(res.per_tenant[tid],
                                  golden.per_tenant[tid]), (label, tid)
            assert res.swaps_deferred == golden.swaps_deferred, label
            assert res.deferred_ticks == golden.deferred_ticks, label


# ---------------------------------------------------------------------------
# Mixed read/write fleet streams
# ---------------------------------------------------------------------------

def test_ingest_scenarios_materialize_and_preserve_order(bounds):
    lo, hi = bounds
    assert set(tc.INGEST_SCENARIOS) == {"trickle", "append_heavy",
                                        "mixed_rw", "ingest_burst",
                                        "bulk_load"}
    for name in sorted(tc.INGEST_SCENARIOS):
        kw = dict(num_tenants=2, queries_per_tenant=60, seed=5)
        fs = tc.make_ingest_scenario(name, lo, hi, **kw)
        ref = rc.make_ingest_scenario(name, lo, hi, **kw)
        assert fs.scenario == name
        assert fs.total_appended_rows == ref.total_appended_rows > 0
        assert len(fs.events) == sum(len(v) for v in fs.per_tenant.values())
        assert tc.workload.SCENARIO_INFO[name] \
            == tc.workload.ScenarioInfo(**vars(
                rc.workload.SCENARIO_INFO[name]))
        for tid in fs.tenant_ids:
            assert len(fs.tenant_queries(tid)) == 60
            assert len(fs.tenant_batches(tid)) == len(ref.tenant_batches(tid))
            replayed = [e for t, e in fs.events if t == tid]
            assert all(x is y for x, y in zip(replayed, fs.per_tenant[tid]))
        for got, want in zip(fs.events, ref.events):
            assert got[0] == want[0]
            assert type(got).__name__ == type(want).__name__
            if isinstance(got, tc.IngestEvent):
                assert np.array_equal(got.batch.rows, want.batch.rows)
                assert got.batch.num_rows == want.batch.num_rows
            else:
                assert np.array_equal(got.query.lo, want.query.lo)
                assert np.array_equal(got.query.hi, want.query.hi)
                assert got.query.template_id == want.query.template_id
        again = tc.make_ingest_scenario(name, lo, hi, **kw)
        for (t1, e1), (t2, e2) in zip(fs.events, again.events):
            assert t1 == t2 and type(e1) is type(e2)
            if isinstance(e1, tc.IngestBatch):
                np.testing.assert_array_equal(e1.rows, e2.rows)


@pytest.mark.parametrize("scenario", ["trickle", "mixed_rw", "bulk_load"])
def test_fleet_mixed_stream_loop_vs_batched_bit_identical(scenario,
                                                          tenant_data,
                                                          bounds):
    lo, hi = bounds
    kw = dict(num_tenants=2, queries_per_tenant=120, seed=9)
    ref_fs = rc.make_ingest_scenario(scenario, lo, hi, **kw)
    fs = tc.make_ingest_scenario(scenario, lo, hi, **kw)
    ref_fleet = fleet("ref", tenant_data, fs.tenant_ids, "unlimited",
                      alpha=2.0, ingest={})
    want = ref_fleet.run(ref_fs)
    for mode in ("run",) + LANES:
        f = fleet("port", tenant_data, fs.tenant_ids, "unlimited",
                  alpha=2.0, ingest={})
        got = f.run(fs) if mode == "run" else f.run_batched(fs, compute=mode)
        for tid in fs.tenant_ids:
            assert_same_trace(got.per_tenant[tid], want.per_tenant[tid])
            assert (f.tenant(tid).compaction_indices
                    == ref_fleet.tenant(tid).compaction_indices)
            assert (f.tenant(tid).ingest_stats()
                    == ref_fleet.tenant(tid).ingest_stats())
            assert len(got.per_tenant[tid].query_costs) == 120
        assert got.ticks == want.ticks == len(fs)


def test_fleet_incremental_mixed_stream_matches_atomic(tenant_data, bounds):
    """Unbounded budget: the incremental fleet's mixed-stream trace is
    bit-identical to the atomic fleet's (compactions included), on both
    planner lanes, and to ``repro``'s."""
    lo, hi = bounds
    kw = dict(num_tenants=2, queries_per_tenant=120, seed=11)
    ref_fs = rc.make_ingest_scenario("trickle", lo, hi, **kw)
    fs = tc.make_ingest_scenario("trickle", lo, hi, **kw)
    ref_incr = fleet("ref", tenant_data, fs.tenant_ids, "unlimited",
                     alpha=2.0, incremental=True, ingest={})
    want = ref_incr.run(ref_fs)
    atomic = fleet("port", tenant_data, fs.tenant_ids, "unlimited",
                   alpha=2.0, ingest={})
    ra = atomic.run(fs)
    for lane in ("move_score", "decision_fused"):
        incr = fleet("port", tenant_data, fs.tenant_ids, "unlimited",
                     alpha=2.0, incremental=True, ingest={}, lane=lane)
        ri = incr.run(fs)
        for tid in fs.tenant_ids:
            assert_same_trace(ra.per_tenant[tid], ri.per_tenant[tid])
            assert_same_trace(ri.per_tenant[tid], want.per_tenant[tid])
            assert (atomic.tenant(tid).compaction_indices
                    == incr.tenant(tid).compaction_indices)
            assert records(incr.tenant(tid)) == records(ref_incr.tenant(tid))
            for mig in incr.tenant(tid).reorg_executor.migrations:
                assert mig.completed_at == mig.begun_at
                assert mig.charged == mig.alpha
    assert any(atomic.tenant(tid).compaction_indices
               for tid in fs.tenant_ids)


def test_fleet_step_returns_none_observation_for_ingest(tenant_data):
    data = tenant_data["t0"]
    f = te.FleetEngine({"t0": oreo_engine("port", data, ingest={})},
                       te.UnlimitedScheduler())
    rng = np.random.default_rng(15)
    q = port_queries(queries_for(rng, data, 1))[0]
    assert f.step("t0", q).step is not None
    out = f.step("t0", tc.IngestBatch(rows=rng.uniform(
        0, 100, size=(10, data.shape[1]))))
    assert out.step is None and out.tick == 2
    assert f.tenant("t0").ingest_stats()["ingested_rows"] == 10


# ---------------------------------------------------------------------------
# Durable DiskBackend: WAL recovery
# ---------------------------------------------------------------------------

def disk_engine(pkg, data, root, ingest=None, alpha=2.0, durable=True,
                snapshot_every=64):
    backend = PKGS[pkg][1].DiskBackend(table(pkg, data), root,
                                       background=False, durable=durable,
                                       wal_snapshot_every=snapshot_every)
    return simple_engine(pkg, data, ingest=ingest, alpha=alpha,
                         backend=backend), backend


def test_disk_backend_serves_pending_deltas(tmp_path):
    rng = np.random.default_rng(16)
    data = rng.uniform(0, 100, size=(600, 3))
    queries = queries_for(rng, data, 4)
    batch = rng.uniform(0, 100, size=(150, 3))
    out = {}
    for pkg in PKGS:
        eng, backend = disk_engine(pkg, data, str(tmp_path / pkg),
                                   durable=False,
                                   ingest={"auto_compact": False})
        qs = port_queries(queries) if pkg == "port" else queries
        eng.step(qs[0])
        eng.ingest(batch)
        composed = backend.delta_log.compose(backend.ingest_base_meta)
        served = []
        for q in qs[1:]:
            got = backend.serve(q)
            want = float(PKGS[pkg][0].layouts.eval_cost(composed, q.lo,
                                                        q.hi))
            assert got == pytest.approx(want)
            served.append(got)
        out[pkg] = (served, composed)
        backend.close()
    assert out["port"][0] == out["ref"][0]
    assert_same_meta(out["port"][1], out["ref"][1])


def test_disk_backend_wal_replays_to_live_manifest(tmp_path):
    """The crash-injection gate: at every point of a mixed run, replaying
    the WAL reconstructs the serving manifest bitwise and the exact set of
    pending delta batches — and equals ``repro``'s replay at that point."""
    rng = np.random.default_rng(17)
    data = rng.uniform(0, 100, size=(600, 3))
    queries = queries_for(rng, data, 30)
    batches = {k: rng.uniform(0, 100, size=(40, 3)) for k in range(30)
               if k % 6 == 4}
    runs = {}
    for pkg in PKGS:
        root = str(tmp_path / pkg)
        eng, backend = disk_engine(pkg, data, root, snapshot_every=5,
                                   ingest={"debt_threshold": 0.0})
        recover = PKGS[pkg][1].DiskBackend.recover_state
        states = []
        qs = port_queries(queries) if pkg == "port" else queries
        for k, q in enumerate(qs):
            eng.step(q)
            if k in batches:
                eng.ingest(batches[k])
            state = recover(root)
            assert state["serving"] == os.path.basename(
                backend._serving_store.root)
            with open(os.path.join(backend._serving_store.root,
                                   "manifest.json")) as f:
                assert state["manifest"] == json.load(f)
            live = [b.batch_id for b in backend.delta_log.batches]
            assert [d["batch_id"] for d in state["deltas"]] == live
            for d in state["deltas"]:
                assert os.path.exists(os.path.join(root, "deltas",
                                                   d["file"]))
            states.append(state)
        assert eng.compaction_indices
        assert (canonical_manifest(recover(root))
                == canonical_manifest(recover(root)))
        runs[pkg] = (states, eng.result(), eng.ingest_stats())
        backend.close()
    assert ([canonical_manifest(s) for s in runs["port"][0]]
            == [ref_canonical(s) for s in runs["ref"][0]])
    assert_same_trace(runs["port"][1], runs["ref"][1])
    assert runs["port"][2] == runs["ref"][2]


def test_disk_backend_orphaned_delta_file_is_ignored(tmp_path):
    """Crash between delta-file write and WAL commit: the orphaned file is
    never referenced by replay (the record is the commit point)."""
    rng = np.random.default_rng(18)
    data = rng.uniform(0, 100, size=(400, 3))
    query = queries_for(rng, data, 1)[0]
    rows = rng.uniform(0, 100, size=(30, 3))
    root = str(tmp_path / "d")
    eng, backend = disk_engine("port", data, root,
                               ingest={"auto_compact": False})
    eng.step(port_queries([query])[0])
    eng.ingest(rows)
    np.savez(os.path.join(root, "deltas", "delta_99999.npz"),
             rows=np.zeros((5, 3)))
    state = te.DiskBackend.recover_state(root)
    assert [d["batch_id"] for d in state["deltas"]] == [0]
    assert all(d["file"] != "delta_99999.npz" for d in state["deltas"])
    with np.load(os.path.join(root, "deltas", "delta_00000.npz")) as z:
        assert np.array_equal(z["rows"], rows)
    backend.close()


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
def test_disk_backend_wal_records_incremental_migration(tmp_path, order):
    """Drift migrations on a durable DiskBackend log begin/apply/swap;
    mid-flight crash replay shows the in-flight migration, completion
    replay shows the target manifest.  The logs equal ``repro``'s record
    for record.  On the column-sorted table the arrival-order layout is
    already clustered (no reorganization, as in ``repro``'s own case); the
    shuffled table makes one migrate."""
    rng = np.random.default_rng(19)
    data = np.sort(rng.uniform(0, 100, size=(1500, 2)), axis=0)
    queries = queries_for(rng, data, 60, bounded=1)
    if order == "shuffled":
        data = np.random.default_rng(5).permutation(data)
    logs = {}
    for pkg in PKGS:
        root = str(tmp_path / pkg)
        backend = PKGS[pkg][1].DiskBackend(table(pkg, data), root,
                                           background=False, durable=True)
        eng = simple_engine(pkg, data, incremental=True, alpha=1.5,
                            backend=backend)
        ex = eng.reorg_executor
        ex.rows_per_tick = 100
        recover = PKGS[pkg][1].DiskBackend.recover_state
        saw_in_flight = False
        for q in (port_queries(queries) if pkg == "port" else queries):
            eng.step(q)
            state = recover(root)
            if backend.migrating:
                saw_in_flight = True
                assert state["migration"] is not None
                done = state["migration"]["done"]
                assert done == sorted(set(done))
            if ex.migrations and ex.migrations[-1].completed_at >= 0:
                break
        final = recover(root)
        assert bool(eng.result().reorg_indices) == (order == "shuffled")
        if eng.result().reorg_indices:
            assert saw_in_flight
            assert final["migration"] is None
        with open(os.path.join(backend._serving_store.root,
                               "manifest.json")) as f:
            assert final["manifest"] == json.load(f)
        with open(os.path.join(root, "wal", "log.jsonl"), "rb") as f:
            logs[pkg] = f.read()
        backend.close()
    assert logs["port"] == logs["ref"]
    ops = {json.loads(ln)["op"] for ln in logs["port"].splitlines()}
    assert ops == ({"init", "migration_begin", "migration_apply", "swap"}
                   if order == "shuffled" else {"init"})


@pytest.mark.parametrize("scenario", sorted(rc.INGEST_SCENARIOS))
def test_fleet_mixed_stream_both_lanes_bit_identical(scenario, tenant_data,
                                                     bounds):
    """Every ingest scenario on both of the port's batched lanes: mixed
    query/append traces (compactions included) equal the stepwise loop
    and ``repro``'s bit for bit."""
    lo, hi = bounds
    kw = dict(num_tenants=2, queries_per_tenant=100, seed=9)
    ref_fs = rc.make_ingest_scenario(scenario, lo, hi, **kw)
    fs = tc.make_ingest_scenario(scenario, lo, hi, **kw)
    ref_fleet = re_.FleetEngine(
        {tid: simple_engine("ref", tenant_data[tid], ingest={})
         for tid in fs.tenant_ids}, re_.UnlimitedScheduler())
    want = ref_fleet.run(ref_fs)
    for lane in LANES:
        f = te.FleetEngine({tid: simple_engine("port", tenant_data[tid],
                                               ingest={})
                            for tid in fs.tenant_ids},
                           te.UnlimitedScheduler())
        got = f.run_batched(fs, compute=lane)
        for tid in fs.tenant_ids:
            assert_same_trace(got.per_tenant[tid], want.per_tenant[tid])
            assert (f.tenant(tid).compaction_indices
                    == ref_fleet.tenant(tid).compaction_indices)


# ---------------------------------------------------------------------------
# The growing device table and the block estimates under ingest
# ---------------------------------------------------------------------------

def test_table_grows_in_place_within_capacity(tmp_path):
    """The first append moves the table into a buffer of spare capacity;
    appends within it copy only the batch (the prefix's storage stays
    where it is), and ``data`` always equals ``np.concatenate`` of the
    same rows.  The caller's table and a writer's earlier view are never
    written."""
    rng = np.random.default_rng(20)
    data = rng.uniform(0, 100, size=(300, 3))
    batches = [rng.uniform(0, 100, size=(n, 3)) for n in (40, 100, 150, 20,
                                                          400)]
    for make in (lambda d: te.InMemoryBackend(d),
                 lambda d: te.DiskBackend(d, str(tmp_path / "disk"),
                                          background=False)):
        tdata = torch.as_tensor(data.copy())
        backend = make(tdata)
        backend.enable_ingest()
        want = data
        views = []
        for k, rows in enumerate(batches):
            before = backend.data
            views.append((before, before.clone()))
            backend.ingest_rows(rows)
            want = np.concatenate([want, rows])
            assert np.array_equal(backend.data.numpy(), want)
            cap = len(backend._buffer)
            if k > 0 and len(want) <= prev_cap:
                assert (backend.data.untyped_storage().data_ptr()
                        == before.untyped_storage().data_ptr())
                assert backend.data.data_ptr() == before.data_ptr()
            prev_cap = cap
        assert len(backend._buffer) >= len(want)
        assert np.array_equal(tdata.numpy(), data)       # caller's table
        for view, copy in views:
            assert torch.equal(view, copy)               # earlier views
        assert [b.start for b in backend.delta_log.batches] == list(
            np.cumsum([300] + [len(b) for b in batches[:-1]]))
        if isinstance(backend, te.DiskBackend):
            backend.close()


def test_ingest_between_run_blocks_is_never_served_a_stale_row():
    """``run`` scores its estimates a block of queries per scan; an ingest
    landing between two of a block's rows re-registers the serving shadow,
    which bumps ``StateMatrix.version``, so every later estimate comes
    from a block scanned after the append.  The trace equals the ``step``
    loop's with the same ingest, and ``repro``'s."""
    rng = np.random.default_rng(21)
    data = np.sort(rng.uniform(0, 100, size=(1500, 3)), axis=0)
    queries = queries_for(rng, data, 120)
    rows = {37: rng.uniform(0, 100, size=(300, 3)),
            90: rng.uniform(0, 100, size=(200, 3))}

    def hooked(pkg, eng):
        """Append ``rows[k]`` as the decision of query ``k`` begins."""
        inner = eng.policy.decide

        def decide(i, query, backend):
            if i in rows:
                before = (backend.state_matrix.version
                          if pkg == "port" else None)
                eng.ingest(rows[i])
                if pkg == "port":
                    assert backend.state_matrix.version > before
                    versions.append(backend.state_matrix.version)
            return inner(i, query, backend)
        eng.policy.decide = decide
        return eng

    traces = {}
    for pkg, mode in (("ref", "step"), ("port", "step"), ("port", "run")):
        versions = []
        eng = hooked(pkg, simple_engine(pkg, data,
                                        ingest={"auto_compact": False},
                                        alpha=1.5, sort_col=0))
        qs = port_queries(queries) if pkg == "port" else queries
        if mode == "run":
            seen = []
            real = te.backends.BlockEstimates.costs

            def costs(self, matrix):
                out = real(self, matrix)
                seen.append((self.cursor, self._block[0], self._block[1],
                             matrix.version))
                return out
            te.backends.BlockEstimates.costs = costs
            try:
                eng.run(qs)
            finally:
                te.backends.BlockEstimates.costs = real
            # every consumed row was scanned at the plane's current version
            assert seen and all(v == m for _, _, v, m in seen)
            for k in rows:
                after = [s for s in seen if s[0] >= k]
                assert after and all(start >= k for _, start, _, _ in after)
            assert len(versions) == len(rows)
        else:
            for q in qs:
                eng.step(q)
        traces[pkg, mode] = (eng.result(), eng.ingest_stats())
    for key in (("port", "step"), ("port", "run")):
        assert_same_trace(traces[key][0], traces["ref", "step"][0])
        assert traces[key][1] == traces["ref", "step"][1]


# ---------------------------------------------------------------------------
# The typed event surface with ingest events (tests/test_events.py)
# ---------------------------------------------------------------------------

def some_query(c=5, seed=0):
    rng = np.random.default_rng(seed)
    lo = np.full(c, -np.inf)
    hi = np.full(c, np.inf)
    lo[0], hi[0] = np.sort(rng.uniform(0, 100, size=2))
    return tc.Query(lo=lo, hi=hi)


def test_typed_events_are_tuple_compatible():
    q = some_query()
    batch = tc.IngestBatch(rows=np.zeros((3, 5)))
    qe = tc.QueryEvent("a", q)
    ie = tc.IngestEvent("b", batch)
    tid, payload = qe
    assert (tid, payload) == ("a", q) and qe[1] is q
    assert isinstance(qe, tuple) and isinstance(ie, tuple)
    assert ie == ("b", batch)
    assert qe.tenant_id == "a" and qe.query is q
    assert ie.tenant_id == "b" and ie.batch is batch
    assert batch.num_rows == 3 and batch.batch_id == -1


def test_as_event_passes_typed_through_without_warning():
    qe = tc.QueryEvent("a", some_query())
    ie = tc.IngestEvent("a", tc.IngestBatch(rows=np.zeros((2, 5))))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tc.as_event(qe) is qe
        assert tc.as_event(ie) is ie


def test_as_event_tuple_shim_warns_deprecation():
    q = some_query()
    with pytest.warns(DeprecationWarning, match="QueryEvent"):
        ev = tc.as_event(("a", q))
    assert ev == tc.QueryEvent("a", q) and type(ev) is tc.QueryEvent
    batch = tc.IngestBatch(rows=np.zeros((2, 5)))
    with pytest.warns(DeprecationWarning, match="IngestEvent"):
        ev = tc.as_event(["b", batch])
    assert ev == tc.IngestEvent("b", batch) and type(ev) is tc.IngestEvent


def test_streams_emit_typed_events(bounds):
    lo, hi = bounds
    fs = tc.make_drift_scenario("sudden_shift", lo, hi, num_tenants=2,
                                queries_per_tenant=20, seed=3)
    assert all(type(ev) is tc.QueryEvent for ev in fs)
    ms = tc.make_ingest_scenario("mixed_rw", lo, hi, num_tenants=2,
                                 queries_per_tenant=20, seed=3)
    assert {type(ev) for ev in ms} == {tc.QueryEvent, tc.IngestEvent}
    ref = rc.make_ingest_scenario("mixed_rw", lo, hi, num_tenants=2,
                                  queries_per_tenant=20, seed=3)
    assert ([type(ev).__name__ for ev in ms]
            == [type(ev).__name__ for ev in ref])


def test_drain_collect_returns_step_results(tenant_data):
    d = tenant_data["t0"]
    out = {}
    for pkg in PKGS:
        core, eng, _ = PKGS[pkg]
        data = table(pkg, d)
        fleet = eng.FleetEngine({"a": eng.LayoutEngine(
            eng.OreoPolicy(data, core.build_default_layout(0, data, 8),
                           core.make_generator("qdtree"),
                           core.OreoConfig(alpha=10.0, seed=2, delta=5)),
            eng.InMemoryBackend(data), delta=5, ingest=eng.IngestConfig())})
        q = some_query() if pkg == "port" else rc.Query(
            lo=some_query().lo, hi=some_query().hi)
        fleet.submit(core.QueryEvent("a", q))
        fleet.submit(core.IngestEvent("a", core.IngestBatch(
            rows=d[:4].copy())))
        fleet.submit(core.QueryEvent("a", q))
        got = fleet.drain(collect=True)
        assert [type(r) for r in got] == [eng.FleetStepResult] * 3
        assert got[0].step is not None and got[0].step.query is q
        assert got[1].step is None          # ingest events: no observation
        assert got[1].tick == 2 and got[2].tick == 3
        out[pkg] = ([r.step.query_cost for r in (got[0], got[2])],
                    fleet.tenant("a").ingest_stats())
    assert out["port"] == out["ref"]


def test_engine_exports_event_surface():
    import repro.engine as ref_engine
    for name in ("Event", "QueryEvent", "IngestEvent", "as_event",
                 "FleetEngine", "LayoutEngine", "DebtMeter", "DeltaBatch",
                 "DeltaLog", "IngestConfig"):
        assert name in te.__all__ and name in ref_engine.__all__
        assert getattr(te, name) is not None
    assert te.QueryEvent is tc.QueryEvent
    assert te.IngestEvent is tc.IngestEvent
    import repro.core as ref_core
    for name in ("IngestBatch", "IngestStream", "INGEST_SCENARIOS",
                 "make_ingest_scenario"):
        assert name in tc.__all__ and name in ref_core.__all__
