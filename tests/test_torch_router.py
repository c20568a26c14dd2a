"""The port's routing plane (``repro_torch.engine.router``, the fleet's
migration hooks and the EventSink protocol) held against the JAX
package's, on the CPU.

Mirrors ``tests/test_router.py``: each case drives ``repro`` and the port
through the same seeded tables and streams (the port's tables as CPU
tensors) and compares per-tenant ``query_costs``, ``reorg_indices`` and
``state_seq``, ticks, deferrals, scheduler stats, placements and every
migration's charge ledger bit for bit, on top of the reference test's own
equalities (a 1-shard router is a plain fleet, sharding under the
unlimited scheduler is invisible, live migration keeps traces and
ledgers).  The process-parallel shard set is held in
``tests/test_torch_shard_host.py``.
"""
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.engine as re_
import repro.serve as rs
from repro.core import layout_manager as rlm

import repro_torch.core as tc
import repro_torch.engine as te
import repro_torch.serve as ts
from repro_torch.core import layout_manager as tlm
from repro_torch.kernels.decision_fused import decision_fused
from repro_torch.kernels.fleet_scan import fleet_scan

PKGS = {"ref": (rc, re_, rlm, rs), "port": (tc, te, tlm, ts)}

SCHEDULER_SPECS = {
    "unlimited": lambda eng: eng.SchedulerSpec.unlimited(),
    "k1": lambda eng: eng.SchedulerSpec.k_concurrent(1),
    "bucket": lambda eng: eng.SchedulerSpec.token_bucket(
        rate=0.01, capacity=1.0, initial=0.0),
}
DRIFT_SCENARIOS = ["sudden_shift", "gradual_drift", "cyclic_diurnal",
                   "flash_crowd", "template_churn"]
INGEST_SCENARIOS = ["trickle", "append_heavy", "mixed_rw", "ingest_burst",
                    "bulk_load"]
PERMISSIVE = dict(queue_capacity=100_000, breaker_open_frac=None,
                  record_latency=False)


@pytest.fixture(scope="module")
def tenant_data():
    return {f"t{t}": np.random.default_rng(700 + t).uniform(
        0, 100, size=(2_000, 5)) for t in range(8)}


@pytest.fixture(scope="module")
def bounds(tenant_data):
    lo = np.min([d.min(0) for d in tenant_data.values()], axis=0)
    hi = np.max([d.max(0) for d in tenant_data.values()], axis=0)
    return lo, hi


def oreo_engine(pkg, data, ingest=False, incremental=False,
                rows_per_tick=None, alpha=10.0, delta=5, seed=2):
    core, eng, lm, _ = PKGS[pkg]
    if pkg == "port":
        data = torch.as_tensor(data)
    cfg = core.OreoConfig(alpha=alpha, seed=seed, delta=delta,
                          manager=lm.LayoutManagerConfig(
                              target_partitions=8, window_size=60,
                              gen_every=30))
    policy = eng.OreoPolicy(data, core.build_default_layout(0, data, 8),
                            core.make_generator("qdtree"), cfg)
    return eng.LayoutEngine(policy, eng.InMemoryBackend(data),
                            delta=cfg.delta,
                            ingest=eng.IngestConfig() if ingest else None,
                            incremental=incremental,
                            rows_per_tick=rows_per_tick)


def make_stream(pkg, scenario, lo, hi, num_tenants=2, qpt=60, seed=7):
    core = PKGS[pkg][0]
    make = (core.make_drift_scenario if scenario in DRIFT_SCENARIOS
            else core.make_ingest_scenario)
    return make(scenario, lo, hi, num_tenants=num_tenants,
                queries_per_tenant=qpt, seed=seed)


def make_tenants(pkg, fs, tenant_data, scenario, **engine_kw):
    return {tid: oreo_engine(pkg, tenant_data[tid],
                             ingest=scenario in INGEST_SCENARIOS,
                             **engine_kw)
            for tid in fs.tenant_ids}


def both(fn):
    """``fn(pkg)`` for the reference and the port."""
    return {pkg: fn(pkg) for pkg in PKGS}


def run_trace(res):
    return (res.query_costs.tobytes(), tuple(res.reorg_indices),
            res.state_seq.tobytes())


def fleet_trace(res):
    """Everything of a FleetResult that must be bitwise equal."""
    return ({tid: run_trace(r) for tid, r in res.per_tenant.items()},
            res.ticks, res.swaps_deferred, res.deferred_ticks,
            res.scheduler, res.scheduler_stats)


def assert_same_trace(a, b):
    assert run_trace(a) == run_trace(b)


def ledgers(engine):
    return [m.charges for m in engine.reorg_executor.migrations]


# ---------------------------------------------------------------------------
# Golden identity: 1-shard router == plain fleet == the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", DRIFT_SCENARIOS + INGEST_SCENARIOS)
def test_one_shard_router_bit_identical_to_fleet(scenario, tenant_data,
                                                 bounds):
    """The port's 1-shard router equals repro's plain fleet: traces,
    ticks, deferrals, scheduler name and stats (the port's fleet equals
    repro's in tests/test_torch_fleet.py)."""
    lo, hi = bounds
    for sched, spec in SCHEDULER_SPECS.items():
        fs = make_stream("ref", scenario, lo, hi)
        want = re_.FleetEngine(make_tenants("ref", fs, tenant_data,
                                            scenario),
                               spec(re_).build()).run(fs)
        fs = make_stream("port", scenario, lo, hi)
        router = te.FleetRouter(make_tenants("port", fs, tenant_data,
                                             scenario),
                                num_shards=1, scheduler=spec(te))
        assert fleet_trace(router.run(fs)) == fleet_trace(want), sched


def test_multi_shard_router_matches_unsharded_unlimited(tenant_data,
                                                        bounds):
    lo, hi = bounds

    def run(pkg):
        eng = PKGS[pkg][1]
        fs = make_stream(pkg, "sudden_shift", lo, hi, num_tenants=8,
                         qpt=80)
        ref = eng.FleetEngine(make_tenants(pkg, fs, tenant_data,
                                           "sudden_shift")).run(fs)
        router = eng.FleetRouter(make_tenants(pkg, fs, tenant_data,
                                              "sudden_shift"), num_shards=4)
        got = router.run(fs)
        assert len(set(router.placement().values())) > 1
        for tid in fs.tenant_ids:
            assert_same_trace(ref.per_tenant[tid], got.per_tenant[tid])
        assert got.ticks == ref.ticks
        assert set(got.scheduler_stats["shards"]) == set(router.shard_ids)
        return router.placement(), fleet_trace(got)
    got = both(run)
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("lane", ["fleet_scan", "decision_fused"])
def test_router_run_batched_matches_run(lane, tenant_data, bounds):
    lo, hi = bounds
    want = None
    for pkg in ("ref", "port"):
        eng = PKGS[pkg][1]
        fs = make_stream(pkg, "gradual_drift", lo, hi, num_tenants=4, seed=3)
        a = eng.FleetRouter(make_tenants(pkg, fs, tenant_data,
                                         "gradual_drift"),
                            num_shards=2).run(fs)
        if pkg == "ref":
            want = fleet_trace(a)
            continue
        assert fleet_trace(a) == want
        before = (fleet_scan.scan_fleet.launches,
                  decision_fused.fused_decision.launches)
        router = eng.FleetRouter(make_tenants(pkg, fs, tenant_data,
                                              "gradual_drift"), num_shards=2)
        b = router.run_batched(fs, compute=lane)
        for tid in fs.tenant_ids:
            assert_same_trace(a.per_tenant[tid], b.per_tenant[tid])
        for sid in router.shard_ids:
            assert router.shard(sid).fleet_matrix.compute_backend == lane
        assert (fleet_scan.scan_fleet.launches,
                decision_fused.fused_decision.launches) == before
        with pytest.raises(ValueError, match="compute lane"):
            router.drain(compute="numpy")


def test_router_topology_and_validation(tenant_data):
    with pytest.raises(ValueError, match="at least one tenant"):
        te.FleetRouter({})
    tenants = {tid: oreo_engine("port", d) for tid, d in tenant_data.items()}
    router = te.FleetRouter(tenants, num_shards=4)
    want = re_.FleetRouter({tid: oreo_engine("ref", d)
                            for tid, d in tenant_data.items()},
                           num_shards=4)
    assert router.shard_ids == ["s0", "s1", "s2", "s3"]
    assert router.num_shards == 4
    assert sorted(router.tenant_ids) == sorted(tenant_data)
    placement = router.placement()
    assert placement == want.placement()
    for tid, sid in placement.items():
        assert router.shard_of(tid) == sid
        assert tid in router.shard(sid).tenant_ids
        assert router.tenant(tid) is tenants[tid]
    with pytest.raises(KeyError):
        router.shard_of("nope")
    with pytest.raises(KeyError):
        router.submit(tc.workload.QueryEvent("nope", tc.workload.Query(
            np.zeros(5), np.ones(5))))
    with pytest.raises(KeyError):
        router.migrate_tenant("t0", "s9")


def test_router_rejects_mixed_incremental_modes(tenant_data):
    tenants = {"t0": oreo_engine("port", tenant_data["t0"]),
               "t1": oreo_engine("port", tenant_data["t1"],
                                 incremental=True)}
    with pytest.raises(ValueError, match="mix incremental and atomic"):
        te.FleetRouter(tenants, num_shards=2)


# ---------------------------------------------------------------------------
# Live migration: traces and charge ledgers survive re-sharding bitwise
# ---------------------------------------------------------------------------

def test_migration_mid_stream_preserves_traces_bitwise(tenant_data, bounds):
    lo, hi = bounds

    def run(pkg):
        eng = PKGS[pkg][1]
        fs = make_stream(pkg, "sudden_shift", lo, hi, num_tenants=8,
                         qpt=80)
        ref = eng.FleetEngine(make_tenants(pkg, fs, tenant_data,
                                           "sudden_shift")).run(fs)
        router = eng.FleetRouter(make_tenants(pkg, fs, tenant_data,
                                              "sudden_shift"), num_shards=4)
        events = list(fs)
        half = len(events) // 2
        for ev in events[:half]:
            router.submit(ev)
        router.drain()
        moved = []
        for tid in fs.tenant_ids[:4]:
            src = router.shard_of(tid)
            dst = next(s for s in router.shard_ids if s != src)
            assert router.migrate_tenant(tid, dst)
            assert router.shard_of(tid) == dst
            moved.append(tid)
        assert router.migrations == 4
        assert not router.migrate_tenant(moved[0], router.shard_of(moved[0]))
        for ev in events[half:]:
            router.submit(ev)
        router.drain()
        got = router.result()
        for tid in fs.tenant_ids:
            assert_same_trace(ref.per_tenant[tid], got.per_tenant[tid])
        stats = router.stats()
        assert stats["migrations"] == 4 and stats["queue_depth"] == 0
        return (fleet_trace(got), router.directory.overrides,
                stats["overrides"])
    got = both(run)
    assert got["port"] == got["ref"]


def test_migration_carries_queued_events(tenant_data, bounds):
    lo, hi = bounds

    def run(pkg):
        eng = PKGS[pkg][1]
        fs = make_stream(pkg, "cyclic_diurnal", lo, hi, num_tenants=4,
                         seed=5)
        ref = eng.FleetEngine(make_tenants(pkg, fs, tenant_data,
                                           "cyclic_diurnal")).run(fs)
        router = eng.FleetRouter(make_tenants(pkg, fs, tenant_data,
                                              "cyclic_diurnal"),
                                 num_shards=2)
        for ev in fs:
            router.submit(ev)
        tid = fs.tenant_ids[0]
        src = router.shard_of(tid)
        dst = next(s for s in router.shard_ids if s != src)
        assert router.migrate_tenant(tid, dst)
        router.drain()
        got = router.result()
        for t in fs.tenant_ids:
            assert_same_trace(ref.per_tenant[t], got.per_tenant[t])
        return fleet_trace(got)
    got = both(run)
    assert got["port"] == got["ref"]


def test_remove_tenant_refuses_queued_inbox_events(tenant_data, bounds):
    lo, hi = bounds
    fs = make_stream("port", "sudden_shift", lo, hi, qpt=10, seed=1)
    fleet = te.FleetEngine(make_tenants("port", fs, tenant_data,
                                        "sudden_shift"))
    for ev in fs:
        fleet.submit(ev)
    tid = fs.tenant_ids[0]
    with pytest.raises(ValueError, match="take_inbox"):
        fleet.remove_tenant(tid)
    inbox = fleet.take_inbox(tid)
    assert [ev.tenant_id for ev in inbox] == [tid] * len(inbox)
    assert fleet.queue_depth == len(list(fs)) - len(inbox)
    fleet.remove_tenant(tid)
    assert tid not in fleet.tenant_ids


# ---------------------------------------------------------------------------
# Detach mid-(incremental)-migration
# ---------------------------------------------------------------------------

def drive_until_in_flight(fleet, tid, events):
    events = list(events)
    while events:
        fleet.submit(events.pop(0))
        fleet.drain()
        active = fleet.tenant(tid).reorg_executor.active
        if active is not None and 0.0 < active.charged < active.alpha:
            return events
    raise AssertionError("no partially-charged migration materialized")


def test_detach_mid_migration_transplants_partial_ledger(tenant_data,
                                                         bounds):
    lo, hi = bounds
    tid = "t0"

    def run(pkg):
        eng = PKGS[pkg][1]
        events = list(make_stream(pkg, "sudden_shift", lo, hi,
                                  num_tenants=1, qpt=200, seed=9))

        def make():
            return eng.FleetEngine({tid: oreo_engine(
                pkg, tenant_data[tid], incremental=True, rows_per_tick=40)})

        ref_fleet = make()
        ref = ref_fleet.run(events)
        fleet1 = make()
        remaining = drive_until_in_flight(fleet1, tid, events)
        record = fleet1.tenant(tid).reorg_executor.active
        partial = list(record.charges)
        engine = fleet1.remove_tenant(tid)
        assert tid not in fleet1.tenant_ids
        assert engine.reorg_executor.active is record
        fleet2 = eng.FleetEngine({}, incremental=True)
        fleet2.add_tenant(tid, engine)
        for ev in remaining:
            fleet2.submit(ev)
        fleet2.drain()
        got = fleet2.result()
        assert_same_trace(ref.per_tenant[tid], got.per_tenant[tid])
        ref_migs = ref_fleet.tenant(tid).reorg_executor.migrations
        got_migs = fleet2.tenant(tid).reorg_executor.migrations
        assert [m.charges for m in ref_migs] == [m.charges for m in got_migs]
        for m in got_migs:
            if m.completed_at >= 0:
                assert m.charged == m.alpha
        assert any(m.charges[:len(partial)] == partial for m in got_migs)
        return (run_trace(got.per_tenant[tid]), partial,
                [(m.charges, m.completed_at) for m in got_migs])
    got = both(run)
    assert got["port"] == got["ref"]


def test_detach_with_finish_closes_ledger_on_alpha(tenant_data, bounds):
    lo, hi = bounds
    tid = "t0"

    def run(pkg):
        eng = PKGS[pkg][1]
        events = make_stream(pkg, "sudden_shift", lo, hi, num_tenants=1,
                             qpt=200, seed=9)
        fleet1 = eng.FleetEngine({tid: oreo_engine(
            pkg, tenant_data[tid], incremental=True, rows_per_tick=40)})
        remaining = drive_until_in_flight(fleet1, tid, list(events))
        record = fleet1.tenant(tid).reorg_executor.active
        detach_index = fleet1.tenant(tid)._index
        engine = fleet1.remove_tenant(tid, finish=True)
        assert engine.reorg_executor.active is None
        assert record.charged == record.alpha
        assert record.completed_at == detach_index
        assert sum(rows for _, rows, _ in record.charges) == record.total_rows
        fleet2 = eng.FleetEngine({}, incremental=True)
        fleet2.add_tenant(tid, engine)
        for ev in remaining:
            fleet2.submit(ev)
        fleet2.drain()
        res = fleet2.result().per_tenant[tid]
        costs = np.asarray(res.query_costs)
        assert np.all((costs >= 0) & (costs <= 1))
        for mig in fleet2.tenant(tid).reorg_executor.migrations:
            if mig.completed_at >= 0:
                assert mig.charged == mig.alpha
        return run_trace(res), record.charges, ledgers(fleet2.tenant(tid))
    got = both(run)
    assert got["port"] == got["ref"]


def test_router_migration_of_incremental_tenants_bitwise(tenant_data,
                                                         bounds):
    lo, hi = bounds

    def run(pkg):
        eng = PKGS[pkg][1]
        fs = make_stream(pkg, "sudden_shift", lo, hi, num_tenants=4,
                         qpt=100, seed=11)

        def make():
            return {tid: oreo_engine(pkg, tenant_data[tid], incremental=True,
                                     rows_per_tick=60)
                    for tid in fs.tenant_ids}

        ref_fleet = eng.FleetEngine(make())
        ref = ref_fleet.run(fs)
        router = eng.FleetRouter(make(), num_shards=2)
        events = list(fs)
        third = len(events) // 3
        for ev in events[:third]:
            router.submit(ev)
        router.drain()
        for tid in fs.tenant_ids:
            src = router.shard_of(tid)
            dst = next(s for s in router.shard_ids if s != src)
            router.migrate_tenant(tid, dst)
        for ev in events[third:]:
            router.submit(ev)
        router.drain()
        got = router.result()
        for tid in fs.tenant_ids:
            assert_same_trace(ref.per_tenant[tid], got.per_tenant[tid])
            assert (ledgers(ref_fleet.tenant(tid))
                    == ledgers(router.tenant(tid)))
        return fleet_trace(got), {tid: ledgers(router.tenant(tid))
                                  for tid in fs.tenant_ids}
    got = both(run)
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# EventSink: the serving tier sits over a fleet or a router unchanged
# ---------------------------------------------------------------------------

def test_fleet_and_router_satisfy_event_sink(tenant_data):
    fleet = te.FleetEngine({"t0": oreo_engine("port", tenant_data["t0"])})
    router = te.FleetRouter({"t0": oreo_engine("port", tenant_data["t0"])})
    assert isinstance(fleet, te.EventSink)
    assert isinstance(router, te.EventSink)
    assert not isinstance(object(), te.EventSink)
    assert fleet.shard_fleets() == [fleet]
    assert router.shard_fleets() == [router.shard("s0")]


def test_frontend_over_one_shard_router_matches_fleet(tenant_data, bounds):
    lo, hi = bounds
    for scenario in ("sudden_shift", "trickle"):
        def run(pkg):
            _, eng, _, serve = PKGS[pkg]
            fs = make_stream(pkg, scenario, lo, hi)
            fleet = eng.FleetEngine(make_tenants(pkg, fs, tenant_data,
                                                 scenario))
            ref = serve.ServeFrontend(
                fleet, serve.FrontendConfig(**PERMISSIVE)).run(fs)
            router = eng.FleetRouter(make_tenants(pkg, fs, tenant_data,
                                                  scenario))
            fe = serve.ServeFrontend(router,
                                     serve.FrontendConfig(**PERMISSIVE))
            got = fe.run(fs)
            assert fleet_trace(ref)[:1] == fleet_trace(got)[:1]
            assert ref.scheduler_stats == got.scheduler_stats
            return fleet_trace(got), fe.stats()
        got = both(run)
        assert got["port"] == got["ref"], scenario


def test_frontend_over_multi_shard_router(tenant_data, bounds):
    lo, hi = bounds

    def run(pkg):
        _, eng, _, serve = PKGS[pkg]
        fs = make_stream(pkg, "sudden_shift", lo, hi, num_tenants=4)
        fleet = eng.FleetEngine(make_tenants(pkg, fs, tenant_data,
                                             "sudden_shift"))
        ref = serve.ServeFrontend(fleet,
                                  serve.FrontendConfig(**PERMISSIVE)).run(fs)
        router = eng.FleetRouter(make_tenants(pkg, fs, tenant_data,
                                              "sudden_shift"), num_shards=2)
        fe = serve.ServeFrontend(router, serve.FrontendConfig(**PERMISSIVE))
        got = fe.run(fs)
        for tid in fs.tenant_ids:
            assert_same_trace(ref.per_tenant[tid], got.per_tenant[tid])
        assert len(fe.stats()["scheduler"]["shards"]) == 2
        return fleet_trace(got), fe.stats()
    got = both(run)
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# SchedulerSpec: declarative construction + the single-use instance shim
# ---------------------------------------------------------------------------

def test_scheduler_spec_builds_fresh_instances():
    spec = te.SchedulerSpec.k_concurrent(2)
    a, b = spec.build(), spec.build()
    assert a is not b
    assert isinstance(a, te.KConcurrentScheduler) and a.k == 2
    assert spec.name == a.name == re_.SchedulerSpec.k_concurrent(2).name
    bucket = te.SchedulerSpec.token_bucket(rate=0.5, capacity=2.0,
                                           initial=1.0)
    assert isinstance(bucket.build(), te.TokenBucketScheduler)
    assert isinstance(te.SchedulerSpec.unlimited().build(),
                      te.UnlimitedScheduler)
    with pytest.raises(ValueError, match="unknown scheduler kind"):
        te.SchedulerSpec(kind="nope").build()


def test_fleet_engine_accepts_spec(tenant_data):
    fleet = te.FleetEngine({"t0": oreo_engine("port", tenant_data["t0"])},
                           te.SchedulerSpec.k_concurrent(1))
    assert isinstance(fleet.scheduler, te.KConcurrentScheduler)


def test_instance_shim_warns_and_is_single_use():
    with pytest.warns(DeprecationWarning, match="SchedulerSpec"):
        shim = te.as_scheduler_spec(te.KConcurrentScheduler(1))
    assert isinstance(shim.build(), te.KConcurrentScheduler)
    with pytest.raises(ValueError, match="cannot be shared"):
        shim.build()
    with pytest.raises(TypeError):
        te.as_scheduler_spec(object())


def test_router_with_instance_scheduler_refuses_multiple_shards(
        tenant_data):
    def tenants():
        return {tid: oreo_engine("port", d)
                for tid, d in list(tenant_data.items())[:4]}

    with pytest.warns(DeprecationWarning):
        router = te.FleetRouter(tenants(), num_shards=1,
                                scheduler=te.KConcurrentScheduler(1))
    assert isinstance(router.shard("s0").scheduler, te.KConcurrentScheduler)
    with pytest.warns(DeprecationWarning):
        with pytest.raises(ValueError, match="cannot be shared"):
            te.FleetRouter(tenants(), num_shards=2,
                           scheduler=te.KConcurrentScheduler(1))


# ---------------------------------------------------------------------------
# Load-skew rebalancing: hysteresis-gated, at drain boundaries only
# ---------------------------------------------------------------------------

def test_rebalancer_moves_hot_tenant_once(tenant_data, bounds):
    lo, hi = bounds

    def run(pkg):
        core, eng, _, _ = PKGS[pkg]
        tenants = {tid: oreo_engine(pkg, d) for tid, d in tenant_data.items()}
        cfg = eng.RebalanceConfig(window=64, high=1.3, low=1.05)
        router = eng.FleetRouter(tenants, num_shards=2, rebalance=cfg)
        by_shard = {}
        for tid in router.tenant_ids:
            by_shard.setdefault(router.shard_of(tid), []).append(tid)
        hot = max(by_shard, key=lambda s: len(by_shard[s]))
        assert len(by_shard[hot]) >= 2
        rng = np.random.default_rng(3)

        def q():
            lo_q = rng.uniform(lo, hi)
            return core.workload.Query(lo_q, np.minimum(lo_q + 5.0, hi))

        for _ in range(3):
            for _ in range(cfg.window):
                for tid in by_shard[hot]:
                    router.submit(core.workload.QueryEvent(tid, q()))
            router.drain()
        assert router.migrations == 1
        overrides = router.directory.overrides
        assert len(overrides) == 1
        moved_tid, new_home = next(iter(overrides.items()))
        assert new_home != hot and router.shard_of(moved_tid) == new_home
        stats = router.stats()
        assert stats["rebalancer"]["moves_suggested"] == 1
        assert stats["rebalancer"]["armed"] is False
        router.submit(core.workload.QueryEvent(moved_tid, q()))
        assert router.shard(new_home).queue_depth == 1
        return overrides, stats["rebalancer"], fleet_trace(router.result())
    got = both(run)
    assert got["port"] == got["ref"]


def test_rebalancer_idle_without_config(tenant_data):
    router = te.FleetRouter({tid: oreo_engine("port", d)
                             for tid, d in tenant_data.items()},
                            num_shards=2)
    assert router.maybe_rebalance() is None
    assert router.stats()["rebalancer"] is None
