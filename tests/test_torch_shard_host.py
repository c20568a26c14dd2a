"""The port's process-parallel shard set (``repro_torch.launch.shard_host``)
on the CPU.

Two spawned shard processes under the router's placement must give the
merged result of the port's inline ``FleetRouter`` (itself held against
``repro`` in ``tests/test_torch_router.py``) and of ``repro``'s, bit for
bit; a tenant migrates across processes (its engine crosses as a file the
parent never opens) and keeps serving with traces and ledgers
equal to the unsharded fleet's; a worker whose factory cannot reach its
device fails with ``ShardHostError``.

The workers import this module to unpickle its factories, so it imports
``torch`` and ``repro_torch`` only: ``repro`` (and with it JAX) is
imported inside the tests, which run in the parent alone.
"""
import functools

import numpy as np
import pytest
import torch

import repro_torch.core as tc
import repro_torch.engine as te
from repro_torch.core import layout_manager as tlm
from repro_torch.launch import shard_host


def tenant_engine(seed: int, device: str = "cpu", incremental: bool = False):
    """A module-level factory (spawned workers unpickle it by name): one
    OREO tenant of tests/test_router.py over a table on ``device``."""
    data = torch.as_tensor(np.random.default_rng(700 + seed).uniform(
        0, 100, size=(2_000, 5)), device=device)
    cfg = tc.OreoConfig(alpha=10.0, seed=2, delta=5,
                        manager=tlm.LayoutManagerConfig(
                            target_partitions=8, window_size=60,
                            gen_every=30))
    policy = te.OreoPolicy(data, tc.build_default_layout(0, data, 8),
                           tc.make_generator("qdtree"), cfg)
    return te.LayoutEngine(policy, te.InMemoryBackend(data), delta=5,
                           incremental=incremental,
                           rows_per_tick=40 if incremental else None)


def factories(n, **kw):
    return {f"t{t}": functools.partial(tenant_engine, t, **kw)
            for t in range(n)}


BOUNDS = (np.zeros(5), np.full(5, 100.0))


def fleet_trace(res):
    return ({tid: (r.query_costs.tobytes(), tuple(r.reorg_indices),
                   r.state_seq.tobytes())
             for tid, r in sorted(res.per_tenant.items())},
            res.ticks, res.swaps_deferred, res.deferred_ticks)


def no_tensors(obj) -> bool:
    if isinstance(obj, torch.Tensor):
        return False
    if isinstance(obj, dict):
        return all(no_tensors(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return all(no_tensors(v) for v in obj)
    if hasattr(obj, "__dict__"):
        return no_tensors(vars(obj))
    return True


def test_process_shard_set_matches_inline_router():
    """2 spawned shards == the inline router == repro's router, then one
    cross-process migration and more traffic."""
    import repro.core as rc
    import repro.engine as re_
    from repro.core import layout_manager as rlm

    def ref_engine(seed):
        data = np.random.default_rng(700 + seed).uniform(
            0, 100, size=(2_000, 5))
        cfg = rc.OreoConfig(alpha=10.0, seed=2, delta=5,
                            manager=rlm.LayoutManagerConfig(
                                target_partitions=8, window_size=60,
                                gen_every=30))
        return re_.LayoutEngine(re_.OreoPolicy(
            data, rc.build_default_layout(0, data, 8),
            rc.make_generator("qdtree"), cfg), re_.InMemoryBackend(data),
            delta=5)

    fs = tc.make_drift_scenario("sudden_shift", *BOUNDS, num_tenants=4,
                                queries_per_tenant=40, seed=7)
    ref_fs = rc.make_drift_scenario("sudden_shift", *BOUNDS, num_tenants=4,
                                    queries_per_tenant=40, seed=7)
    facs = factories(4)
    inline = te.FleetRouter({tid: f() for tid, f in facs.items()},
                            num_shards=2)
    want = re_.FleetRouter({tid: ref_engine(t) for t, tid in
                            enumerate(facs)}, num_shards=2).run(ref_fs)
    ref = inline.run(fs)
    assert fleet_trace(ref) == fleet_trace(want)
    with shard_host.ProcessShardSet(facs, num_shards=2) as procs:
        assert procs.shard_ids == inline.shard_ids
        for tid in facs:
            assert procs.shard_of(tid) == inline.shard_of(tid)
        for ev in fs:
            procs.submit(ev)
        assert procs.queue_depth == len(fs)
        with pytest.raises(ValueError, match="compute lane"):
            procs.drain(batched=True, compute="numpy")
        assert procs.drain() == len(fs)
        got = procs.result()
        assert fleet_trace(got) == fleet_trace(ref)
        assert got.scheduler_stats == {"shards": {
            sid: inline.shard(sid).result().scheduler_stats
            for sid in inline.shard_ids}}
        assert no_tensors(got) and no_tensors(procs.stats())
        tid = fs.tenant_ids[0]
        dst = next(s for s in procs.shard_ids if s != procs.shard_of(tid))
        assert procs.migrate_tenant(tid, dst)
        assert not procs.migrate_tenant(tid, dst)
        assert procs.shard_of(tid) == dst
        extra = tc.make_drift_scenario("sudden_shift", *BOUNDS,
                                       num_tenants=4, queries_per_tenant=10,
                                       seed=8)
        for ev in extra:
            procs.submit(ev)
        assert procs.drain() == len(extra)
        stats = procs.stats()
        assert stats["migrations"] == 1
        assert stats["shards"][dst]["tenants"] == len(
            [t for t in facs if procs.shard_of(t) == dst])
        assert procs.host(dst).max_memory_allocated() == 0    # CPU tables
        assert procs.host(dst).kernel_launches(reset=True) == {
            "pruning": 0, "fleet_scan": 0, "decision_fused": 0,
            "move_score": 0}
    assert procs._hosts == {}


def test_cross_process_migration_of_an_in_flight_incremental_tenant():
    """Incremental tenants with a tight row budget: migrating every tenant
    across processes mid-stream (engines, partial ledgers and queued
    events crossing as a file) keeps traces and ledgers equal to the
    unsharded fleet's; a CUDA factory without a card fails its worker."""
    fs = tc.make_drift_scenario("sudden_shift", *BOUNDS, num_tenants=4,
                                queries_per_tenant=90, seed=11)
    facs = factories(4, incremental=True)
    unsharded = te.FleetEngine({tid: f() for tid, f in facs.items()})
    want = unsharded.run(fs)
    events = list(fs)
    # Cut where a partially charged migration is in flight (the workers'
    # state when the tenants move).
    probe = te.FleetEngine({tid: f() for tid, f in facs.items()})
    cut = 0
    while not any(0.0 < getattr(probe.tenant(tid).reorg_executor.active,
                                "charged", 0.0) < 10.0
                  for tid in fs.tenant_ids):
        probe.run(events[cut:cut + 1])
        cut += 1
    assert cut < len(events) - 40
    with shard_host.ProcessShardSet(facs, num_shards=2) as procs:
        for ev in events[:cut]:
            procs.submit(ev)
        procs.drain()
        for ev in events[cut:cut + 20]:         # queued, then migrated
            procs.submit(ev)
        for tid in fs.tenant_ids:
            dst = next(s for s in procs.shard_ids
                       if s != procs.shard_of(tid))
            assert procs.migrate_tenant(tid, dst)
        for ev in events[cut + 20:]:
            procs.submit(ev)
        procs.drain()
        got = procs.result()
        # Each engine's ledgers, fetched the way a migration carries them.
        moved = {tid: shard_host._unspool_engine(
            procs.host(procs.shard_of(tid)).migrate_out(tid))[0]
            for tid in fs.tenant_ids}
    assert fleet_trace(got)[0] == fleet_trace(want)[0]
    for tid, engine in moved.items():
        assert ([m.charges for m in engine.reorg_executor.migrations]
                == [m.charges for m in
                    unsharded.tenant(tid).reorg_executor.migrations])
    assert any(unsharded.tenant(tid).reorg_executor.migrations
               for tid in fs.tenant_ids)
    if not torch.cuda.is_available():
        with pytest.raises(shard_host.ShardHostError, match="CUDA"):
            shard_host.ProcessShardSet(factories(1, device="cuda"),
                                       num_shards=1)
