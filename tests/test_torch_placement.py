"""The port's placement layer (``repro_torch.engine.placement``) held against
the JAX package's, on the CPU.

Mirrors ``tests/test_placement.py``: the consistent-hash ring must place
every tenant on the same shard as ``repro``'s for every shard set and
replica count (and keep the structural-stability properties), directory
lookups and overrides must agree, the load meter must suggest the same
moves with the same counters, and a route → migrate → route round trip
through the port's router must keep traces and α ledgers bitwise equal to
the unsharded fleet and to ``repro``'s router.  Each property runs as a
seeded sweep and, where hypothesis is installed, as a hypothesis property.
"""
import itertools

import numpy as np
import pytest
import torch

import repro.core as rc
import repro.engine as re_

import repro_torch.core as tc
import repro_torch.engine as te

PKGS = {"ref": (rc, re_), "port": (tc, te)}


def random_shards(rng, max_shards=8):
    n = int(rng.integers(1, max_shards + 1))
    ids = rng.choice(40, size=n, replace=False)
    return [f"s{i}" for i in ids]


def random_tenants(rng, max_tenants=40):
    n = int(rng.integers(1, max_tenants + 1))
    return [f"tenant-{i}" for i in rng.choice(10_000, size=n,
                                              replace=False)]


# ---------------------------------------------------------------------------
# HashRing: the reference's placement, purity, structural stability
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ring_lookup_is_pure_and_equals_reference_sweep(seed):
    rng = np.random.default_rng(seed)
    for _ in range(10):
        shards = random_shards(rng)
        replicas = int(rng.integers(1, 65))
        a = te.HashRing(shards, replicas=replicas)
        b = te.HashRing(reversed(shards), replicas=replicas)
        want = re_.HashRing(shards, replicas=replicas)
        assert a._points == want._points
        for tid in random_tenants(rng):
            assert a.lookup(tid) == a.lookup(tid) == b.lookup(tid)
            assert a.lookup(tid) == want.lookup(tid)
            assert a.lookup(tid) in shards


@pytest.mark.parametrize("num_shards", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("replicas", [1, 7, 64])
def test_router_shard_sets_place_every_tenant_as_reference(num_shards,
                                                           replicas):
    tenants = [f"t{i}" for i in range(300)]
    ids = te.router.shard_ids_for(num_shards)
    assert ids == re_.router.shard_ids_for(num_shards)
    got = te.PartitionDirectory(te.HashRing(ids, replicas=replicas))
    want = re_.PartitionDirectory(re_.HashRing(ids, replicas=replicas))
    assert got.placement(tenants) == want.placement(tenants)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ring_removal_only_moves_tenants_of_removed_shard_sweep(seed):
    rng = np.random.default_rng(10 + seed)
    for _ in range(10):
        shards = random_shards(rng)
        tenants = random_tenants(rng)
        ring, want = te.HashRing(shards), re_.HashRing(shards)
        before = {tid: ring.lookup(tid) for tid in tenants}
        victim = shards[int(rng.integers(len(shards)))]
        ring.remove_shard(victim)
        want.remove_shard(victim)
        if len(shards) == 1:
            with pytest.raises(ValueError):
                ring.lookup(tenants[0])
            continue
        for tid in tenants:
            after = ring.lookup(tid)
            assert after == want.lookup(tid)
            if before[tid] != victim:
                assert after == before[tid]
            else:
                assert after != victim


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ring_addition_only_moves_tenants_onto_new_shard_sweep(seed):
    rng = np.random.default_rng(20 + seed)
    for _ in range(10):
        shards = random_shards(rng)
        tenants = random_tenants(rng)
        ring, want = te.HashRing(shards), re_.HashRing(shards)
        before = {tid: ring.lookup(tid) for tid in tenants}
        ring.add_shard("s99")
        want.add_shard("s99")
        for tid in tenants:
            after = ring.lookup(tid)
            assert after == want.lookup(tid)
            assert after == before[tid] or after == "s99"
    with pytest.raises(ValueError, match="already on the ring"):
        ring.add_shard("s99")


def test_ring_relocation_rate_is_about_one_over_n():
    tenants = [f"t{i}" for i in range(2000)]
    for n in (2, 4, 8):
        ring = te.HashRing([f"s{i}" for i in range(n)])
        want = re_.HashRing([f"s{i}" for i in range(n)])
        before = {tid: ring.lookup(tid) for tid in tenants}
        ring.add_shard(f"s{n}")
        want.add_shard(f"s{n}")
        moved = [tid for tid in tenants if ring.lookup(tid) != before[tid]]
        assert moved == [tid for tid in tenants
                         if want.lookup(tid) != before[tid]]
        frac = len(moved) / len(tenants)
        ideal = 1.0 / (n + 1)
        assert 0.2 * ideal <= frac <= 3.0 * ideal
        assert all(ring.lookup(tid) == f"s{n}" for tid in moved)


def test_ring_validation():
    with pytest.raises(ValueError, match="replicas"):
        te.HashRing(["s0"], replicas=0)
    with pytest.raises(KeyError):
        te.HashRing(["s0"]).remove_shard("s1")
    with pytest.raises(ValueError, match="no shards"):
        te.HashRing().lookup("t0")
    assert len(te.HashRing(["s0", "s1"])) == 2
    assert te.HashRing(["s1", "s0"]).shard_ids == ["s0", "s1"]
    with pytest.raises(ValueError, match="num_shards"):
        te.router.shard_ids_for(0)


def test_ring_stability_hypothesis():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    shard_sets = st.lists(st.integers(0, 40), min_size=2, max_size=8,
                          unique=True).map(
                              lambda xs: [f"s{i}" for i in xs])
    tenant_keys = st.lists(st.text(min_size=1, max_size=12), min_size=1,
                           max_size=40, unique=True)

    @settings(max_examples=50, deadline=None)
    @given(shards=shard_sets, tenants=tenant_keys)
    def prop(shards, tenants):
        ring, want = te.HashRing(shards), re_.HashRing(shards)
        before = {tid: ring.lookup(tid) for tid in tenants}
        assert before == {tid: want.lookup(tid) for tid in tenants}
        ring.add_shard("s99")
        assert all(ring.lookup(tid) in (before[tid], "s99")
                   for tid in tenants)
        ring.remove_shard("s99")
        assert all(ring.lookup(tid) == before[tid] for tid in tenants)
        victim = shards[0]
        ring.remove_shard(victim)
        want.remove_shard(victim)
        for tid in tenants:
            assert ring.lookup(tid) == want.lookup(tid)
            if before[tid] != victim:
                assert ring.lookup(tid) == before[tid]

    prop()


# ---------------------------------------------------------------------------
# PartitionDirectory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_directory_lookup_pure_in_ring_and_overrides_sweep(seed):
    rng = np.random.default_rng(30 + seed)
    for _ in range(10):
        shards = random_shards(rng)
        tenants = random_tenants(rng)
        ring = te.HashRing(shards)
        k = int(rng.integers(0, min(8, len(tenants)) + 1))
        pinned = {tid: shards[int(rng.integers(len(shards)))]
                  for tid in rng.choice(tenants, size=k, replace=False)}
        a = te.PartitionDirectory(ring, overrides=pinned)
        b = te.PartitionDirectory(te.HashRing(shards),
                                  overrides=dict(pinned))
        want = re_.PartitionDirectory(re_.HashRing(shards),
                                      overrides=dict(pinned))
        for tid in tenants:
            assert a.lookup(tid) == b.lookup(tid) == want.lookup(tid)
            assert a.lookup(tid) == pinned.get(tid, ring.lookup(tid))
        assert a.placement(tenants) == want.placement(tenants)


def test_directory_assign_clear_roundtrip():
    shards = ["s0", "s1", "s2"]
    directory = te.PartitionDirectory(te.HashRing(shards))
    want = re_.PartitionDirectory(re_.HashRing(shards))
    for tenant in (f"t{i}" for i in range(20)):
        home = directory.lookup(tenant)
        for d in (directory, want):
            d.assign(tenant, home)
        assert tenant not in directory.overrides
        elsewhere = next(s for s in shards if s != home)
        for d in (directory, want):
            d.assign(tenant, elsewhere)
        assert directory.lookup(tenant) == elsewhere
        assert directory.overrides == want.overrides
        for d in (directory, want):
            d.clear(tenant)
        assert directory.lookup(tenant) == home
    directory.clear("never-pinned")
    assert directory.overrides == want.overrides == {}


# ---------------------------------------------------------------------------
# ShardLoadMeter: the hysteresis contract, move for move the reference's
# ---------------------------------------------------------------------------

def fill_window(meters, hot_events, cold_events):
    for meter in meters:
        for i in range(hot_events):
            meter.observe("s0", f"t{i % 4}")
        for i in range(cold_events):
            meter.observe("s1", f"u{i % 4}")


def test_meter_fires_once_then_rearms_below_low():
    meters = [eng.ShardLoadMeter(["s0", "s1"], eng.RebalanceConfig(
        window=64, high=1.5, low=1.1, queue_weight=0.0))
        for eng in (te, re_)]
    meter = meters[0]
    assert not meter.window_complete
    fill_window(meters, 64, 0)
    assert meter.window_complete
    got = meter.suggest()
    assert got == meters[1].suggest()
    tenant, hot, cold = got
    assert (hot, cold) == ("s0", "s1") and tenant.startswith("t")
    assert not meter.armed
    for hot_n, cold_n in ((64, 0), (33, 31), (64, 0)):
        fill_window(meters, hot_n, cold_n)
        assert meter.suggest() == meters[1].suggest()
        assert meter.stats() == meters[1].stats()
    assert meter.armed is False
    assert meter.moves_suggested == 2
    assert meter.windows_evaluated == 4


def test_meter_refuses_move_that_relocates_the_hotspot():
    cfg = te.RebalanceConfig(window=16, high=1.2, low=1.05, queue_weight=0.0)
    meter = te.ShardLoadMeter(["s0", "s1"], cfg)
    for _ in range(16):
        meter.observe("s0", "whale")
    assert meter.suggest() is None
    assert meter.armed


def test_meter_queue_depth_weighs_into_loads():
    meters = [eng.ShardLoadMeter(["s0", "s1"], eng.RebalanceConfig(
        window=8, high=1.5, low=1.1, queue_weight=2.0)) for eng in (te, re_)]
    for meter in meters:
        for i in range(8):
            meter.observe("s0" if i % 2 else "s1", f"t{i}")
        meter.note_queue_depth("s0", 10)
        meter.add_shard("s2")
    assert meters[0].loads()["s0"] == 4 + 20
    assert meters[0].imbalance() == meters[1].imbalance()
    assert meters[0].imbalance() > 1.5
    assert meters[0].stats() == meters[1].stats()
    assert meters[0].stats()["windows_evaluated"] == 0


def test_rebalance_config_validation():
    with pytest.raises(ValueError, match="hysteresis"):
        te.RebalanceConfig(high=1.1, low=1.2)
    with pytest.raises(ValueError, match="window"):
        te.RebalanceConfig(window=0)


# ---------------------------------------------------------------------------
# Route → migrate → route: the α ledger survives arbitrary re-homing
# ---------------------------------------------------------------------------

class _EveryKPolicy:
    """Charges a reorganization between two layouts every ``k`` queries."""

    name = "EveryK"

    def __init__(self, decision, layouts_, k):
        self.Decision = decision
        self.layouts = list(layouts_)
        self.k = k
        self.alpha = 1.0
        self.cur = 0

    def bind(self, backend):
        for lay in self.layouts:
            backend.register(lay)
        return self.layouts[0].layout_id

    def decide(self, index, query, backend):
        if (index + 1) % self.k == 0:
            self.cur = 1 - self.cur
            return self.Decision(state=self.layouts[self.cur].layout_id,
                                 reorg=True)
        return self.Decision(state=self.layouts[self.cur].layout_id)

    def info(self):
        return {}


def _small_engine(pkg, seed):
    core, eng = PKGS[pkg]
    data = np.random.default_rng(seed).uniform(0, 100, size=(600, 4))
    if pkg == "port":
        data = torch.as_tensor(data)
    lays = [core.build_default_layout(0, data, 4, sort_col=0),
            core.build_default_layout(1, data, 4, sort_col=1)]
    return eng.LayoutEngine(_EveryKPolicy(eng.Decision, lays, 7),
                            eng.InMemoryBackend(data), delta=3,
                            incremental=True, rows_per_tick=50)


TENANTS = [f"t{i}" for i in range(4)]


def route_and_migrate(pkg, moves, events):
    eng = PKGS[pkg][1]
    router = eng.FleetRouter({tid: _small_engine(pkg, i)
                              for i, tid in enumerate(TENANTS)},
                             num_shards=3)
    chunk = max(1, len(events) // (len(moves) + 1))
    step = 0
    for ti, si in moves:
        for ev in events[step:step + chunk]:
            router.submit(ev)
        router.drain()
        step += chunk
        router.migrate_tenant(TENANTS[ti], f"s{si}")
    for ev in events[step:]:
        router.submit(ev)
    router.drain()
    return router


def roundtrip_matches_unsharded(moves, qpt):
    """One migration sequence through the port's 3-shard router equals the
    port's unsharded fleet and repro's router, traces and ledgers."""
    lo, hi = np.zeros(4), np.full(4, 100.0)
    streams = {pkg: PKGS[pkg][0].make_drift_scenario(
        "sudden_shift", lo, hi, num_tenants=4, queries_per_tenant=qpt,
        seed=13) for pkg in PKGS}
    unsharded = te.FleetEngine({tid: _small_engine("port", i)
                                for i, tid in enumerate(TENANTS)})
    unsharded.run(list(streams["port"]))
    got = route_and_migrate("port", moves, list(streams["port"]))
    want = route_and_migrate("ref", moves, list(streams["ref"]))
    assert got.placement() == want.placement()
    for tid in TENANTS:
        ledgers = []
        for holder in (unsharded.tenant(tid), got.tenant(tid),
                       want.tenant(tid)):
            res = holder.result()
            ledgers.append((res.query_costs.tobytes(), res.reorg_indices,
                            [m.charges for m in
                             holder.reorg_executor.migrations]))
        assert ledgers[0] == ledgers[1] == ledgers[2]


def test_route_migrate_route_roundtrip_sweep():
    for moves in ([(0, 1)],
                  [(0, 1), (0, 2)],
                  [(0, 1), (1, 1), (2, 0)],
                  list(itertools.product(range(4), (1,)))):
        roundtrip_matches_unsharded(moves, qpt=21)


def test_route_migrate_route_roundtrip_hypothesis():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=10, deadline=None)
    @given(moves=st.lists(st.tuples(st.integers(0, 3), st.integers(0, 2)),
                          min_size=1, max_size=5),
           qpt=st.integers(7, 28))
    def prop(moves, qpt):
        roundtrip_matches_unsharded(moves, qpt)

    prop()
