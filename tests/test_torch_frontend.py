"""The port's serving front end (``repro_torch.serve``: admission, cache,
frontend) held against the JAX package's, on the CPU.

Mirrors ``tests/test_serving_frontend.py``: each case drives ``repro`` and
the port through the same seeded tables and streams and compares traces,
deferrals, scheduler stats and every front-end counter (admission,
breaker, shedding, cache) bit for bit, on top of the reference test's own
equalities (a permissive front end is invisible; under overload the
breaker sheds reorganization work only, never a query, and the α ledger
is untouched; cache hits are bit-exact).  Extra cases: hybrid-layout
(incremental) tenants cached bitwise, a ``compute="reference"`` tenant left
uncached, cache keys byte-equal across packages, and the shedding proxy
consulted by the governor and the incremental row budget.
"""
import collections

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

PKGS = {"ref": (rc, re_, rlm, rs), "port": (tc, te, tlm, ts)}

SCHEDULERS = {
    "unlimited": lambda eng: eng.UnlimitedScheduler(),
    "k1": lambda eng: eng.KConcurrentScheduler(1),
    "bucket": lambda eng: eng.TokenBucketScheduler(rate=0.01, capacity=1.0,
                                                   initial=0.0),
}
DRIFT_SCENARIOS = ["sudden_shift", "gradual_drift", "cyclic_diurnal",
                   "flash_crowd", "template_churn"]
INGEST_SCENARIOS = ["trickle", "append_heavy", "mixed_rw", "ingest_burst",
                    "bulk_load"]
PERMISSIVE = dict(queue_capacity=100_000, breaker_open_frac=None,
                  record_latency=False)
OVERLOAD = dict(queue_capacity=48, overflow_policy="block",
                breaker_open_frac=0.5, breaker_close_frac=0.1,
                breaker_min_open_events=16, pump_chunk=4,
                record_latency=False)


@pytest.fixture(scope="module")
def tenant_data():
    return {f"t{t}": np.random.default_rng(500 + t).uniform(
        0, 100, size=(2_000, 5)) for t in range(2)}


@pytest.fixture(scope="module")
def bounds(tenant_data):
    lo = np.min([d.min(0) for d in tenant_data.values()], axis=0)
    hi = np.max([d.max(0) for d in tenant_data.values()], axis=0)
    return lo, hi


def table(pkg, data):
    return torch.as_tensor(data) if pkg == "port" else data


def oreo_engine(pkg, data, ingest=False, alpha=10.0, delta=5, seed=2,
                **engine_kw):
    core, eng, lm, _ = PKGS[pkg]
    data = table(pkg, data)
    cfg = core.OreoConfig(alpha=alpha, seed=seed, delta=delta,
                          manager=lm.LayoutManagerConfig(
                              target_partitions=8, window_size=60,
                              gen_every=30))
    policy = eng.OreoPolicy(data, core.build_default_layout(0, data, 8),
                            core.make_generator("qdtree"), cfg)
    return eng.LayoutEngine(policy, eng.InMemoryBackend(data),
                            delta=cfg.delta,
                            ingest=eng.IngestConfig() if ingest else None,
                            **engine_kw)


def make_stream(pkg, scenario, lo, hi, qpt=60, seed=7):
    core = PKGS[pkg][0]
    make = (core.make_drift_scenario if scenario in DRIFT_SCENARIOS
            else core.make_ingest_scenario)
    return make(scenario, lo, hi, num_tenants=2, queries_per_tenant=qpt,
                seed=seed)


def build_fleet(pkg, fs, tenant_data, scenario, scheduler="unlimited",
                **engine_kw):
    eng = PKGS[pkg][1]
    return eng.FleetEngine({tid: oreo_engine(
        pkg, tenant_data[tid], ingest=scenario in INGEST_SCENARIOS,
        **engine_kw) for tid in fs.tenant_ids}, SCHEDULERS[scheduler](eng))


def frontend(pkg, fleet, **cfg):
    serve = PKGS[pkg][3]
    return serve.ServeFrontend(fleet, serve.FrontendConfig(**cfg))


def run_trace(res):
    return (res.query_costs.tobytes(), tuple(res.reorg_indices),
            res.state_seq.tobytes())


def fleet_trace(res):
    return ({tid: run_trace(r) for tid, r in res.per_tenant.items()},
            res.ticks, res.swaps_deferred, res.deferred_ticks,
            res.scheduler, res.scheduler_stats)


def both(fn):
    return {pkg: fn(pkg) for pkg in PKGS}


class FlipFlopPolicy:
    """Forces a swap every ``period`` queries (serving-change workhorse)."""

    name = "FlipFlop"

    def __init__(self, decision, layouts_, period):
        self.Decision = decision
        self.layouts = list(layouts_)
        self.period = period
        self.alpha = 1.0
        self.cur = 0

    def bind(self, backend):
        for lay in self.layouts:
            backend.register(lay)
        return self.layouts[0].layout_id

    def decide(self, index, query, backend):
        if (index + 1) % self.period == 0:
            self.cur = 1 - self.cur
            return self.Decision(state=self.layouts[self.cur].layout_id,
                                 reorg=True)
        return self.Decision(state=self.layouts[self.cur].layout_id)

    def info(self):
        return {}


def hot_queries(pkg, lo, hi, n, distinct=4, seed=11):
    """n queries drawn from ``distinct`` bound-sets (fresh objects each
    time, so hits prove bounds-keyed caching, not the identity memo)."""
    wl = PKGS[pkg][0].workload
    rng = np.random.default_rng(seed)
    base = []
    for _ in range(distinct):
        qlo = np.full(lo.shape[0], -np.inf)
        qhi = np.full(lo.shape[0], np.inf)
        col = int(rng.integers(0, lo.shape[0]))
        a, b = np.sort(rng.uniform(lo[col], hi[col], size=2))
        qlo[col], qhi[col] = a, b
        base.append((qlo, qhi))
    return [wl.Query(lo=base[i % distinct][0].copy(),
                     hi=base[i % distinct][1].copy()) for i in range(n)]


def threshold_fleet(pkg, d, space_size=3):
    core, eng, _, _ = PKGS[pkg]
    d = table(pkg, d)
    space = [core.build_default_layout(sid, d, 8, sort_col=sid % d.shape[1])
             for sid in range(space_size)]
    return eng.FleetEngine({"a": eng.LayoutEngine(
        eng.ThresholdSwitchPolicy(space, alpha=10.0, threshold=1e9),
        eng.InMemoryBackend(d), delta=2)})


def query_events(pkg, queries):
    return [PKGS[pkg][0].workload.QueryEvent("a", q) for q in queries]


# ---------------------------------------------------------------------------
# Golden identity: frontend == driving the fleet directly == the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", DRIFT_SCENARIOS + INGEST_SCENARIOS)
def test_frontend_bit_identical_to_direct_run(scenario, tenant_data,
                                              bounds):
    """The port's permissive front end equals repro's direct run (traces,
    deferrals, grants, scheduler name) and repro's front end (every
    counter, cache included)."""
    lo, hi = bounds
    for sched in SCHEDULERS:
        fs = make_stream("ref", scenario, lo, hi)
        direct = build_fleet("ref", fs, tenant_data, scenario, sched).run(fs)
        want = frontend("ref", build_fleet("ref", fs, tenant_data, scenario,
                                           sched), **PERMISSIVE)
        want.run(fs)
        fs = make_stream("port", scenario, lo, hi)
        fe = frontend("port", build_fleet("port", fs, tenant_data, scenario,
                                          sched), **PERMISSIVE)
        got = fe.run(fs)
        assert fleet_trace(got) == fleet_trace(direct), sched
        assert fe.stats() == want.stats(), sched


@pytest.mark.parametrize("lane", ["fleet_scan", "decision_fused"])
def test_frontend_batched_mode_matches_run_batched(lane, tenant_data,
                                                   bounds):
    lo, hi = bounds
    want = build_fleet("ref", make_stream("ref", "sudden_shift", lo, hi),
                       tenant_data, "sudden_shift").run(
        make_stream("ref", "sudden_shift", lo, hi))
    fs = make_stream("port", "sudden_shift", lo, hi)
    ref = build_fleet("port", fs, tenant_data, "sudden_shift").run_batched(
        fs, compute=lane)
    fleet = build_fleet("port", fs, tenant_data, "sudden_shift")
    fe = frontend("port", fleet, batched=True, compute=lane, **PERMISSIVE)
    got = fe.run(fs)
    assert fleet_trace(got)[0] == fleet_trace(ref)[0] == fleet_trace(want)[0]
    assert fleet.fleet_matrix.compute_backend == lane
    assert fe.stats()["cache"] is None          # the fused pass primes
    with pytest.raises(ValueError, match="compute lane"):
        ts.FrontendConfig(batched=True, compute="numpy")


# ---------------------------------------------------------------------------
# Overload: the breaker sheds reorg work, never serve work
# ---------------------------------------------------------------------------

def test_breaker_sheds_reorgs_but_alpha_ledger_untouched(tenant_data,
                                                         bounds):
    lo, hi = bounds

    def run(pkg):
        fs = make_stream(pkg, "flash_crowd", lo, hi, qpt=120)
        ref = build_fleet(pkg, fs, tenant_data, "flash_crowd", "k1").run(fs)
        fe = frontend(pkg, build_fleet(pkg, fs, tenant_data, "flash_crowd",
                                       "k1"), **OVERLOAD)
        got = fe.run(fs)
        stats = fe.stats()
        assert stats["breaker"]["opens"] >= 1
        assert stats["shed_count"] >= 1
        for tid in fs.tenant_ids:
            a, b = ref.per_tenant[tid], got.per_tenant[tid]
            assert len(b.query_costs) == 120
            assert a.reorg_indices == b.reorg_indices
            assert a.total_reorg_cost == b.total_reorg_cost
            assert np.array_equal(a.state_seq, b.state_seq)
        assert stats["processed"] == len(fs.events)
        return fleet_trace(got), stats
    got = both(run)
    assert got["port"] == got["ref"]


def test_breaker_recloses_and_grants_resume(tenant_data, bounds):
    lo, hi = bounds

    def run(pkg):
        wl = PKGS[pkg][0].workload
        fs = make_stream(pkg, "flash_crowd", lo, hi, qpt=120)
        fleet = build_fleet(pkg, fs, tenant_data, "flash_crowd", "k1")
        fe = frontend(pkg, fleet, **OVERLOAD)
        fe.run(fs)
        stats = fe.stats()
        assert stats["breaker"]["opens"] >= 1
        assert stats["breaker"]["closes"] == stats["breaker"]["opens"]
        assert not fe._shedder.shedding
        assert fe.queue_depth == 0
        tail = 0
        for i in range(400):
            if not fleet._waiting:
                break
            tid = fs.tenant_ids[i % len(fs.tenant_ids)]
            q = fs.per_tenant[tid].queries[0]
            fe.submit_blocking(wl.QueryEvent(tid, wl.Query(
                lo=q.lo.copy(), hi=q.hi.copy())))
            fe.flush()
            tail += 1
        assert not fleet._waiting
        assert fe.stats()["scheduler"].get("grants", 0) >= 1
        return stats, tail, fe.stats(), fleet_trace(fe.result())
    got = both(run)
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# Versioned read-through cache
# ---------------------------------------------------------------------------

def test_cache_hits_are_bit_exact(tenant_data, bounds):
    lo, hi = bounds

    def run(pkg):
        events = query_events(pkg, hot_queries(pkg, lo, hi, 80))
        ref = threshold_fleet(pkg, tenant_data["t0"]).run(events)
        fe = frontend(pkg, threshold_fleet(pkg, tenant_data["t0"]),
                      **PERMISSIVE)
        got = fe.run(events)
        assert fleet_trace(got) == fleet_trace(ref)
        cache = fe.stats()["cache"]
        assert cache["hits"] >= 70 and cache["misses"] <= 10
        return fleet_trace(got), fe.stats()
    got = both(run)
    assert got["port"] == got["ref"]


def test_cache_invalidates_on_serving_change(tenant_data, bounds):
    lo, hi = bounds

    def run(pkg):
        core, eng, _, _ = PKGS[pkg]
        d = table(pkg, tenant_data["t0"])
        lays = [core.build_default_layout(0, d, 8, sort_col=0),
                core.build_default_layout(1, d, 8, sort_col=1)]

        def build():
            return eng.FleetEngine({"a": eng.LayoutEngine(
                FlipFlopPolicy(eng.Decision, lays, 3),
                eng.InMemoryBackend(d), delta=0)})

        events = query_events(pkg, hot_queries(pkg, lo, hi, 30, distinct=1))
        ref = build().run(events)
        fe = frontend(pkg, build(), **PERMISSIVE)
        got = fe.run(events)
        assert fleet_trace(got) == fleet_trace(ref)
        cache = fe.stats()["cache"]
        assert cache["misses"] >= 10 and cache["hits"] >= 10
        return fleet_trace(got), fe.stats()
    got = both(run)
    assert got["port"] == got["ref"]


def test_cache_disabled_and_lru_bound(tenant_data, bounds):
    lo, hi = bounds

    def run(pkg):
        fe = frontend(pkg, threshold_fleet(pkg, tenant_data["t0"], 1),
                      cache_entries=0, **PERMISSIVE)
        fe.run(query_events(pkg, hot_queries(pkg, lo, hi, 10)))
        assert fe.stats()["cache"] is None
        fe2 = frontend(pkg, threshold_fleet(pkg, tenant_data["t0"], 1),
                       cache_entries=2, **PERMISSIVE)
        fe2.run(query_events(pkg, hot_queries(pkg, lo, hi, 40)))
        cache = fe2.stats()["cache"]
        assert cache["entries"] <= 2 and cache["evictions"] > 0
        return fe.stats(), fe2.stats(), fleet_trace(fe2.result())
    got = both(run)
    assert got["port"] == got["ref"]


def test_cache_keys_and_lru_equal_reference(bounds):
    """cache_key is byte-equal across packages (the port's query bounds are
    numpy), and the LRU evicts and counts as the reference's does."""
    lo, hi = bounds
    qs = {pkg: hot_queries(pkg, lo, hi, 12, distinct=5) for pkg in PKGS}
    caches = {pkg: PKGS[pkg][3].VersionedResultCache(3) for pkg in PKGS}
    for i in range(12):
        keys = {pkg: PKGS[pkg][3].cache_key("a", i % 2, qs[pkg][i])
                for pkg in PKGS}
        assert keys["port"] == keys["ref"]
        for pkg, cache in caches.items():
            if cache.get(keys[pkg]) is None:
                cache.put(keys[pkg], float(i))
    assert caches["port"].stats() == caches["ref"].stats()
    assert list(caches["port"]._data.items()) == list(
        caches["ref"]._data.items())
    with pytest.raises(ValueError, match="max_entries"):
        ts.VersionedResultCache(0)


def test_cache_serves_hybrid_tenants_bitwise_and_skips_reference_mode(
        tenant_data, bounds):
    """Incremental tenants with a tight row budget serve hybrid layouts
    that change between swaps: a cached front end still equals the direct
    run and repro's front end.  A compute="reference" tenant has no plane,
    so it stays uncached (every lookup bypassed) and equals the default
    mode's trace."""
    lo, hi = bounds
    # Hot queries repeated over a drifting stream: hits and hybrid changes.
    def events(pkg):
        wl = PKGS[pkg][0].workload
        fs = make_stream(pkg, "sudden_shift", lo, hi, qpt=120)
        hot = hot_queries(pkg, lo, hi, 240, distinct=3)
        out = []
        for i, ev in enumerate(fs):
            out.append(ev)
            out.append(wl.QueryEvent(ev.tenant_id, hot[i]))
        return out

    def run(pkg):
        eng = PKGS[pkg][1]

        def fleet():
            return eng.FleetEngine({tid: oreo_engine(
                pkg, tenant_data[tid], incremental=True, rows_per_tick=60)
                for tid in ("t0", "t1")})

        evs = events(pkg)
        direct = fleet().run(evs)
        fe = frontend(pkg, fleet(), **PERMISSIVE)
        got = fe.run(evs)
        assert fleet_trace(got) == fleet_trace(direct)
        migs = sum(len(fe.fleet.tenant(t).reorg_executor.migrations)
                   for t in ("t0", "t1"))
        assert migs > 0 and fe.stats()["cache"]["hits"] > 0
        return fleet_trace(got), fe.stats()
    got = both(run)
    assert got["port"] == got["ref"]

    evs = events("port")
    traces = {}
    for compute in ("state_matrix", "reference"):
        tables = {tid: table("port", tenant_data[tid]) for tid in ("t0",
                                                                    "t1")}
        fleet = te.FleetEngine({tid: te.LayoutEngine(
            te.OreoPolicy(d, tc.build_default_layout(0, d, 8),
                          tc.make_generator("qdtree"),
                          tc.OreoConfig(alpha=10.0, seed=2, delta=5,
                                        manager=tlm.LayoutManagerConfig(
                                            target_partitions=8,
                                            window_size=60, gen_every=30))),
            te.InMemoryBackend(d, compute=compute), delta=5)
            for tid, d in tables.items()})
        fe = frontend("port", fleet, **PERMISSIVE)
        traces[compute] = fleet_trace(fe.run(evs))[0]
        cache = fe.stats()["cache"]
        if compute == "reference":
            assert fe._cacheable == {"t0": None, "t1": None}
            assert cache == {"entries": 0, "hits": 0, "misses": 0,
                             "evictions": 0}
        else:
            assert cache["hits"] > 0
    assert traces["reference"] == traces["state_matrix"]


def test_shedding_proxy_reaches_governor_and_row_budget(tenant_data,
                                                        bounds):
    """The proxy replaces each fleet's scheduler object, and the fleet's
    governor and incremental row budget call through ``fleet.scheduler``
    at call time: while shedding, every grant and row budget is refused
    through the proxy, and the counters equal the reference's."""
    lo, hi = bounds

    def run(pkg):
        eng = PKGS[pkg][1]
        fleet = eng.FleetEngine({tid: oreo_engine(
            pkg, tenant_data[tid], incremental=True, rows_per_tick=60)
            for tid in ("t0", "t1")}, eng.KConcurrentScheduler(1))
        inner = fleet.scheduler
        fe = frontend(pkg, fleet, **PERMISSIVE)
        assert fleet.scheduler is fe._shedder and fe._shedder.inner is inner
        fe._shedder.shedding = True
        fs = make_stream(pkg, "sudden_shift", lo, hi, qpt=120)
        got = fe.run(fs)
        stats = fe.stats()
        assert stats["shed_attempts"] > 0 and stats["shed_count"] > 0
        assert inner.stats().get("grants", 0) == 0
        assert all(not fleet.tenant(t).reorg_executor.migrations
                   or fleet.tenant(t).reorg_executor.active is None
                   for t in ("t0", "t1"))
        return fleet_trace(got), stats
    got = both(run)
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# Admission control + overflow policies
# ---------------------------------------------------------------------------

def test_token_bucket_admission_throttles_per_tenant(tenant_data, bounds):
    lo, hi = bounds

    def run(pkg):
        fe = frontend(pkg, threshold_fleet(pkg, tenant_data["t0"], 1),
                      admission_rate=0.5, admission_capacity=1.0,
                      admission_initial=1.0, queue_capacity=1000,
                      breaker_open_frac=None, record_latency=False)
        qs = hot_queries(pkg, lo, hi, 10)
        outcomes = [fe.submit(ev) for ev in query_events(pkg, qs)]
        assert any(not r.admitted and r.reason == "throttled"
                   for r in outcomes)
        for ev in query_events(pkg, qs):
            assert fe.submit_blocking(ev).admitted
        fe.flush()
        assert fe.stats()["processed"] == fe.stats()["admitted"]
        assert fe.queue_depth == 0
        return ([(r.admitted, r.reason) for r in outcomes], fe.stats(),
                fleet_trace(fe.result()))
    got = both(run)
    assert got["port"] == got["ref"]


def test_admission_rate_zero_rejected_by_config():
    with pytest.raises(ValueError, match="admission_rate"):
        ts.FrontendConfig(admission_rate=0.0)
    with pytest.raises(ValueError, match="overflow_policy"):
        ts.FrontendConfig(overflow_policy="drop")
    with pytest.raises(ValueError, match="breaker_open_frac"):
        ts.FrontendConfig(breaker_open_frac=1.5)
    with pytest.raises(ValueError, match="rate"):
        ts.TokenBucket(rate=0.0, capacity=1.0)
    with pytest.raises(ValueError, match="close_below"):
        ts.CircuitBreaker(open_above=2, close_below=3)


def test_overflow_reject_refuses_at_ingress(tenant_data, bounds):
    lo, hi = bounds

    def run(pkg):
        serve = PKGS[pkg][3]
        fe = frontend(pkg, threshold_fleet(pkg, tenant_data["t0"], 1),
                      queue_capacity=4, overflow_policy="reject",
                      breaker_open_frac=None, record_latency=False)
        outcomes = [fe.submit(ev) for ev in query_events(
            pkg, hot_queries(pkg, lo, hi, 6))]
        assert [r.admitted for r in outcomes] == [True] * 4 + [False] * 2
        assert outcomes[-1] == serve.AdmissionResult(False, "queue_full")
        assert fe.stats()["rejected"] == 2 and fe.queue_depth == 4
        fe.flush()
        assert fe.stats()["processed"] == 4
        return fe.stats(), fleet_trace(fe.result())
    got = both(run)
    assert got["port"] == got["ref"]


def test_overflow_block_levels_load(tenant_data, bounds):
    lo, hi = bounds

    def run(pkg):
        fe = frontend(pkg, threshold_fleet(pkg, tenant_data["t0"], 1),
                      queue_capacity=4, overflow_policy="block",
                      pump_chunk=2, breaker_open_frac=None,
                      record_latency=False)
        for ev in query_events(pkg, hot_queries(pkg, lo, hi, 20)):
            assert fe.submit(ev).admitted
            assert fe.queue_depth <= 4
        fe.flush()
        assert fe.stats()["processed"] == 20
        return fe.stats(), fleet_trace(fe.result())
    got = both(run)
    assert got["port"] == got["ref"]


def test_slot_batcher_queue_is_deque_and_fifo():
    b = ts.SlotBatcher(num_slots=2)
    assert isinstance(b.queue, collections.deque)
    for rid in range(6):
        b.submit(ts.Request(rid, np.zeros(4, np.int32), max_new_tokens=1))
    b.fill_slots()
    b.record_tokens(np.array([1, 1]))
    b.fill_slots()
    b.record_tokens(np.array([2, 2]))
    assert [r.request_id for r in b.completed] == [0, 1, 2, 3]
    assert b.pending == 2


def test_serve_exports_frontend_surface():
    for name in ("ServeFrontend", "FrontendConfig", "AdmissionResult",
                 "TokenBucket", "CircuitBreaker", "VersionedResultCache",
                 "cache_key", "SlotBatcher"):
        assert name in ts.__all__ and getattr(ts, name) is not None
    assert set(rs.__all__) <= set(ts.__all__)


# ---------------------------------------------------------------------------
# Property: any admission-limit setting — shedding only ever defers
# reorg/compaction work; admitted queries are never dropped
# ---------------------------------------------------------------------------

def _admission_config(serve, rng):
    open_frac = (None if rng.random() < 0.25
                 else float(rng.uniform(0.2, 0.9)))
    return serve.FrontendConfig(
        queue_capacity=int(rng.integers(4, 65)),
        overflow_policy=("block", "reject")[int(rng.integers(2))],
        admission_rate=(None if rng.random() < 0.25
                        else float(rng.uniform(0.25, 4.0))),
        admission_capacity=float(rng.uniform(1.0, 8.0)),
        breaker_open_frac=open_frac,
        breaker_close_frac=(0.0 if open_frac is None else open_frac / 2),
        breaker_min_open_events=int(rng.integers(0, 33)),
        pump_chunk=int(rng.integers(1, 17)),
        record_latency=False)


@pytest.fixture(scope="module")
def property_workload(tenant_data, bounds):
    lo, hi = bounds
    fs = make_stream("port", "flash_crowd", lo, hi, qpt=40, seed=19)
    ref = build_fleet("port", fs, tenant_data, "flash_crowd", "k1").run(fs)
    return fs, {tid: ref.per_tenant[tid] for tid in fs.tenant_ids}


@pytest.mark.parametrize("case", range(10))
def test_any_admission_setting_never_drops_queries(case, property_workload,
                                                   tenant_data, bounds):
    fs, ref = property_workload
    lo, hi = bounds
    fleet = build_fleet("port", fs, tenant_data, "flash_crowd", "k1")
    fe = ts.ServeFrontend(fleet, _admission_config(
        ts, np.random.default_rng(1000 + case)))
    got = fe.run(fs)
    stats = fe.stats()
    for tid in fs.tenant_ids:
        assert len(got.per_tenant[tid].query_costs) == 40
        assert got.per_tenant[tid].reorg_indices == ref[tid].reorg_indices
        assert np.array_equal(got.per_tenant[tid].state_seq,
                              ref[tid].state_seq)
    assert stats["processed"] == len(fs.events)
    assert fe.queue_depth == 0
    if stats["breaker"] is not None:
        b = stats["breaker"]
        assert b["closes"] == b["opens"] - (1 if b["is_open"] else 0)
    ref_fs = make_stream("ref", "flash_crowd", lo, hi, qpt=40, seed=19)
    want_fe = rs.ServeFrontend(
        build_fleet("ref", ref_fs, tenant_data, "flash_crowd", "k1"),
        _admission_config(rs, np.random.default_rng(1000 + case)))
    want = want_fe.run(ref_fs)
    assert fleet_trace(got) == fleet_trace(want)
    assert stats == want_fe.stats()
