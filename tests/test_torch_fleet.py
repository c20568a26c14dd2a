"""The port's multi-tenant fleet held against the JAX package's, on the CPU.

``repro_torch``'s ``FleetEngine`` (per-event ``run``, and ``run_batched``
on both scoring lanes, ``fleet_scan`` and ``decision_fused``) must give
per-tenant ``query_costs``, ``reorg_indices`` and ``state_seq``, and the
fleet's deferral and grant counters, bit for bit equal to ``repro``'s
``FleetEngine.run`` on the same seeded inputs: every drift scenario under
every scheduler, OREO tenants and the threshold policy's bulk path.  The
packed plane must keep the reference's slots and capacities under tenant
and state churn.  On the CPU the lanes run the kernels' plain versions.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as rc
import repro.engine as re_
from repro.core import layout_manager as rlm

import repro_torch.core as tc
import repro_torch.engine as te
from repro_torch.core import layout_manager as tlm
from repro_torch.kernels.decision_fused import decision_fused
from repro_torch.kernels.fleet_scan import fleet_scan

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


@pytest.fixture(scope="module")
def tenant_data():
    return {f"t{t}": np.random.default_rng(100 + t).uniform(
        0, 100, size=(3_000, 6)) for t in range(3)}


@pytest.fixture(scope="module")
def bounds(tenant_data):
    lo = np.min([d.min(0) for d in tenant_data.values()], axis=0)
    hi = np.max([d.max(0) for d in tenant_data.values()], axis=0)
    return lo, hi


def table(pkg, data):
    return torch.as_tensor(data) if pkg == "port" else data


def oreo_engine(pkg, data, alpha=10.0, delta=5, seed=2):
    core, eng, lm = PKGS[pkg]
    data = table(pkg, data)
    cfg = core.OreoConfig(alpha=alpha, seed=seed, delta=delta,
                          manager=lm.LayoutManagerConfig(
                              target_partitions=8, window_size=60,
                              gen_every=30))
    policy = eng.OreoPolicy(data, core.build_default_layout(0, data, 8),
                            core.make_generator("qdtree"), cfg)
    return eng.LayoutEngine(policy, eng.InMemoryBackend(data),
                            delta=cfg.delta)


def threshold_engine(pkg, data, threshold, alpha=10.0, delta=2):
    core, eng, _ = PKGS[pkg]
    data = table(pkg, data)
    space = [core.build_default_layout(sid, data, 8,
                                       sort_col=sid % data.shape[1])
             for sid in range(3)]
    return eng.LayoutEngine(eng.ThresholdSwitchPolicy(
        space, alpha=alpha, threshold=threshold),
        eng.InMemoryBackend(data), delta=delta)


def fleet(pkg, make, tenant_data, tids, scheduler="unlimited"):
    eng = PKGS[pkg][1]
    return eng.FleetEngine({tid: make(pkg, tenant_data[tid]) for tid in tids},
                           SCHEDULERS[scheduler](eng))


def port_runs(make, tenant_data, stream, scheduler):
    """The port's per-event run and its batched run on both lanes."""
    out = {"run": fleet("port", make, tenant_data, stream.tenant_ids,
                        scheduler).run(stream)}
    for lane in LANES:
        f = fleet("port", make, tenant_data, stream.tenant_ids, scheduler)
        out[lane] = f.run_batched(stream, compute=lane)
        assert f.fleet_matrix.compute_backend == lane
    return out


def assert_same_fleet(got, ref):
    assert list(got.per_tenant) == list(ref.per_tenant)
    for tid, r in ref.per_tenant.items():
        g = got.per_tenant[tid]
        assert np.array_equal(g.query_costs, r.query_costs), tid
        assert g.reorg_indices == r.reorg_indices, tid
        assert np.array_equal(g.state_seq, r.state_seq), tid
    assert got.total_cost == ref.total_cost
    assert got.ticks == ref.ticks
    assert got.swaps_deferred == ref.swaps_deferred
    assert got.deferred_ticks == ref.deferred_ticks
    assert got.scheduler_stats == ref.scheduler_stats


# ---------------------------------------------------------------------------
# Golden traces: every drift scenario x scheduler, OREO tenants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheduler", list(SCHEDULERS))
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_fleet_traces_equal_reference(scenario, scheduler, tenant_data,
                                      bounds):
    lo, hi = bounds
    ref_stream = rc.make_drift_scenario(scenario, lo, hi, num_tenants=3,
                                        queries_per_tenant=120, seed=7)
    stream = tc.make_drift_scenario(scenario, lo, hi, num_tenants=3,
                                    queries_per_tenant=120, seed=7)
    ref = fleet("ref", oreo_engine, tenant_data, ref_stream.tenant_ids,
                scheduler).run(ref_stream)
    assert ref.num_reorgs > 0
    before = (fleet_scan.scan_fleet.launches,
              decision_fused.fused_decision.launches)
    for mode, got in port_runs(oreo_engine, tenant_data, stream,
                               scheduler).items():
        assert_same_fleet(got, ref)
    assert (fleet_scan.scan_fleet.launches,
            decision_fused.fused_decision.launches) == before


@pytest.mark.parametrize("scheduler", list(SCHEDULERS))
@pytest.mark.parametrize("threshold", [0.0, 0.05, 1e9])
def test_threshold_bulk_path_equals_reference(threshold, scheduler,
                                              tenant_data, bounds):
    """Batch-decidable fleets: passes without switch or swap activity
    commit in bulk, the rest replay per event — on both lanes the traces
    equal the reference's per-event run."""
    lo, hi = bounds
    stream = tc.make_drift_scenario("sudden_shift", lo, hi, num_tenants=3,
                                    queries_per_tenant=120, seed=13)
    ref_stream = rc.make_drift_scenario("sudden_shift", lo, hi,
                                        num_tenants=3,
                                        queries_per_tenant=120, seed=13)

    def make(pkg, data):
        return threshold_engine(pkg, data, threshold)
    ref = fleet("ref", make, tenant_data, ref_stream.tenant_ids,
                scheduler).run(ref_stream)
    for got in port_runs(make, tenant_data, stream, scheduler).values():
        assert_same_fleet(got, ref)


@pytest.mark.parametrize("lane", LANES)
def test_bulk_path_engages_without_per_event_decide(lane, tenant_data,
                                                    bounds, monkeypatch):
    lo, hi = bounds
    stream = tc.make_drift_scenario("sudden_shift", lo, hi, num_tenants=3,
                                    queries_per_tenant=100, seed=17)

    def boom(self, index, query, backend):
        raise AssertionError("bulk path disengaged: decide() was called")

    monkeypatch.setattr(te.ThresholdSwitchPolicy, "decide", boom)
    f = te.FleetEngine({tid: threshold_engine("port", tenant_data[tid], 1e9,
                                              delta=0)
                        for tid in stream.tenant_ids})
    result = f.run_batched(stream, compute=lane)
    assert all(len(r.query_costs) == 100 for r in result.per_tenant.values())
    assert f.fleet_matrix.last_pass_dense is not None


# ---------------------------------------------------------------------------
# Priming, observations, membership
# ---------------------------------------------------------------------------

class FlipFlopPolicy:
    name = "FlipFlop"

    def __init__(self, layouts_, period, eng, alpha=1.0):
        self.layouts = list(layouts_)
        self.period = period
        self.eng = eng
        self.alpha = alpha
        self.cur = 0

    def bind(self, backend):
        for lay in self.layouts:
            backend.register(lay)
        return self.layouts[0].layout_id

    def decide(self, index, query, backend):
        if (index + 1) % self.period == 0:
            self.cur = 1 - self.cur
            return self.eng.Decision(state=self.layouts[self.cur].layout_id,
                                     reorg=True)
        return self.eng.Decision(state=self.layouts[self.cur].layout_id)

    def info(self):
        return {}


def flipflop_engine(pkg, data, period=5, delta=2):
    core, eng, _ = PKGS[pkg]
    data = table(pkg, data)
    lays = [core.build_default_layout(0, data, 8, sort_col=0),
            core.build_default_layout(1, data, 8, sort_col=1)]
    return eng.LayoutEngine(FlipFlopPolicy(lays, period, eng),
                            eng.InMemoryBackend(data), delta=delta)


def column_events(pkg, n, tids=("a",), seed=4):
    wl = PKGS[pkg][0].workload
    rng = np.random.default_rng(seed)
    events = []
    for i in range(n):
        for tid in tids:
            lo = np.full(6, -np.inf)
            hi = np.full(6, np.inf)
            col = i % 6
            lo[col], hi[col] = np.sort(rng.uniform(0, 100, size=2))
            events.append(wl.QueryEvent(tid, wl.Query(lo=lo, hi=hi)))
    return events


@pytest.mark.parametrize("frames_per_pass", [1, 8, 64])
def test_non_estimating_policy_serves_no_stale_primes(frames_per_pass,
                                                      tenant_data):
    """A swap landing at an earlier event of a multi-frame pass must not
    let the pass's pre-swap shadow score be served (the version guard on
    the primed serve memo)."""
    d = {"a": tenant_data["t0"]}
    ref = fleet("ref", flipflop_engine, d, ["a"]).run(
        column_events("ref", 120))
    for lane in LANES:
        got = fleet("port", flipflop_engine, d, ["a"]).run_batched(
            column_events("port", 120), compute=lane,
            frames_per_pass=frames_per_pass)
        assert_same_fleet(got, ref)


def test_collected_observations_equal_reference(tenant_data, bounds):
    lo, hi = bounds
    streams = {pkg: PKGS[pkg][0].make_drift_scenario(
        "flash_crowd", lo, hi, num_tenants=3, queries_per_tenant=60, seed=3)
        for pkg in PKGS}
    out = {}
    for pkg, stream in streams.items():
        f = fleet(pkg, oreo_engine, tenant_data, stream.tenant_ids, "bucket")
        for event in stream:
            f.submit(event)
        assert f.queue_depth == len(stream)
        out[pkg] = (f.drain(collect=True), f.stats(), f.result())
    (ref_obs, ref_stats, ref_res), (obs, stats, res) = out["ref"], out["port"]
    assert [(o.tick, o.tenant_id, o.swap_deferred, o.step.index,
             o.step.query_cost, o.step.decision_state,
             o.step.serving_state, o.step.reorg_charged) for o in obs] == \
        [(o.tick, o.tenant_id, o.swap_deferred, o.step.index,
          o.step.query_cost, o.step.decision_state, o.step.serving_state,
          o.step.reorg_charged) for o in ref_obs]
    assert any(o.swap_deferred for o in obs)
    assert stats == ref_stats
    assert_same_fleet(res, ref_res)
    assert res.summary() == ref_res.summary()


def membership_script(pkg, tenant_data):
    """Run batches while tenants join, leave and come back (a transplant
    with charged swaps still pending) under one maintenance worker;
    returns the trace and the plane's layout after every batch."""
    core, eng, _ = PKGS[pkg]
    events = column_events(pkg, 40, tids=("a", "b", "c"), seed=9)
    f = eng.FleetEngine({"a": flipflop_engine(pkg, tenant_data["t0"]),
                         "b": flipflop_engine(pkg, tenant_data["t1"], 3,
                                              delta=4)},
                        eng.KConcurrentScheduler(1))
    layouts = []

    def snapshot():
        fm = f.fleet_matrix
        layouts.append((fm.tenant_ids, fm.version, fm._tcap, fm._scap,
                        fm._pcap, {t: (fm.tenant_row(t), fm.state_ids(t))
                                   for t in fm.tenant_ids}))
    ab = [e for e in events if e.tenant_id != "c"]
    f.run_batched(ab[:30], compute="fleet_scan" if pkg == "port"
                  else "numpy")
    snapshot()
    f.add_tenant("c", flipflop_engine(pkg, tenant_data["t2"], 4, delta=3))
    f.run_batched(events[30:75])
    snapshot()
    moved = f.remove_tenant("b")
    assert moved.governor is None and moved.pending_swaps
    f.run_batched([e for e in events[75:] if e.tenant_id != "b"][:20])
    snapshot()
    f.add_tenant("b", moved)
    f.run_batched(events[75:])
    snapshot()
    return f.result(), layouts


def test_tenant_churn_keeps_plane_and_traces_equal_to_reference(tenant_data):
    ref, ref_layouts = membership_script("ref", tenant_data)
    got, layouts = membership_script("port", tenant_data)
    assert_same_fleet(got, ref)
    assert layouts == ref_layouts


def test_remove_tenant_releases_scheduler_grants(tenant_data):
    d = tenant_data["t0"]
    sched = te.KConcurrentScheduler(1)
    f = te.FleetEngine({"a": flipflop_engine("port", d, period=1, delta=100),
                        "b": flipflop_engine("port", d, period=1, delta=100)},
                       sched)
    q = tc.Query(lo=np.full(6, -np.inf), hi=np.full(6, np.inf))
    f.step("a", q)          # a charges and acquires the single work unit
    f.step("b", q)          # b charges and queues behind a
    assert sched.in_flight == 1
    f.submit(te.QueryEvent("a", q))
    with pytest.raises(ValueError, match="take_inbox"):
        f.remove_tenant("a")
    assert f.take_inbox("a") == [te.QueryEvent("a", q)]
    engine = f.remove_tenant("a")
    assert engine.governor is None and sched.in_flight == 0
    f.step("b", q)          # b's queued work can now be granted
    assert sched.in_flight == 1
    assert set(f.result().per_tenant) == {"b"}
    with pytest.raises(KeyError):
        f.remove_tenant("a")
    with pytest.raises(ValueError, match="already"):
        f.add_tenant("b", flipflop_engine("port", d))


def test_later_slices_raise_not_implemented(tenant_data):
    """Incremental fleets and ingest events are ported, so the cases check
    the reference's own refusals: mixed incremental modes, and an ingest
    event for a tenant built without ingest (the engine refuses it after
    the fleet clock ticked, as in ``repro``)."""
    d = tenant_data["t0"]
    assert te.FleetEngine({}, incremental=True).incremental
    with pytest.raises(ValueError, match="mix"):
        te.FleetEngine({"a": flipflop_engine("port", d),
                        "b": te.LayoutEngine(
                            FlipFlopPolicy([tc.build_default_layout(
                                0, torch.as_tensor(d), 8)], 5, te),
                            te.InMemoryBackend(torch.as_tensor(d)),
                            incremental=True)})
    with pytest.raises(ValueError, match="incremental"):
        te.FleetEngine({}, incremental=True).add_tenant(
            "a", flipflop_engine("port", d))
    with pytest.raises(ValueError, match="at least one tenant"):
        te.FleetEngine({})
    assert te.FleetEngine({}, incremental=False).tenant_ids == []
    batch = tc.IngestBatch(rows=d[:3].copy())
    ingest = te.IngestEvent("a", batch)
    for drive in ("run", "run_batched"):
        f = te.FleetEngine({"a": flipflop_engine("port", d)})
        with pytest.raises(RuntimeError, match="without ingest"):
            getattr(f, drive)([ingest])
        ref = re_.FleetEngine({"a": flipflop_engine("ref", d)})
        with pytest.raises(RuntimeError, match="without ingest"):
            getattr(ref, drive)([re_.IngestEvent("a", rc.IngestBatch(
                rows=d[:3].copy()))])
        assert f.result().ticks == ref.result().ticks == 1
    with pytest.raises(RuntimeError, match="without ingest"):
        f.step("a", batch)
    with pytest.raises(ValueError, match="compute backend"):
        f.run_batched([], compute="pallas_fused")


# ---------------------------------------------------------------------------
# Packed plane under state and tenant churn
# ---------------------------------------------------------------------------

def make_meta(rng, partitions, columns=3, rows_per=20):
    data = rng.uniform(0, 100, size=(partitions * rows_per, columns))
    assignment = np.repeat(np.arange(partitions), rows_per)
    return rc.layouts.metadata_from_assignment(data, assignment, partitions)


def port_meta(meta):
    return tc.layouts.PartitionMetadata(mins=torch.as_tensor(meta.mins),
                                        maxs=torch.as_tensor(meta.maxs),
                                        rows=torch.as_tensor(meta.rows))


def assert_same_plane(got, ref):
    assert got.tenant_ids == ref.tenant_ids and got.version == ref.version
    assert (got._tcap, got._scap, got._pcap) == (ref._tcap, ref._scap,
                                                 ref._pcap)
    for tid in ref.tenant_ids:
        assert got.tenant_row(tid) == ref.tenant_row(tid)
        assert got.state_ids(tid) == ref.state_ids(tid)
    if ref._mins is not None:
        assert np.array_equal(got._mins.numpy(), ref._mins)
        assert np.array_equal(got._maxs.numpy(), ref._maxs)
        assert np.array_equal(got._rows, ref._rows)
        assert np.array_equal(got._totals, ref._totals)


@pytest.mark.parametrize("lane", LANES)
def test_plane_follows_reference_under_state_and_tenant_churn(lane):
    rng = np.random.default_rng(21)
    ref, got = re_.FleetMatrix(tenant_capacity=2), te.FleetMatrix(
        "cpu", compute_backend=lane, tenant_capacity=2)
    sms = {}
    for step in range(220):
        op = rng.random()
        tids = sorted(sms)
        if op < 0.08 or not tids:
            tid = f"x{step}"
            sms[tid] = (re_.StateMatrix(), te.StateMatrix("cpu"))
            for sid in range(int(rng.integers(0, 3))):
                meta = make_meta(rng, int(rng.integers(2, 9)))
                sms[tid][0].register(sid, meta)
                sms[tid][1].register(sid, port_meta(meta))
            ref.attach(tid, sms[tid][0])
            got.attach(tid, sms[tid][1])
        elif op < 0.13:
            tid = tids[int(rng.integers(len(tids)))]
            ref.detach(tid)
            got.detach(tid)
            del sms[tid]
        elif op < 0.7:
            tid = tids[int(rng.integers(len(tids)))]
            sid = int(rng.integers(-1, 12))
            meta = make_meta(rng, int(rng.integers(1, 14)))
            sms[tid][0].register(sid, meta)
            sms[tid][1].register(sid, port_meta(meta))
        else:
            tid = tids[int(rng.integers(len(tids)))]
            sid = int(rng.integers(-1, 12))
            sms[tid][0].deregister(sid)
            sms[tid][1].deregister(sid)
        assert_same_plane(got, ref)
        if step % 10 == 0 and sms:
            frames = [[(tid, *make_query(rng)) for tid in sorted(sms)
                       if rng.random() < 0.8] for _ in range(3)]
            want = ref.estimate_frames(frames)
            have = got.estimate_frames(frames)
            assert [[None if e is None else (e[0], e[1].tolist(), e[2])
                     for e in fr] for fr in have] == \
                [[None if e is None else (e[0], e[1].tolist(), e[2])
                  for e in fr] for fr in want]
            if ref.last_pass_dense is None:
                assert got.last_pass_dense is None
            else:
                assert np.array_equal(got.last_pass_dense[0],
                                      ref.last_pass_dense[0])
                assert got.last_pass_dense[1] == ref.last_pass_dense[1]
    for tid in sorted(sms):
        ref.detach(tid)
        got.detach(tid)
    assert_same_plane(got, ref)
    with pytest.raises(ValueError, match="compute backend"):
        got.set_compute_backend("numpy")


def make_query(rng, columns=3):
    lo = np.full(columns, -np.inf)
    hi = np.full(columns, np.inf)
    for c in rng.choice(columns, size=int(rng.integers(0, columns + 1)),
                        replace=False):
        lo[c], hi[c] = np.sort(rng.uniform(0, 100, size=2))
    return lo, hi


def test_attach_rejects_a_plane_on_another_device():
    fm = te.FleetMatrix("cpu")
    elsewhere = te.StateMatrix("cpu")
    elsewhere.device = torch.device("cuda", 0)      # as a card's plane says
    with pytest.raises(ValueError, match="cuda:0"):
        fm.attach("a", elsewhere)
    assert len(fm) == 0


# ---------------------------------------------------------------------------
# Host pieces carried over: schedulers, governor hooks, scenarios, events
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    ("unlimited", ()), ("k_concurrent", (2,)),
    ("token_bucket", (0.3, 2.0)), ("token_bucket", (0.05, 1.5, 0.0)),
    ("token_bucket", (0.2, 3.0, None, 40.0))])
def test_scheduler_decisions_equal_reference(spec):
    kind, args = spec
    ref = getattr(re_.SchedulerSpec, kind)(*args).build()
    got = getattr(te.SchedulerSpec, kind)(*args).build()
    assert got.name == ref.name
    rng = np.random.default_rng(len(args) * 7 + len(kind))
    now = 0
    for _ in range(400):
        op = rng.random()
        if op < 0.4:
            now += int(rng.integers(0, 4))
            ref.tick(now)
            got.tick(now)
        elif op < 0.75:
            assert got.try_acquire("t") == ref.try_acquire("t")
        elif op < 0.9:
            ref.release("t")
            got.release("t")
        else:
            want = int(rng.integers(0, 200))
            assert got.grant_rows("t", want) == ref.grant_rows("t", want)
        assert vars(got) == vars(ref)
    assert got.stats() == ref.stats()


def test_scheduler_specs_and_single_use_shim():
    spec = te.SchedulerSpec.token_bucket(rate=0.1, capacity=4.0)
    assert te.as_scheduler_spec(spec) is spec
    assert spec.name == re_.SchedulerSpec.token_bucket(
        rate=0.1, capacity=4.0).name
    a, b = spec.build(), spec.build()
    assert a is not b
    inst = te.KConcurrentScheduler(2)
    with pytest.warns(DeprecationWarning):
        shim = te.as_scheduler_spec(inst)
    assert shim.name == "k2" and shim.build() is inst
    with pytest.raises(ValueError, match="already handed"):
        shim.build()
    with pytest.raises(TypeError):
        te.as_scheduler_spec(object())
    with pytest.raises(ValueError):
        te.SchedulerSpec("nope").build()
    f = te.FleetEngine({"a": flipflop_engine(
        "port", np.random.default_rng(0).uniform(0, 1, (200, 6)))},
        te.SchedulerSpec.k_concurrent(3))
    assert f.scheduler.name == "k3"


class CountingGovernor:
    """Grants every charge; defers each due swap ``hold`` times."""

    def __init__(self, hold):
        self.hold, self.asked, self.log = hold, {}, []

    def on_charge(self, engine, index, state_id):
        self.log.append(("charge", index, state_id))
        return index % 2 == 0

    def may_apply(self, engine, due_index, state_id):
        n = self.asked.get((due_index, state_id), 0)
        self.asked[(due_index, state_id)] = n + 1
        self.log.append(("apply", due_index, state_id, n))
        return n >= self.hold


def test_governed_engine_defers_swaps_like_reference(tenant_data):
    traces = {}
    for pkg in PKGS:
        engine = flipflop_engine(pkg, tenant_data["t1"], period=4, delta=1)
        engine.governor = CountingGovernor(hold=2)
        for ev in column_events(pkg, 60):
            engine.step_fast(ev.query)
        traces[pkg] = (engine.result(), engine.governor.log,
                       engine.pending_swaps)
        engine.finish_migration()
        assert engine.pending_swaps == traces[pkg][2]
    (ref, ref_log, ref_pending), (got, log, pending) = (traces["ref"],
                                                        traces["port"])
    assert log == ref_log and pending == ref_pending
    assert np.array_equal(got.query_costs, ref.query_costs)
    assert got.reorg_indices == ref.reorg_indices
    engine = te.LayoutEngine(FlipFlopPolicy([], 1, te), None)
    assert (engine.incremental, engine.reorg_executor, engine._debt,
            engine._started) == (False, None, None, False)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_drift_scenarios_equal_reference(scenario, bounds):
    lo, hi = bounds
    ref = rc.make_drift_scenario(scenario, lo, hi, num_tenants=4,
                                 queries_per_tenant=90, seed=5)
    got = tc.make_drift_scenario(scenario, lo, hi, num_tenants=4,
                                 queries_per_tenant=90, seed=5)
    assert got.scenario == ref.scenario and len(got) == len(ref)
    assert got.tenant_ids == ref.tenant_ids
    for g, r in zip(got, ref):
        assert g.tenant_id == r.tenant_id
        assert g.query.template_id == r.query.template_id
        assert np.array_equal(g.query.lo, r.query.lo)
        assert np.array_equal(g.query.hi, r.query.hi)
    for tid in ref.tenant_ids:
        assert got.per_tenant[tid].segments == ref.per_tenant[tid].segments
        assert ([dataclasses.astuple(t) for t in
                 got.per_tenant[tid].templates]
                == [dataclasses.astuple(t) for t in
                    ref.per_tenant[tid].templates])
    info = tc.workload.SCENARIO_INFO[scenario]
    assert dataclasses.asdict(info) == dataclasses.asdict(
        rc.workload.SCENARIO_INFO[scenario])
    assert info.period_ticks(90) == rc.workload.SCENARIO_INFO[
        scenario].period_ticks(90)
    assert info.drift_rate(90) == rc.workload.SCENARIO_INFO[
        scenario].drift_rate(90)


def test_scenario_registry_and_event_coercion():
    assert sorted(tc.DRIFT_SCENARIOS) == sorted(SCENARIOS)
    assert tc.workload.forecastable_scenarios() == [
        s for s in rc.workload.forecastable_scenarios()
        if s in tc.DRIFT_SCENARIOS]
    with pytest.raises(KeyError):
        tc.make_drift_scenario("nope", np.zeros(2), np.ones(2))
    q = tc.Query(lo=np.zeros(2), hi=np.ones(2))
    ev = tc.QueryEvent("a", q)
    assert tc.as_event(ev) is ev and ev == ("a", q)
    ingest = tc.IngestEvent("a", None)
    assert tc.as_event(ingest) is ingest
    with pytest.warns(DeprecationWarning):
        assert tc.as_event(("a", q)) == ev
    with pytest.raises(TypeError):
        tc.as_event(("a", "b", "c"))
    with pytest.raises(TypeError):
        tc.as_event(("a", object()))
    f = te.FleetEngine({"a": flipflop_engine(
        "port", np.random.default_rng(1).uniform(0, 100, (300, 6)))})
    with pytest.warns(DeprecationWarning):
        f.submit(("a", q.__class__(lo=np.zeros(6), hi=np.ones(6))))
    assert f.drain() == 1 and f.stats()["ticks"] == 1


def test_state_matrix_public_listener_aliases_warn():
    sm = te.StateMatrix("cpu")
    events = []

    class Mirror:
        def on_register(self, sid, meta):
            events.append(sid)

        def on_deregister(self, sid):
            events.append(-sid)

    mirror = Mirror()
    with pytest.warns(DeprecationWarning):
        sm.add_listener(mirror)
    sm.register(3, port_meta(make_meta(np.random.default_rng(0), 4)))
    with pytest.warns(DeprecationWarning):
        sm.remove_listener(mirror)
    sm.deregister(3)
    assert events == [3]
    assert te.InMemoryBackend._serve_primable is True
