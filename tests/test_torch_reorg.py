"""The port's incremental reorganization plane held against the JAX
package's, on the CPU.

Plans (move order, benefits, block zone maps, identical partitions),
hybrid zone maps, whole incremental ``LayoutEngine`` / ``FleetEngine``
traces and every ``MigrationRecord`` (its ``charges`` ledger included)
must equal ``repro``'s bit for bit on the same seeded inputs, on both of
the port's planner lanes (``move_score`` and ``decision_fused``) and both
fleet scoring lanes; ``repro`` runs its exact ``compute="numpy"`` planner
lane.  With an unbounded row budget the incremental traces must also equal
the atomic ones, as in ``repro``'s own gate (``tests/test_reorg.py``).
"""
import math

import numpy as np
import pytest
import torch

import repro.core as rc
import repro.engine as re_
from repro.core import layout_manager as rlm
from repro.engine.reorg import executor as rex

import repro_torch.core as tc
import repro_torch.engine as te
from repro_torch.core import layout_manager as tlm
from repro_torch.engine.reorg import executor as tex
from repro_torch.engine.reorg import planner as tpl
from repro_torch.kernels.decision_fused import decision_fused
from repro_torch.kernels.move_score import move_score
from test_torch_fleet import assert_same_plane

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


@pytest.fixture(scope="module")
def tenant_data():
    return {f"t{t}": np.random.default_rng(100 + t).uniform(
        0, 100, size=(2_500, 6)) for t in range(3)}


@pytest.fixture(scope="module")
def bounds(tenant_data):
    lo = np.min([d.min(0) for d in tenant_data.values()], axis=0)
    hi = np.max([d.max(0) for d in tenant_data.values()], axis=0)
    return lo, hi


def oreo_engine(pkg, data, incremental=False, rows_per_tick=None,
                alpha=10.0, delta=5, seed=2, lane="move_score"):
    core, eng, lm = PKGS[pkg]
    data = table(pkg, data)
    cfg = core.OreoConfig(alpha=alpha, seed=seed, delta=delta,
                          manager=lm.LayoutManagerConfig(
                              target_partitions=8, window_size=60,
                              gen_every=30))
    policy = eng.OreoPolicy(data, core.build_default_layout(0, data, 8),
                            core.make_generator("qdtree"), cfg)
    kw = {} if pkg == "ref" else {"reorg_compute": lane}
    return eng.LayoutEngine(policy, eng.InMemoryBackend(data),
                            delta=cfg.delta, incremental=incremental,
                            rows_per_tick=rows_per_tick, **kw)


def records(engine):
    return [(m.target_state, m.charged_at, m.begun_at, m.completed_at,
             m.alpha, m.total_rows, m.moved_rows, m.moves_total,
             m.moves_done, m.charges, m.charged)
            for m in engine.reorg_executor.migrations]


def assert_same_run(got, ref):
    assert np.array_equal(got.query_costs, ref.query_costs)
    assert got.reorg_indices == ref.reorg_indices
    assert np.array_equal(got.state_seq, ref.state_seq)
    assert got.total_cost == ref.total_cost


def assert_same_fleet(got, ref, got_fleet=None, ref_fleet=None):
    assert list(got.per_tenant) == list(ref.per_tenant)
    for tid, r in ref.per_tenant.items():
        assert_same_run(got.per_tenant[tid], r)
    assert (got.ticks, got.swaps_deferred, got.deferred_ticks) == \
        (ref.ticks, ref.swaps_deferred, ref.deferred_ticks)
    assert got.scheduler_stats == ref.scheduler_stats
    if got_fleet is not None:
        for tid in ref.per_tenant:
            assert records(got_fleet.tenant(tid)) == \
                records(ref_fleet.tenant(tid)), tid


def stream_of(pkg, *args, **kw):
    return PKGS[pkg][0].make_drift_scenario(*args, **kw)


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------

def random_queries(rng, col_lo, col_hi, n, bounded=2):
    tmpl = rc.make_templates(1, col_lo.shape[0], rng,
                             cols_per_template=(bounded, bounded))[0]
    return [tmpl.sample(rng, col_lo, col_hi) for _ in range(n)]


def layouts_for(pkg, data, case, queries):
    core = PKGS[pkg][0]
    data = table(pkg, data)
    src = core.build_default_layout(0, data, 8, sort_col=0)
    if case == "resorted":
        tgt = core.build_default_layout(1, data, 8, sort_col=1)
    elif case == "identical":
        tgt = core.build_default_layout(1, data, 8, sort_col=0)
    else:
        tgt = core.make_generator("qdtree")(1, data, queries, 8)
    src.materialize(data)
    return data, src, tgt


def port_queries(queries):
    return [tc.Query(lo=q.lo, hi=q.hi) for q in queries]


def assert_same_plan(got, ref):
    assert [(m.target_partition, m.rows, m.source_partitions,
             m.benefit_per_row) for m in got.moves] == \
        [(m.target_partition, m.rows, m.source_partitions,
          m.benefit_per_row) for m in ref.moves]
    assert got.total_move_rows == ref.total_move_rows
    assert got.identical == ref.identical
    assert (got.num_source_partitions, got.num_target_partitions) == \
        (ref.num_source_partitions, ref.num_target_partitions)
    assert np.array_equal(got.source_assignment.numpy(),
                          ref.source_assignment)
    assert np.array_equal(got.target_assignment.numpy(),
                          ref.target_assignment)
    assert np.array_equal(got.block_rows, ref.block_rows)
    assert np.array_equal(got.block_mins.numpy(), ref.block_mins)
    assert np.array_equal(got.block_maxs.numpy(), ref.block_maxs)
    assert np.array_equal(got.target_meta.mins.numpy(),
                          ref.target_meta.mins)
    assert tpl.plan_is_permutation_of_diff(got)


@pytest.mark.parametrize("lane", tpl.COMPUTES)
@pytest.mark.parametrize("case", ["resorted", "identical", "qdtree"])
def test_plans_equal_reference(case, lane):
    rng = np.random.default_rng(3)
    data = rng.uniform(0, 100, size=(3000, 4))
    queries = random_queries(rng, data.min(0), data.max(0), 32)
    _, rsrc, rtgt = layouts_for("ref", data, case, queries)
    tdata, tsrc, ttgt = layouts_for("port", data, case, queries)
    ref = re_.plan_migration(data, rsrc, rtgt, queries)
    got = te.plan_migration(tdata, tsrc, ttgt, port_queries(queries),
                            compute=lane)
    assert_same_plan(got, ref)
    if case == "identical":
        assert got.moves == [] and set(got.identical) == set(range(8))
    else:
        assert got.moves
    per_row = [m.benefit_per_row for m in got.moves]
    assert per_row == sorted(per_row, reverse=True)
    # Without a query window the diff is ordered by partition id.
    bare = te.plan_migration(tdata, tsrc, ttgt, compute=lane)
    assert_same_plan(bare, re_.plan_migration(data, rsrc, rtgt))


def test_relabeled_partitions_never_move():
    """Identity is by content: a pure relabeling needs no moves, a content
    change moves exactly the affected partitions (as in ``repro``)."""
    rng = np.random.default_rng(2)
    n, k = 2000, 8
    data = np.sort(rng.uniform(0, 100, size=(n, 1)), axis=0)
    tdata = torch.as_tensor(data)
    src = tc.build_default_layout(0, tdata, k, sort_col=0)
    a = src.route(tdata)

    def layout_from(assignment, layout_id):
        meta = tc.layouts.metadata_from_assignment(tdata, assignment, k)
        return tc.layouts.Layout(layout_id=layout_id, name=f"t{layout_id}",
                                 technique="test", meta=meta,
                                 route=lambda rows, s=assignment: s)
    swapped = a.clone()
    swapped[a == k - 1] = k - 2
    swapped[a == k - 2] = k - 1
    plan = te.plan_migration(tdata, src, layout_from(swapped, 1))
    assert plan.moves == []
    assert plan.identical[k - 2] == k - 1 and plan.identical[k - 1] == k - 2
    mixed = a.clone()
    top = torch.nonzero(a >= k - 2).flatten()
    mixed[top] = k - 2 + (torch.arange(len(top)) % 2)
    plan2 = te.plan_migration(tdata, src, layout_from(mixed, 2))
    assert sorted(m.target_partition for m in plan2.moves) == [k - 2, k - 1]
    assert set(plan2.identical) == set(range(k - 2))
    with pytest.raises(ValueError, match="go together"):
        te.plan_migration(tdata, src, src, source_meta=src.meta)


def test_hybrid_meta_endpoints_exactness_and_reference():
    rng = np.random.default_rng(5)
    data = rng.uniform(0, 100, size=(2500, 4))
    queries = random_queries(rng, data.min(0), data.max(0), 24)
    _, rsrc, rtgt = layouts_for("ref", data, "qdtree", queries)
    tdata, tsrc, ttgt = layouts_for("port", data, "qdtree", queries)
    ref = re_.plan_migration(data, rsrc, rtgt, queries)
    plan = te.plan_migration(tdata, tsrc, ttgt, port_queries(queries))
    q_lo, q_hi = rc.stack_queries(queries)
    none = plan.hybrid_meta(np.zeros(8, dtype=bool))
    full = plan.hybrid_meta(np.ones(8, dtype=bool))
    assert np.array_equal(tc.layouts.eval_cost(none, q_lo, q_hi),
                          tc.layouts.eval_cost(tsrc.true_meta, q_lo, q_hi))
    assert np.array_equal(tc.layouts.eval_cost(full, q_lo, q_hi),
                          tc.layouts.eval_cost(plan.target_meta, q_lo, q_hi))
    done = np.zeros(8, dtype=bool)
    for move in plan.moves:
        done[move.target_partition] = True
        got, want = plan.hybrid_meta(done), ref.hybrid_meta(done)
        assert np.array_equal(got.mins.numpy(), want.mins)
        assert np.array_equal(got.maxs.numpy(), want.maxs)
        assert np.array_equal(got.rows_host, want.rows)
        assert np.array_equal(got.rows.numpy(), want.rows)
        # Exact zone maps of the physically mixed assignment.
        ta = plan.target_assignment
        mixed = torch.where(torch.as_tensor(done)[ta], 8 + ta,
                            plan.source_assignment)
        exact = tc.layouts.metadata_from_assignment(tdata, mixed, 16)
        assert np.array_equal(got.mins.numpy(), exact.mins.numpy())
        assert np.array_equal(got.rows_host, exact.rows_host)
        i = int(plan.moves[0].source_partitions[0])
        assert np.array_equal(plan.source_moved_mask(i, done).numpy(),
                              ref.source_moved_mask(i, done))
    j = plan.moves[0].target_partition
    assert np.array_equal(plan.target_partition_rows(tdata, j).numpy(),
                          ref.target_partition_rows(data, j))


# ---------------------------------------------------------------------------
# Golden identity: incremental(∞ budget) == atomic == reference, everywhere
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scheduler", list(SCHEDULERS))
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_incremental_equals_atomic_and_reference(scenario, scheduler,
                                                 tenant_data, bounds):
    lo, hi = bounds
    runs = {}
    for pkg, incremental in (("ref", True), ("port", True),
                             ("port", False)):
        eng = PKGS[pkg][1]
        fs = stream_of(pkg, scenario, lo, hi, num_tenants=3,
                       queries_per_tenant=100, seed=7)
        fleet = eng.FleetEngine(
            {tid: oreo_engine(pkg, tenant_data[tid], incremental)
             for tid in fs.tenant_ids}, SCHEDULERS[scheduler](eng))
        assert fleet.incremental == incremental
        runs[pkg, incremental] = (fleet.run(fs), fleet)
    (ref, rf), (got, gf) = runs["ref", True], runs["port", True]
    assert ref.num_reorgs > 0
    assert_same_fleet(got, ref, gf, rf)
    assert_same_fleet(got, runs["port", False][0])
    for tid in got.per_tenant:
        for mig in gf.tenant(tid).reorg_executor.migrations:
            assert mig.completed_at == mig.begun_at
            assert mig.charged == mig.alpha


@pytest.mark.parametrize("rows_per_tick", [None, 150])
@pytest.mark.parametrize("lane", LANES)
def test_run_batched_equals_loop_and_reference(lane, rows_per_tick,
                                               tenant_data, bounds):
    lo, hi = bounds
    rfs = stream_of("ref", "sudden_shift", lo, hi, num_tenants=3,
                    queries_per_tenant=100, seed=3)
    fs = stream_of("port", "sudden_shift", lo, hi, num_tenants=3,
                   queries_per_tenant=100, seed=3)
    rfleet = re_.FleetEngine({tid: oreo_engine(
        "ref", tenant_data[tid], True, rows_per_tick)
        for tid in rfs.tenant_ids})
    ref = rfleet.run(rfs)
    before = (move_score.move_scores.launches,
              decision_fused.fused_decision.launches)
    for drive in ("run", "run_batched"):
        fleet = te.FleetEngine({tid: oreo_engine(
            "port", tenant_data[tid], True, rows_per_tick,
            lane="decision_fused" if lane == "decision_fused"
            else "move_score") for tid in fs.tenant_ids})
        got = (fleet.run(fs) if drive == "run"
               else fleet.run_batched(fs, compute=lane))
        assert_same_fleet(got, ref, fleet, rfleet)
    assert (move_score.move_scores.launches,
            decision_fused.fused_decision.launches) == before


@pytest.mark.parametrize("lane", tpl.COMPUTES)
def test_standalone_engine_atomic_unbounded_and_tight(lane):
    """A standalone engine: incremental with an unbounded budget equals the
    atomic engine; at 137 rows per tick the migrations spread over many
    steps, and both equal the reference's, ledgers included."""
    rng = np.random.default_rng(6)
    data = rng.uniform(0, 100, size=(2000, 5))
    stream = rc.generate_workload(rc.make_templates(2, 5, rng), data.min(0),
                                  data.max(0), total_queries=200, seed=1,
                                  segment_length=(60, 90))
    atomic = oreo_engine("port", data).run(stream)
    assert_same_run(atomic, oreo_engine("ref", data).run(stream))
    for rpt in (None, 137):
        ref_engine = oreo_engine("ref", data, True, rpt)
        engine = oreo_engine("port", data, True, rpt, lane=lane)
        got = engine.run(stream)
        assert_same_run(got, ref_engine.run(stream))
        assert records(engine) == records(ref_engine)
        if rpt is None:
            assert_same_run(got, atomic)
            continue
        completed = [m for m in engine.reorg_executor.migrations
                     if m.completed_at >= 0]
        assert completed
        for mig in completed:
            assert mig.completed_at > mig.begun_at and len(mig.charges) > 1
            assert mig.charged == mig.alpha
        assert engine.reorg_executor.stats() == \
            ref_engine.reorg_executor.stats()


# ---------------------------------------------------------------------------
# Budgets, schedulers and the governor
# ---------------------------------------------------------------------------

def renamed_events(pkg, d, queries, seed):
    wl = PKGS[pkg][0].workload
    fs = stream_of(pkg, "sudden_shift", d.min(0), d.max(0), num_tenants=2,
                   queries_per_tenant=queries, seed=seed)
    return [wl.QueryEvent("a" if tid == "t0" else "b", q) for tid, q in fs]


def test_kconcurrent_holds_unit_for_whole_migration(tenant_data):
    d = tenant_data["t0"]
    out = {}
    for pkg in PKGS:
        eng = PKGS[pkg][1]
        sched = eng.KConcurrentScheduler(1)
        fleet = eng.FleetEngine(
            {"a": oreo_engine(pkg, d, True, 50, delta=0, seed=5),
             "b": oreo_engine(pkg, d, True, 50, delta=0, seed=6)}, sched)
        out[pkg] = (fleet.run(renamed_events(pkg, d, 150, 9)), fleet, sched)
    (ref, rf, rs), (got, gf, gs) = out["ref"], out["port"]
    assert_same_fleet(got, ref, gf, rf)
    in_flight = {tid: sum(m.completed_at < 0 for m in
                          gf.tenant(tid).reorg_executor.migrations)
                 for tid in ("a", "b")}
    assert gf._held == rf._held == in_flight
    assert gs.in_flight == rs.in_flight == sum(in_flight.values())
    assert any(m.completed_at > m.begun_at for tid in ("a", "b")
               for m in gf.tenant(tid).reorg_executor.migrations)


def test_token_bucket_rows_mode(tenant_data, bounds):
    sched = te.TokenBucketScheduler(rate=1.0, capacity=500.0, initial=100.0,
                                    rows_per_token=1.0)
    assert sched.try_acquire("a")
    assert [sched.grant_rows("a", 60) for _ in range(3)] == [60, 40, 0]
    sched.tick(1)
    sched.tick(2)
    assert sched.grant_rows("a", 60) == 2
    lo, hi = bounds
    out = {}
    for pkg in PKGS:
        eng = PKGS[pkg][1]
        fs = stream_of(pkg, "sudden_shift", lo, hi, num_tenants=3,
                       queries_per_tenant=100, seed=7)
        fleet = eng.FleetEngine(
            {tid: oreo_engine(pkg, tenant_data[tid], True)
             for tid in fs.tenant_ids},
            eng.TokenBucketScheduler(rate=40.0, capacity=2000.0, initial=0.0,
                                     rows_per_token=1.0))
        out[pkg] = (fleet.run(fs), fleet)
    (ref, rf), (got, gf) = out["ref"], out["port"]
    assert_same_fleet(got, ref, gf, rf)
    assert any(m.completed_at > m.begun_at for tid in got.per_tenant
               for m in gf.tenant(tid).reorg_executor.migrations)


def test_refusals_of_the_incremental_plane(tenant_data):
    d = tenant_data["t0"]
    with pytest.raises(ValueError, match="incremental"):
        oreo_engine("port", d, incremental=False, rows_per_tick=10)
    with pytest.raises(ValueError, match="positive"):
        oreo_engine("port", d, incremental=True, rows_per_tick=0)
    with pytest.raises(ValueError, match="lane"):
        oreo_engine("port", d, incremental=True, lane="numpy")
    with pytest.raises(ValueError, match="mix"):
        te.FleetEngine({"a": oreo_engine("port", d),
                        "b": oreo_engine("port", d, incremental=True)})
    with pytest.raises(ValueError, match="opposite"):
        te.FleetEngine({"a": oreo_engine("port", d)}, incremental=True)
    fleet = te.FleetEngine({"a": oreo_engine("port", d, incremental=True)})
    with pytest.raises(ValueError, match="incremental"):
        fleet.add_tenant("b", oreo_engine("port", d))
    engine = oreo_engine("port", d, incremental=True)
    with pytest.raises(ValueError, match="batch_serve"):
        engine.run([], batch_serve=True)

    class NoHybrid:
        supports_incremental = False
    with pytest.raises(ValueError, match="hybrid"):
        te.LayoutEngine(engine.policy, NoHybrid(), incremental=True)


# ---------------------------------------------------------------------------
# Hybrid serving through the metadata plane
# ---------------------------------------------------------------------------

def test_hybrid_serving_updates_shadow_through_listener_events(tenant_data):
    """Mid-migration the SERVING_SHADOW carries the hybrid zone maps, and
    serve() equals eval_cost over them and the reference's serve, step by
    step."""
    rng = np.random.default_rng(8)
    d = tenant_data["t0"]
    engines = {pkg: oreo_engine(pkg, d, True, 120, delta=0, alpha=2.0)
               for pkg in PKGS}
    stream = rc.generate_workload(rc.make_templates(2, 6, rng), d.min(0),
                                  d.max(0), total_queries=300, seed=4,
                                  segment_length=(80, 120))
    saw_hybrid = 0
    for q in stream:
        steps = {pkg: e.step(q) for pkg, e in engines.items()}
        assert steps["port"].query_cost == steps["ref"].query_cost
        ex = engines["port"].reorg_executor
        done = ex.done_mask
        if ex.active is not None and done is not None and done.any():
            saw_hybrid += 1
            hybrid = ex._active.hybrid_meta(done)
            backend = engines["port"].backend
            shadow = backend.state_matrix.metadata(backend.SERVING_SHADOW)
            assert shadow.num_partitions == 16
            assert np.array_equal(shadow.rows_host, hybrid.rows_host)
            assert backend.serve(q) == float(tc.layouts.eval_cost(
                hybrid, q.lo, q.hi))
    assert saw_hybrid > 0, "budget never left a migration in flight"
    assert records(engines["port"]) == records(engines["ref"])


@pytest.mark.parametrize("lane", LANES)
def test_fleet_plane_follows_reference_with_hybrid_shadows(lane, tenant_data,
                                                           bounds):
    """Hybrid serving states have P_s + P_t partitions; the listener
    events carry them into the fleet plane, which must keep the
    reference's capacities, slots and bits through the whole run."""
    lo, hi = bounds
    fleets, streams = {}, {}
    for pkg in PKGS:
        eng = PKGS[pkg][1]
        fs = stream_of(pkg, "gradual_drift", lo, hi, num_tenants=3,
                       queries_per_tenant=100, seed=11)
        streams[pkg] = list(fs)
        fleets[pkg] = eng.FleetEngine(
            {tid: oreo_engine(pkg, tenant_data[tid], True, 120)
             for tid in fs.tenant_ids}, eng.KConcurrentScheduler(1))
    widest = 0
    for k in range(0, len(streams["ref"]), 30):
        fleets["ref"].run_batched(streams["ref"][k:k + 30], compute="numpy")
        fleets["port"].run_batched(streams["port"][k:k + 30], compute=lane)
        got, ref = fleets["port"].fleet_matrix, fleets["ref"].fleet_matrix
        assert_same_plane(got, ref)
        widest = max(widest, got.partition_capacity)
    assert widest == 16
    assert_same_fleet(fleets["port"].result(), fleets["ref"].result(),
                      fleets["port"], fleets["ref"])


# ---------------------------------------------------------------------------
# The charge ledger
# ---------------------------------------------------------------------------

def test_closing_increment_and_ledgers_over_a_seeded_grid():
    """Every split of a migration's moves into batches closes the ledger
    bitwise on α, with the reference's increments (the seeded stand-in for
    the reference's property test)."""
    for charged, alpha in [(0.0, 8.0), (7.9999999999999, 8.0),
                           (2.6666666666666665, 8.0), (0.1, 1.0),
                           (1e-30, 1.0), (9.000000000000002, 9.0)]:
        inc = tex.closing_increment(charged, alpha)
        assert inc == rex.closing_increment(charged, alpha)
        assert charged + inc == alpha
    grid = np.random.default_rng(42)
    for case in range(60):
        alpha = float(grid.uniform(0.01, 500.0))
        rows = [int(r) for r in grid.integers(1, 400, int(
            grid.integers(1, 12)))]
        cuts = sorted(grid.integers(0, len(rows) + 1, int(
            grid.integers(0, 8))).tolist())
        groups = [rows[a:b] for a, b in zip([0] + cuts, cuts + [len(rows)])]
        ledgers = []
        for mod in (tex, rex):
            record = mod.MigrationRecord(target_state=1, charged_at=0,
                                         begun_at=0, alpha=alpha,
                                         total_rows=sum(rows),
                                         moves_total=len(rows))
            for k, group in enumerate(groups):
                record.moved_rows += sum(group)
                record.charge(index=k, rows=sum(group),
                              completing=k == len(groups) - 1)
            total = 0.0
            for _, _, charge in record.charges:
                total = total + charge
            assert total == alpha == record.charged, case
            ledgers.append(record.charges)
        assert ledgers[0] == ledgers[1], case


#: The reference's failing property example (``ROADMAP.md`` section 3):
#: the closing charge of seed 7806, 258 rows, 6 partitions, 2 batches.
TIE = (110.64512147955517, 385.76272083412476)


def left_to_right(start, incs):
    total = start
    for inc in incs:
        total = total + inc
    return total


def tie_pairs(seed, n):
    """``n`` (charged, alpha) pairs drawn as a migration's last charge is,
    kept where no single increment lands (the reference raises)."""
    grid = np.random.default_rng(seed)
    pairs = []
    while len(pairs) < n:
        alpha = float(grid.uniform(0.01, 500.0))
        charged = alpha * float(grid.uniform(0.0, 1.0))
        try:
            rex.closing_increment(charged, alpha)
        except AssertionError:
            pairs.append((charged, alpha))
    return pairs


@pytest.mark.parametrize("seed", range(4))
def test_closing_charges_land_on_alpha_in_two_where_the_reference_raises(
        seed):
    """On a halfway tie both packages' single increment raises; the port's
    close is two non-negative entries whose left-to-right sum is alpha,
    the first the largest that keeps the sum below alpha."""
    for charged, alpha in tie_pairs(seed, 50) + [TIE]:
        for mod in (tex, rex):
            with pytest.raises(AssertionError, match="could not close"):
                mod.closing_increment(charged, alpha)
        incs = tex.closing_charges(charged, alpha)
        assert len(incs) == 2 and min(incs) >= 0.0, (charged, alpha)
        assert left_to_right(charged, incs) == alpha, (charged, alpha)
        assert (charged + incs[0] < alpha
                <= charged + math.nextafter(incs[0], math.inf))


@pytest.mark.parametrize("seed", range(2))
def test_closing_charges_are_the_reference_increment_where_it_lands(seed):
    grid = np.random.default_rng(100 + seed)
    pairs = [(0.0, 8.0), (7.9999999999999, 8.0), (2.6666666666666665, 8.0),
             (0.1, 1.0), (1e-30, 1.0), (9.000000000000002, 9.0)]
    for _ in range(2_000):
        alpha = float(grid.uniform(0.01, 500.0))
        pairs.append((alpha * float(grid.uniform(0.0, 1.0)), alpha))
    landed = 0
    for charged, alpha in pairs:
        try:
            want = rex.closing_increment(charged, alpha)
        except AssertionError:
            continue
        assert tex.closing_charges(charged, alpha) == (want,)
        landed += 1
    assert landed > 1_900


def port_migration_plan(seed, rows, partitions, num_queries=4):
    """The port's plan for the reference property tests' migration fixture
    (``tests/test_property.py::_migration_fixture``), from the same draws."""
    rng = np.random.default_rng(seed)
    data = rng.uniform(0, 100, size=(rows, 3))
    queries = []
    for _ in range(num_queries):
        lo, hi = np.full(3, -np.inf), np.full(3, np.inf)
        col = int(rng.integers(3))
        lo[col] = rng.uniform(0, 80)
        hi[col] = lo[col] + rng.uniform(1, 30)
        queries.append(tc.workload.Query(lo=lo, hi=hi))
    table_ = torch.as_tensor(data)
    src = tc.build_default_layout(0, table_, partitions, sort_col=0)
    tgt = tc.make_generator("qdtree")(1, table_, queries, partitions)
    return tpl.plan_migration(table_, src, tgt, queries)


def charge_in_batches(seed, rows, partitions, batches, alpha):
    """The reference property test's schedule on the port's executor: the
    plan's moves cut into ``batches`` groups, the last one completing."""
    plan = port_migration_plan(seed, rows, partitions)
    record = tex.MigrationRecord(target_state=1, charged_at=0, begun_at=0,
                                 alpha=alpha,
                                 total_rows=plan.total_move_rows,
                                 moves_total=plan.num_moves)
    moves = list(plan.moves)
    cuts = sorted(np.random.default_rng(seed).integers(
        0, len(moves) + 1, size=batches - 1).tolist())
    groups = [moves[a:b] for a, b in zip([0] + cuts, cuts + [len(moves)])]
    for k, group in enumerate(groups):
        moved = sum(m.rows for m in group)
        record.moved_rows += moved
        record.charge(index=k, rows=moved,
                      completing=k == len(groups) - 1)
    return record, len(groups)


def assert_closed_on_alpha(record, alpha):
    assert left_to_right(0.0, [c for _, _, c in record.charges]) == alpha
    assert record.charged == alpha
    assert all(rows >= 0 for _, rows, _ in record.charges)
    assert sum(rows for _, rows, _ in record.charges) == record.total_rows


@pytest.mark.parametrize("seed,rows,partitions,batches,alpha", [
    (7806, 258, 6, 2, TIE[1]), (241, 200, 3, 2, 465.2191838128393)])
def test_migration_record_closes_the_reference_failing_example(
        seed, rows, partitions, batches, alpha):
    """Examples on which the reference property test failed."""
    record, groups = charge_in_batches(seed, rows, partitions, batches,
                                       alpha)
    before = left_to_right(0.0, [c for _, _, c in record.charges[:groups - 1]])
    with pytest.raises(AssertionError, match="could not close"):
        rex.closing_increment(before, alpha)      # the reference raises
    assert len(record.charges) == groups + 1      # the two-entry close
    assert record.charges[-1][:2] == (groups - 1, 0)
    assert_closed_on_alpha(record, alpha)


@pytest.mark.parametrize("block", range(4))
def test_migration_record_closes_on_alpha_over_a_seeded_grid(block):
    """50 migrations a block, drawn as the reference property test draws
    them (seed, rows 200-1200, 2-8 partitions, 1-9 batches, alpha)."""
    grid = np.random.default_rng(21 + block)
    for _ in range(50):
        seed = int(grid.integers(0, 10_001))
        rows, partitions = int(grid.integers(200, 1201)), int(
            grid.integers(2, 9))
        batches, alpha = int(grid.integers(1, 10)), float(
            grid.uniform(0.01, 500.0))
        record, _ = charge_in_batches(seed, rows, partitions, batches, alpha)
        assert_closed_on_alpha(record, alpha)


# ---------------------------------------------------------------------------
# Detaching a tenant mid-migration
# ---------------------------------------------------------------------------

def drive_until_in_flight(fleet, tid, events):
    """Drain events one at a time until ``tid`` has a partially-charged
    in-flight migration; returns the events left."""
    events = list(events)
    while events:
        fleet.submit(events.pop(0))
        fleet.drain()
        active = fleet.tenant(tid).reorg_executor.active
        if active is not None and 0.0 < active.charged < active.alpha:
            return events
    raise AssertionError("no partially-charged migration materialized")


@pytest.mark.parametrize("finish", [False, True])
def test_detach_mid_migration_equals_reference(finish, tenant_data, bounds):
    """Detach a tenant with a migration in flight (transplanting its
    partial ledger, or finishing it on α at the detach index), re-attach it
    to a second fleet and finish the stream: trace and ledgers equal the
    reference doing the same, and the transplant equals the never-detached
    run."""
    lo, hi = bounds
    out = {}
    for pkg in PKGS:
        eng = PKGS[pkg][1]
        events = list(stream_of(pkg, "sudden_shift", lo, hi, num_tenants=1,
                                queries_per_tenant=200, seed=9))

        def make():
            return eng.FleetEngine({"t0": oreo_engine(
                pkg, tenant_data["t0"], True, 40)})
        whole = make()
        whole.run(events)
        fleet1 = make()
        remaining = drive_until_in_flight(fleet1, "t0", events)
        record = fleet1.tenant("t0").reorg_executor.active
        index = fleet1.tenant("t0")._index
        engine = fleet1.remove_tenant("t0", finish=finish)
        assert "t0" not in fleet1.tenant_ids and engine.governor is None
        if finish:
            assert engine.reorg_executor.active is None
            assert record.charged == record.alpha
            assert record.completed_at == index
            assert sum(r for _, r, _ in record.charges) == record.total_rows
        else:
            assert engine.reorg_executor.active is record
        fleet2 = eng.FleetEngine({}, incremental=True)
        fleet2.add_tenant("t0", engine)
        for ev in remaining:
            fleet2.submit(ev)
        fleet2.drain()
        out[pkg] = (fleet2.result(), fleet2, whole)
    (ref, rf, rwhole), (got, gf, gwhole) = out["ref"], out["port"]
    assert_same_fleet(got, ref, gf, rf)
    if not finish:
        assert_same_run(got.per_tenant["t0"],
                        gwhole.result().per_tenant["t0"])
        assert records(gf.tenant("t0")) == records(gwhole.tenant("t0"))
    for mig in gf.tenant("t0").reorg_executor.migrations:
        if mig.completed_at >= 0:
            assert mig.charged == mig.alpha


def test_transplant_under_a_refusing_scheduler_holds_free(tenant_data,
                                                          bounds):
    """Re-attached to a fleet whose single unit is taken, an in-flight
    migration keeps moving on a free hold that releases nothing."""
    lo, hi = bounds
    events = list(tc.make_drift_scenario("sudden_shift", lo, hi,
                                         num_tenants=1,
                                         queries_per_tenant=200, seed=9))
    fleet1 = te.FleetEngine({"t0": oreo_engine("port", tenant_data["t0"],
                                               True, 40)})
    remaining = drive_until_in_flight(fleet1, "t0", events)
    engine = fleet1.remove_tenant("t0")
    sched = te.KConcurrentScheduler(1)
    assert sched.try_acquire("other")
    fleet2 = te.FleetEngine({}, sched, incremental=True)
    fleet2.add_tenant("t0", engine)
    assert fleet2._held_free == {"t0": 1} and fleet2._held["t0"] == 0
    while engine.reorg_executor.active is not None:
        fleet2.submit(remaining.pop(0))
        fleet2.drain()
    assert fleet2._held_free == {"t0": 0}
    assert sched.in_flight == 1               # "other"'s unit, untouched
