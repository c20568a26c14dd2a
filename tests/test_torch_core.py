"""The port's core modules held against the JAX package's, on the CPU.

Every input comes from a numpy seed and goes through both packages; the
port runs with ``device="cpu"``.  Every comparison is exact: zone maps are
mins, maxs and integer counts, routes are integer ids, and costs reduce
through the same host einsum in both packages.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as rc
from repro.core import layout_manager as rlm
from repro.core import layouts as rl
from repro.core import mts as rmts
from repro.core import predictors as rpred
from repro.core import qdtree as rq
from repro.core import sampling as rs
from repro.data import datasets as rdata
from repro.engine import InMemoryBackend as RBackend

import repro_torch.core as tc
from repro_torch import convert
from repro_torch.core import layout_manager as tlm
from repro_torch.core import layouts as tl
from repro_torch.core import mts as tmts
from repro_torch.core import predictors as tpred
from repro_torch.core import sampling as ts
from repro_torch.data import datasets as tdata
from repro_torch.engine import InMemoryBackend as TBackend
from repro_torch.kernels import _backend

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def t(a):
    return torch.as_tensor(a)


def same_meta(port, ref):
    assert torch.equal(port.mins, t(ref.mins))
    assert torch.equal(port.maxs, t(ref.maxs))
    assert np.array_equal(port.rows_host, ref.rows)
    assert torch.equal(port.rows, t(ref.rows))
    assert port.total_rows == ref.total_rows


def port_templates(templates):
    return [tc.QueryTemplate(x.template_id, x.columns, x.selectivities)
            for x in templates]


@pytest.fixture(scope="module")
def bench():
    rng = np.random.default_rng(0)
    data = rng.uniform(0, 100, size=(20_000, 8))
    data[:, 5] = np.floor(data[:, 5] / 34)            # low-cardinality col
    templates = rc.make_templates(4, 8, rng)
    stream = rc.generate_workload(templates, data.min(0), data.max(0),
                                  total_queries=600, seed=1,
                                  segment_length=(150, 250))
    return data, templates, stream


# ---------------------------------------------------------------------------
# workload, samplers, D-UMTS: host logic, carried over line for line
# ---------------------------------------------------------------------------

def test_workload_generation_draws_the_same_stream(bench):
    data, templates, stream = bench
    rng_a, rng_b = np.random.default_rng(4), np.random.default_rng(4)
    assert [(x.columns, x.selectivities) for x in
            rc.make_templates(6, 8, rng_a, (1, 2), (0.02, 0.1))] == \
        [(x.columns, x.selectivities) for x in
         tc.make_templates(6, 8, rng_b, (1, 2), (0.02, 0.1))]
    for kw in (dict(segment_length=(150, 250)), dict(num_segments=5)):
        ref = rc.generate_workload(templates, data.min(0), data.max(0),
                                   total_queries=600, seed=1, **kw)
        got = tc.generate_workload(port_templates(templates), data.min(0),
                                   data.max(0), total_queries=600, seed=1,
                                   **kw)
        assert got.segments == ref.segments
        for a, b in zip(got, ref):
            assert np.array_equal(a.lo, b.lo) and np.array_equal(a.hi, b.hi)
        lo_a, hi_a = tc.stack_queries(got.queries)
        lo_b, hi_b = rc.stack_queries(ref.queries)
        assert np.array_equal(lo_a, lo_b) and np.array_equal(hi_a, hi_b)
    assert np.array_equal(
        tc.workload.queried_column_histogram(stream.queries, 8),
        rc.workload.queried_column_histogram(stream.queries, 8))


def test_samplers_keep_the_same_items():
    pairs = [(rs.SlidingWindow(7), ts.SlidingWindow(7)),
             (rs.ReservoirSample(9, seed=3), ts.ReservoirSample(9, seed=3)),
             (rs.RTBSample(11, lam=2e-2, seed=5),
              ts.RTBSample(11, lam=2e-2, seed=5))]
    for i in range(400):
        for a, b in pairs:
            a.add(i)
            b.add(i)
    for a, b in pairs:
        assert a.sample() == b.sample()
    assert pairs[2][0].version == pairs[2][1].version


@pytest.mark.parametrize("admission,gamma", [("median", 1.0), ("defer", 0.0),
                                             ("median", 2.0)])
def test_dynamic_umts_event_sequences_match(admission, gamma):
    kw = dict(alpha=6.0, initial_states=[0, 1, 2], seed=11,
              midphase_admission=admission)
    a = rmts.DynamicUMTS(transition_fn=rpred.gamma_biased_transition(gamma),
                         **kw)
    b = tmts.DynamicUMTS(transition_fn=tpred.gamma_biased_transition(gamma),
                         **kw)
    rng = np.random.default_rng(2)
    next_id = 3
    for _ in range(900):
        op = rng.random()
        if op < 0.03:
            a.add_state(next_id)
            b.add_state(next_id)
            next_id += 1
        elif op < 0.05 and len(a.states) > 1:
            victim = int(rng.choice(sorted(a.states)))
            a.remove_state(victim)
            b.remove_state(victim)
        sids = sorted(a.states | a.pending_additions)
        costs = {s: float(rng.uniform(0, 0.5)) for s in sids}
        assert a.observe(costs) == b.observe(costs)
    assert [vars(e) for e in a.events] == [vars(e) for e in b.events]
    assert a.history == b.history and a.counters == b.counters
    assert a.phase == b.phase and a.competitive_bound() == \
        b.competitive_bound()


# ---------------------------------------------------------------------------
# zone maps, layouts, qd-trees: device work, exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("row_scale,chunk_bytes", [(1.0, tl.CHUNK_BYTES),
                                                   (37.5, tl.CHUNK_BYTES),
                                                   (1.0, 5 * 8 * 97)])
def test_metadata_from_assignment_matches(monkeypatch, row_scale,
                                          chunk_bytes):
    """Also with the table reduced in many row blocks (97 rows each)."""
    monkeypatch.setattr(tl, "CHUNK_BYTES", chunk_bytes)
    rng = np.random.default_rng(1)
    data = rng.normal(size=(3000, 5))
    assign = rng.integers(-2, 14, 3000)            # out of range both sides
    assign[assign == 4] = 5                        # partition 4 stays empty
    ref = rl.metadata_from_assignment(data, assign, 12, row_scale=row_scale)
    got = tl.metadata_from_assignment(t(data), t(assign), 12,
                                      row_scale=row_scale)
    same_meta(got, ref)
    assert torch.isinf(got.mins[4]).all() and got.rows_host[4] == 0.0


def test_metadata_from_assignment_of_an_empty_table():
    data, assign = np.zeros((0, 5)), np.zeros(0, dtype=np.int64)
    got = tl.metadata_from_assignment(t(data), t(assign), 3)
    same_meta(got, rl.metadata_from_assignment(data, assign, 3))
    assert torch.isinf(got.maxs).all() and got.total_rows == 0


@pytest.mark.parametrize("sort_col", [None, 2])
def test_build_default_layout_routes_and_metadata(bench, sort_col):
    data = bench[0]
    ref = rq.build_default_layout(0, data, 16, sort_col=sort_col)
    got = tc.build_default_layout(0, t(data), 16, sort_col=sort_col)
    same_meta(got.meta, ref.meta)
    fresh = np.random.default_rng(9).uniform(0, 100, (777, 8))
    for rows in (data, fresh):
        assert np.array_equal(got.route(t(rows)).numpy(), ref.route(rows))
    same_meta(got.materialize(t(data)), ref.materialize(data))


def same_tree(got, ref):
    for name in ("cols", "thresholds", "lefts", "rights", "leaf_ids"):
        assert np.array_equal(getattr(got.route, name).numpy(),
                              getattr(ref.route, name)), name
    assert got.info == ref.info
    same_meta(got.meta, ref.meta)


@pytest.mark.parametrize("k,window", [(16, slice(0, 200)),
                                      (32, slice(150, 600))])
def test_build_qdtree_layout_routes_and_metadata(bench, k, window):
    data, _, stream = bench
    qs = stream.queries[window]
    ref = rq.build_qdtree_layout(7, data, qs, k, seed=7)
    got = tc.build_qdtree_layout(7, t(data), qs, k, seed=7)
    same_tree(got, ref)
    assert np.array_equal(got.route(t(data)).numpy(), ref.route(data))
    same_meta(got.materialize(t(data)), ref.materialize(data))


def outside_queries(n, c, lo, hi):
    """Queries entirely outside the data: no workload cut applies."""
    q_lo = np.full(c, -np.inf)
    q_hi = np.full(c, np.inf)
    q_lo[1], q_hi[1] = lo, hi
    return [rc.Query(q_lo.copy(), q_hi.copy()) for _ in range(n)]


@pytest.mark.parametrize("case", ["unbounded", "outside"])
def test_qdtree_median_fallback_matches(bench, case):
    """No workload cut helps, so every split is the median fallback of
    ``build_qdtree_layout`` (even sample sizes average the two middle
    values, as numpy's median does; the low-cardinality column exercises
    the skip when a median cannot split)."""
    data = bench[0]
    if case == "unbounded":
        qs = [rc.Query(np.full(8, -np.inf), np.full(8, np.inf))] * 5
    else:
        qs = outside_queries(5, 8, 500.0, 600.0)
    ref = rq.build_qdtree_layout(3, data, qs, 12, seed=3)
    got = tc.build_qdtree_layout(3, t(data), qs, 12, seed=3)
    same_tree(got, ref)
    assert (ref.route.cols >= 0).sum() > 1            # it really split
    assert np.array_equal(got.route(t(data)).numpy(), ref.route(data))


def test_qdtree_fallback_skips_unsplittable_column():
    rng = np.random.default_rng(8)
    data = rng.uniform(0, 1, (4000, 3))
    data[:, 0] = 2.0                                  # constant column
    qs = [rc.Query(np.array([-np.inf, -np.inf, -np.inf]),
                   np.array([np.inf, np.inf, np.inf]))]
    qs = [rc.Query(np.array([1.5, -np.inf, -np.inf]),
                   np.array([2.5, np.inf, np.inf]))] + qs
    ref = rq.build_qdtree_layout(1, data, qs, 8, seed=1)
    got = tc.build_qdtree_layout(1, t(data), qs, 8, seed=1)
    same_tree(got, ref)


def test_layout_costs_match(bench):
    data, _, stream = bench
    qs = stream.queries[:200]
    refs = [rq.build_qdtree_layout(i, data, qs, k, seed=i)
            for i, k in ((1, 16), (2, 9), (3, 32))]
    gots = [tc.build_qdtree_layout(i, t(data), qs, k, seed=i)
            for i, k in ((1, 16), (2, 9), (3, 32))]
    lo, hi = rc.stack_queries(stream.queries[200:300])
    for got, ref in zip(gots, refs):
        assert np.array_equal(tl.eval_cost(got.meta, lo, hi),
                              rl.eval_cost(ref.meta, lo, hi))
        assert np.array_equal(tl.eval_skipped(got.meta, lo[0], hi[0]),
                              rl.eval_skipped(ref.meta, lo[0], hi[0]))
        assert np.array_equal(tl.partitions_scanned(got.meta, lo, hi),
                              rl.partitions_scanned(ref.meta, lo, hi))
    for q in range(40):
        assert np.array_equal(
            tl.eval_cost_states([g.meta for g in gots], lo[q], hi[q]),
            rl.eval_cost_states([r.meta for r in refs], lo[q], hi[q]))
    cv = [tl.cost_vector(g.meta, lo, hi) for g in gots]
    rv = [rl.cost_vector(r.meta, lo, hi) for r in refs]
    assert tl.layout_distance(cv[0], cv[1]) == rl.layout_distance(rv[0],
                                                                  rv[1])
    assert tl.layout_distance(cv[0], np.zeros(0)) == float("inf")


def test_layout_manager_admits_and_evicts_the_same_states(bench):
    data, _, stream = bench
    cfg = dict(window_size=60, gen_every=30, max_states=2, rtbs_size=16,
               target_partitions=8, epsilon=0.01)
    ref = rlm.LayoutManager(data, rlm.make_generator("qdtree"),
                            rq.build_default_layout(0, data, 8),
                            rlm.LayoutManagerConfig(**cfg), seed=4)
    got = tlm.LayoutManager(t(data), tlm.make_generator("qdtree"),
                            tc.build_default_layout(0, t(data), 8),
                            tlm.LayoutManagerConfig(**cfg), seed=4)
    events = 0
    for q in stream.queries[:420]:
        a = ref.on_query(q, 0)
        assert got.on_query(q, 0) == a
        events += len(a[1])
    assert events >= 2 and sorted(got.store) == sorted(ref.store)
    cv_r, cv_g = ref._cost_vectors(ref.store), got._cost_vectors(got.store)
    assert all(np.array_equal(cv_g[i], cv_r[i]) for i in cv_r)
    assert got.prune_redundant(0) == ref.prune_redundant(0)
    zgen = tlm.make_generator("zorder")
    assert zgen.technique == "zorder"
    z_got = zgen(1, t(data), stream.queries[:200], 8)
    z_ref = rlm.make_generator("zorder")(1, data, stream.queries[:200], 8)
    assert z_got.name == z_ref.name and z_got.info == z_ref.info
    same_meta(z_got.meta, z_ref.meta)
    with pytest.raises(ValueError):
        tlm.make_generator("hilbert")


# ---------------------------------------------------------------------------
# data, conversion, devices
# ---------------------------------------------------------------------------

def bench_widen():
    spec = importlib.util.spec_from_file_location(
        "bench_common", ROOT / "benchmarks" / "common.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._widen


def test_tables_equal_the_reference_at_the_same_seed():
    ref, names = rdata.make_tpch_like(5000, seed=3)
    got, got_names = tdata.make_tpch_like(5000, seed=3, device="cpu")
    assert got_names == names and torch.equal(got, t(ref))
    wide = bench_widen()(ref, 32, 3)
    assert torch.equal(tdata.widen_columns(got, 32, 3), t(wide))
    assert torch.equal(tdata.build_table(5000, 32, seed=3, device="cpu"),
                       t(wide))
    assert tdata.widen_columns(got, 12, 3) is got


def test_convert_carries_a_reference_layout_across(bench):
    data, _, stream = bench
    queries = stream.queries[:300]
    for ref in (rq.build_qdtree_layout(5, data, queries[:200], 16, seed=5),
                rq.build_default_layout(6, data, 16, sort_col=3),
                rq.build_default_layout(7, data, 16)):
        meta = convert.metadata(ref.meta.mins, ref.meta.maxs, ref.meta.rows,
                                device="cpu")
        r = ref.route
        if isinstance(r, rq._TreeRouter):
            route = convert.tree_router(r.cols, r.thresholds, r.lefts,
                                        r.rights, r.leaf_ids, device="cpu")
        else:
            route = convert.default_router(r.k, r.sort_col, r.boundaries,
                                           device="cpu")
        got = tl.Layout(ref.layout_id, ref.name, ref.technique, meta, route)
        same_meta(got.meta, ref.meta)
        assert np.array_equal(got.route(t(data)).numpy(), ref.route(data))
        rb, tb = RBackend(data), TBackend(t(data))
        rb.register(ref)
        tb.register(got)
        rb.activate(ref.layout_id)
        tb.activate(got.layout_id)
        for q in queries:
            assert tb.serve(q) == rb.serve(q)
        lo, hi = rc.stack_queries(queries)
        assert np.array_equal(tb.serve_block(lo, hi), rb.serve_block(lo, hi))


def test_default_device_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _backend.resolve_device()
    with pytest.raises(RuntimeError):
        tdata.make_tpch_like(10)
    with pytest.raises(RuntimeError):
        tdata.build_table(10, 16)
    with pytest.raises(RuntimeError):
        convert.metadata(np.zeros((2, 1)), np.ones((2, 1)), np.ones(2))
    with pytest.raises(RuntimeError):
        _backend.to_device(np.zeros(3), "cuda")
    assert _backend.resolve_device("cpu") == CPU
