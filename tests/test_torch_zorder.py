"""The port's Z-order path and the paper's evaluation baselines held against
the JAX package's, on the CPU.

Every comparison is bitwise: the plain Z-order keys of both lanes against
``zorder_keys_pallas`` in interpret mode and against ``repro.core.zorder``'s
uint64 keys; Z-order layouts (columns, boundaries, zone maps, routes);
the traces of all six methods of comparison under the Z-order generator;
``OreoRunner``, ``baselines.run_*``, ``CostModel`` and the extensions; a
Z-order layout through the migration planner and the partition store; the
TPC-DS-like and telemetry-like tables.
"""
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.engine as re_
from repro.core import baselines as rb
from repro.core import cost_model as rcm
from repro.core import extensions as rext
from repro.core import layout_manager as rlm
from repro.core import zorder as rz
from repro.data import datasets as rdata
from repro.data.partition_store import PartitionStore as RefStore
from repro.kernels.zorder import ref as z_ref
from repro.kernels.zorder import zorder as z_pallas

import repro_torch.core as tc
import repro_torch.engine as te
from repro_torch import convert
from repro_torch.core import baselines as tb
from repro_torch.core import cost_model as tcm
from repro_torch.core import extensions as text
from repro_torch.core import layout_manager as tlm
from repro_torch.core import zorder as tz
from repro_torch.data import PartitionStore
from repro_torch.data import datasets as tdata
from repro_torch.kernels.zorder import ops as zops
from repro_torch.kernels.zorder import ref as zref
from repro_torch.kernels.zorder import zorder as zkernel

PKGS = {"ref": (rc, re_, rlm), "port": (tc, te, tlm)}
METHODS = ("Static", "Greedy", "Regret", "OREO", "MTS Optimal",
           "Offline Optimal")


def t(a):
    return torch.as_tensor(a)


def table(pkg, data):
    return t(data) if pkg == "port" else data


def same_meta(port, ref):
    assert torch.equal(port.mins, t(ref.mins))
    assert torch.equal(port.maxs, t(ref.maxs))
    assert np.array_equal(port.rows_host, ref.rows)
    assert torch.equal(port.rows, t(ref.rows))


def same_trace(got, ref):
    assert np.array_equal(got.query_costs, ref.query_costs)
    assert got.reorg_indices == ref.reorg_indices
    assert np.array_equal(got.state_seq, ref.state_seq)
    assert got.total_cost == ref.total_cost
    assert got.info == ref.info


# ---------------------------------------------------------------------------
# Plain keys, lane (a): the TPU kernel's float32 function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,m,bits", [(100, 3, 10), (1024, 2, 16),
                                      (4097, 3, 8), (64, 1, 16), (33, 4, 8)])
def test_plain_keys_equal_pallas_and_oracle(N, m, bits):
    rng = np.random.default_rng(N)
    vals = rng.uniform(-5, 5, (N, m)).astype(np.float32)
    lo, hi = vals.min(0), vals.max(0)
    want = np.asarray(z_pallas.zorder_keys_pallas(vals, lo, hi, bits=bits,
                                                  interpret=True))
    oracle = np.asarray(z_ref.zorder_keys(jnp.asarray(vals), jnp.asarray(lo),
                                          jnp.asarray(hi), bits=bits))
    got = zops.zorder_keys(t(vals), t(lo), t(hi), bits)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert np.array_equal(got.numpy(), oracle.astype(np.int64))
    # A narrower [lo, hi] sends values past both ends through the clamp.
    lo2, hi2 = lo + 1, hi - 1
    want2 = np.asarray(z_pallas.zorder_keys_pallas(vals, lo2, hi2, bits=bits,
                                                   interpret=True))
    assert np.array_equal(
        zref.zorder_keys(t(vals), t(lo2), t(hi2), bits).numpy(),
        want2.astype(np.int64))


def test_plain_keys_degenerate_span_and_empty_input():
    rng = np.random.default_rng(5)
    vals = rng.uniform(-1, 1, (257, 3)).astype(np.float32)
    vals[:, 1] = 0.25
    lo, hi = vals.min(0), vals.max(0)
    assert lo[1] == hi[1]                   # the 1e-12 floor of the span
    want = np.asarray(z_pallas.zorder_keys_pallas(vals, lo, hi, bits=10,
                                                  interpret=True))
    assert np.array_equal(zops.zorder_keys(t(vals), t(lo), t(hi), 10).numpy(),
                          want.astype(np.int64))
    empty = zops.zorder_keys(torch.zeros((0, 3)), t(lo), t(hi), 10)
    assert empty.shape == (0,) and empty.dtype == torch.int64
    empty64 = zops.zorder_keys64(torch.zeros((0, 4), dtype=torch.float64),
                                 [0, 2], torch.zeros(2, dtype=torch.float64),
                                 torch.ones(2, dtype=torch.float64))
    assert empty64.shape == (0,) and empty64.dtype == torch.int64


def test_wrappers_refuse_what_the_kernel_cannot_take():
    v = torch.zeros((4, 3))
    b3 = torch.zeros(3)
    with pytest.raises(ValueError, match="m \\* bits"):
        zops.zorder_keys(v, b3, b3, 11)
    with pytest.raises(TypeError):
        zops.zorder_keys(v.double(), b3, b3, 10)
    with pytest.raises(ValueError, match="shape"):
        zops.zorder_keys(v, torch.zeros(2), b3, 10)
    tab = torch.zeros((4, 5), dtype=torch.float64)
    b2 = torch.zeros(2, dtype=torch.float64)
    with pytest.raises(ValueError, match="out of range"):
        zops.zorder_keys64(tab, [0, 5], b2, b2)
    with pytest.raises(TypeError):
        zops.zorder_keys64(tab, [0, 1], b2.float(), b2)
    assert zkernel.zorder_keys.launches == 0     # CPU calls launch nothing
    assert zkernel.zorder_keys64.launches == 0
    assert zkernel.zorder_route64.launches == 0


# ---------------------------------------------------------------------------
# Plain keys, lane (b): the layout generator's float64, 64-bit function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 2, 3, 4, 5])
def test_plain_keys64_equal_core_numpy(m):
    rng = np.random.default_rng(40 + m)
    data = rng.uniform(-50, 150, (6000, 7))
    zcols = np.sort(rng.choice(7, m, replace=False))
    sample = data[:500, zcols]
    col_lo, col_hi = sample.min(0), sample.max(0)   # the rest lies outside
    assert (data[:, zcols] < col_lo).any() and (data[:, zcols] > col_hi).any()
    want = rz.interleave_bits(rz.quantize_columns(data[:, zcols], col_lo,
                                                  col_hi))
    keys = zops.zorder_keys64(t(data), zcols, t(col_lo), t(col_hi))
    assert np.array_equal(zref.unflip(keys), want)
    if m >= 4:                                      # bit 63 is reached
        assert (want >> np.uint64(63)).any()
    # Signed order of the flipped keys is the unsigned order.
    assert np.array_equal(torch.argsort(keys, stable=True).numpy(),
                          np.argsort(want, kind="stable"))
    # The port's host copies are the reference's.
    codes = tz.quantize_columns(data[:, zcols], col_lo, col_hi)
    assert np.array_equal(codes, rz.quantize_columns(data[:, zcols], col_lo,
                                                     col_hi))
    assert np.array_equal(tz.interleave_bits(codes), want)


def test_plain_keys64_read_a_strided_view():
    rng = np.random.default_rng(8)
    wide = t(rng.uniform(0, 10, (900, 12)))
    view = wide[::3, 2:9]                         # row stride 36, 7 columns
    lo, hi = view.amin(0)[[1, 4]], view.amax(0)[[1, 4]]
    want = zops.zorder_keys64(view.contiguous(), [1, 4], lo, hi)
    assert torch.equal(zops.zorder_keys64(view, [1, 4], lo, hi), want)


def strided_copies(table):
    """The same (N, C) values as a column-major table and as a view of
    every other column of a table twice as wide."""
    columnar = table.t().contiguous().t()
    wide = torch.zeros((table.shape[0], 2 * table.shape[1]),
                       dtype=table.dtype)
    wide[:, ::2] = table
    return {"column-major": columnar, "column stride 2": wide[:, ::2]}


@pytest.mark.parametrize("k", [1, 2, 16, 32])
def test_route64_equals_reference_router(bench, k):
    """ref.zorder_route64 and the wrapper on CPU tensors against the
    reference's own Z-order routers: keys on a boundary, values past
    lo/hi, any strides."""
    data, stream = bench
    ref = rz.build_zorder_layout(4, data[:3000], stream.queries[:300], k)
    r = ref.route
    keys = rz.interleave_bits(rz.quantize_columns(data[:, r.zcols],
                                                  r.col_lo, r.col_hi))
    if k > 1:                       # rows of the table sit on boundaries
        assert np.isin(keys, r.boundaries).sum() >= k - 1
    sub = data[:, r.zcols]
    assert (sub < r.col_lo).any() and (sub > r.col_hi).any()
    want = r(data)
    tdata_ = t(data)
    bnd = zref.flip(t(np.ascontiguousarray(r.boundaries).view(np.int64)))
    args = (r.zcols, t(r.col_lo), t(r.col_hi), bnd, k)
    got = zref.zorder_route64(tdata_, *args)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(zops.zorder_route64(tdata_, *args).numpy(), want)
    for name, view in strided_copies(tdata_).items():
        assert torch.equal(zops.zorder_route64(view, *args), got), name
    assert zkernel.zorder_route64.launches == 0  # CPU calls launch nothing


def test_keys64_read_column_major_and_column_stride_2():
    rng = np.random.default_rng(9)
    table = t(rng.uniform(-50, 150, (3001, 9)))
    for zcols in ([4], [0, 8], [1, 3, 7], [0, 2, 5, 6], [0, 1, 2, 4, 8]):
        lo, hi = table[:500, zcols].amin(0), table[:500, zcols].amax(0)
        want = zops.zorder_keys64(table, zcols, lo, hi)
        for name, view in strided_copies(table).items():
            assert torch.equal(zops.zorder_keys64(view, zcols, lo, hi),
                               want), (name, zcols)


def test_route64_refuses_what_the_kernel_cannot_take():
    tab = torch.zeros((4, 5), dtype=torch.float64)
    b2 = torch.zeros(2, dtype=torch.float64)
    big = zkernel.MAX_PARTS + 1
    with pytest.raises(ValueError, match="partitions"):
        zops.zorder_route64(tab, [0, 1], b2, b2,
                            torch.zeros(big - 1, dtype=torch.int64), big)
    with pytest.raises(ValueError, match="partitions"):
        zops.zorder_route64(tab, [0, 1], b2, b2,
                            torch.zeros(0, dtype=torch.int64), 0)
    with pytest.raises(ValueError, match="shape"):
        zops.zorder_route64(tab, [0, 1], b2, b2,
                            torch.zeros(3, dtype=torch.int64), 3)
    with pytest.raises(TypeError):
        zops.zorder_route64(tab, [0, 1], b2, b2, torch.zeros(2), 3)
    with pytest.raises(ValueError, match="out of range"):
        zops.zorder_route64(tab, [0, 5], b2, b2,
                            torch.zeros(2, dtype=torch.int64), 3)
    # The most partitions the kernel takes route on the CPU as well; the
    # all-zero key (INT64_MIN flipped) equals the first boundary.
    ids = zops.zorder_route64(
        tab, [0, 1], b2, b2 + 1,
        torch.arange(zkernel.MAX_PARTS - 1) + torch.iinfo(torch.int64).min,
        zkernel.MAX_PARTS)
    assert ids.tolist() == [1] * 4


def test_zorder_build_keys_its_sample_once(bench, monkeypatch):
    """A build makes one key call (on the contiguous key columns) and no
    route call; its sample's assignment is route(sample) bit for bit."""
    data, stream = bench
    calls = {"zorder_keys64": [], "zorder_route64": []}
    for name in calls:
        inner = getattr(zops, name)

        def counted(table, *a, _inner=inner, _name=name):
            calls[_name].append(tuple(table.shape))
            return _inner(table, *a)
        monkeypatch.setattr(zops, name, counted)
    seen = {}
    inner_meta = tc.layouts.metadata_from_assignment

    def capture(sample, assignment, k, **kw):
        seen.update(sample=sample, assignment=assignment)
        return inner_meta(sample, assignment, k, **kw)
    monkeypatch.setattr(tc.layouts, "metadata_from_assignment", capture)
    got = tz.build_zorder_layout(3, t(data), stream.queries[:300], 32)
    assert calls == {"zorder_keys64": [(got.info["sample_rows"], 3)],
                     "zorder_route64": []}
    routed = got.route(seen["sample"])
    assert calls["zorder_route64"] == [tuple(seen["sample"].shape)]
    assert torch.equal(seen["assignment"], routed)
    ref = rz.build_zorder_layout(3, data, stream.queries[:300], 32)
    assert np.array_equal(routed.numpy(),
                          ref.route(seen["sample"].numpy()))


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bench():
    rng = np.random.default_rng(0)
    data = rng.uniform(0, 100, size=(20_000, 8))
    templates = rc.make_templates(4, 8, rng)
    stream = rc.generate_workload(templates, data.min(0), data.max(0),
                                  total_queries=1500, seed=1,
                                  segment_length=(300, 500))
    return data, stream


def same_zorder_layout(got, ref, data):
    assert got.name == ref.name and got.info == ref.info
    assert got.technique == ref.technique == "zorder"
    assert np.array_equal(got.route.zcols, ref.route.zcols)
    assert torch.equal(got.route.col_lo, t(ref.route.col_lo))
    assert torch.equal(got.route.col_hi, t(ref.route.col_hi))
    assert np.array_equal(zref.unflip(got.route.boundaries),
                          ref.route.boundaries)
    same_meta(got.meta, ref.meta)
    assert np.array_equal(got.route(t(data)).numpy(), ref.route(data))


@pytest.mark.parametrize("k,window,kw", [
    (16, slice(0, 200), {}), (1, slice(0, 200), {}),
    (7, slice(400, 500), {"num_zcols": 2, "seed": 3}),
    (32, slice(0, 0), {"sample_frac": 0.5}),          # no queries
])
def test_build_zorder_layout_equals_reference(bench, k, window, kw):
    data, stream = bench
    queries = stream.queries[window]
    ref = rz.build_zorder_layout(5, data, queries, k, **kw)
    got = tz.build_zorder_layout(5, t(data), queries, k, **kw)
    same_zorder_layout(got, ref, data)
    same_meta(got.materialize(t(data)), ref.materialize(data))
    assert isinstance(tc.make_generator("zorder"), tlm.LayoutGenerator)
    gen = tc.make_generator("zorder")(9, t(data), queries, k)
    same_zorder_layout(gen, rc.make_generator("zorder")(9, data, queries, k),
                       data)


def test_convert_zorder_router_carries_a_reference_layout(bench):
    data, stream = bench
    ref = rz.build_zorder_layout(2, data, stream.queries[:300], 12)
    r = ref.route
    route = convert.zorder_router(r.zcols, r.col_lo, r.col_hi, r.boundaries,
                                  r.k, device="cpu")
    assert route.boundaries.dtype == torch.int64
    assert np.array_equal(route(t(data)).numpy(), r(data))
    layout = tc.layouts.Layout(
        2, ref.name, "zorder", convert.metadata(ref.meta.mins, ref.meta.maxs,
                                                ref.meta.rows, device="cpu"),
        route)
    same_meta(layout.materialize(t(data)), ref.materialize(data))


def test_zorder_layout_through_planner_and_partition_store(bench, tmp_path):
    from repro.engine.reorg import planner as rpl
    from repro_torch.engine.reorg import planner as tpl
    from test_torch_disk import assert_same_store
    from test_torch_reorg import assert_same_plan, port_queries
    data, stream = bench
    data = data[:4000]
    tdata = t(data)
    queries = stream.queries[:200]
    src = {"ref": rc.build_default_layout(0, data, 8, sort_col=0),
           "port": tc.build_default_layout(0, tdata, 8, sort_col=0)}
    tgt = {"ref": rz.build_zorder_layout(1, data, queries, 8),
           "port": tz.build_zorder_layout(1, tdata, queries, 8)}
    src["ref"].materialize(data)
    src["port"].materialize(tdata)
    ref = rpl.plan_migration(data, src["ref"], tgt["ref"], queries,
                             compute="numpy")
    for lane in tpl.COMPUTES:
        got = tpl.plan_migration(tdata, src["port"], tgt["port"],
                                 port_queries(queries), compute=lane)
        assert_same_plan(got, ref)
    ref_store = RefStore(str(tmp_path / "ref"))
    got_store = PartitionStore(str(tmp_path / "port"), device="cpu")
    ref_store.write(data, tgt["ref"])
    got_store.write(tdata, tgt["port"])
    assert_same_store(got_store, ref_store)
    assert os.path.exists(os.path.join(got_store.root, "manifest.json"))


# ---------------------------------------------------------------------------
# The six methods of comparison under Z-order
# ---------------------------------------------------------------------------

def method_policy(pkg, data, stream, method, alpha, parts, technique):
    core, eng, lm = PKGS[pkg]
    data = table(pkg, data)
    gen = core.make_generator(technique)
    mgr = lm.LayoutManagerConfig(target_partitions=parts)
    if method == "Static":
        return eng.StaticPolicy(data, stream, gen, alpha,
                                target_partitions=parts)
    if method in ("Greedy", "Regret"):
        cls = getattr(eng, f"{method}Policy")
        return cls(data, core.build_default_layout(0, data, parts), gen,
                   alpha, mgr_cfg=mgr)
    if method == "OREO":
        return eng.OreoPolicy(data, core.build_default_layout(0, data, parts),
                              gen, core.OreoConfig(alpha=alpha, seed=3,
                                                   manager=mgr))
    if method == "MTS Optimal":
        return eng.MTSOptimalPolicy(data, stream, gen, alpha,
                                    target_partitions=parts, seed=3)
    return eng.OfflineOptimalPolicy(data, stream, gen, alpha,
                                    target_partitions=parts)


def run_method(pkg, data, stream, method, alpha=40.0, parts=16,
               technique="zorder"):
    core, eng, _ = PKGS[pkg]
    policy = method_policy(pkg, data, stream, method, alpha, parts,
                           technique)
    return eng.LayoutEngine(policy, eng.InMemoryBackend(table(pkg, data))
                            ).run(stream, name=method)


@pytest.mark.parametrize("method", METHODS)
def test_six_methods_under_zorder_equal_reference(bench, method):
    data, stream = bench
    ref = run_method("ref", data, stream, method)
    got = run_method("port", data, stream, method)
    same_trace(got, ref)
    assert got.name == ref.name == method
    if method in ("Greedy", "MTS Optimal", "Offline Optimal"):
        assert got.num_reorgs > 0                     # the trace really moves


def fig3_bench(dataset, rows, queries):
    """``benchmarks/common.py::build_bench`` at ``rows`` rows, 8 columns
    (telemetry keeps its 9) and 6 segments."""
    data, _ = rdata.DATASETS[dataset](rows, seed=0)
    rng = np.random.default_rng(10)
    if dataset == "telemetry":
        templates = rdata.telemetry_templates(data.shape[1], seed=0)
    else:
        data = data[:, :8]
        templates = rc.make_templates(6, 8, rng, cols_per_template=(1, 2),
                                      selectivity_range=(0.02, 0.10))
    stream = rc.generate_workload(templates, data.min(0), data.max(0),
                                  total_queries=queries, seed=20,
                                  num_segments=6)
    return data, stream


@pytest.mark.parametrize("dataset", ["tpch", "tpcds", "telemetry"])
def test_fig3_shaped_runs_equal_reference(dataset):
    data, stream = fig3_bench(dataset, 5000, 600)
    port_table, _ = tdata.DATASETS[dataset](5000, seed=0, device="cpu")
    assert torch.equal(port_table[:, :data.shape[1]], t(data))
    for method in METHODS:
        same_trace(run_method("port", data, stream, method, alpha=20.0,
                              parts=8),
                   run_method("ref", data, stream, method, alpha=20.0,
                              parts=8))


# ---------------------------------------------------------------------------
# OreoRunner, baselines.run_*, CostModel, extensions
# ---------------------------------------------------------------------------

def test_oreo_runner_is_a_deprecated_alias(bench):
    data, stream = bench
    data = data[:5000]
    tdata_ = t(data)
    cfg = dict(alpha=20.0, seed=1)
    with pytest.warns(DeprecationWarning):
        got = tc.OreoRunner(tdata_, tc.build_default_layout(0, tdata_, 8),
                            tc.make_generator("zorder"),
                            tc.OreoConfig(**cfg, manager=tc.
                                          LayoutManagerConfig(
                                              target_partitions=8)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = rc.OreoRunner(data, rc.build_default_layout(0, data, 8),
                            rc.make_generator("zorder"),
                            rc.OreoConfig(**cfg, manager=rc.
                                          LayoutManagerConfig(
                                              target_partitions=8)))
    same_trace(got.run(stream), ref.run(stream))
    assert got.manager is got.policy.manager
    assert got.dumts.num_moves == ref.dumts.num_moves
    assert sorted(got.manager.store) == sorted(ref.manager.store)


def test_baseline_run_functions_equal_reference(bench):
    data, stream = bench
    data = data[:6000]
    tdata_ = t(data)
    mgr = dict(target_partitions=8)
    gens = {"ref": rc.make_generator("zorder"),
            "port": tc.make_generator("zorder")}
    pairs = [
        (tb.run_static(tdata_, stream, gens["port"], 30.0, 8),
         rb.run_static(data, stream, gens["ref"], 30.0, 8)),
        (tb.run_greedy(tdata_, stream, gens["port"],
                       tc.build_default_layout(0, tdata_, 8), 30.0,
                       tc.LayoutManagerConfig(**mgr)),
         rb.run_greedy(data, stream, gens["ref"],
                       rc.build_default_layout(0, data, 8), 30.0,
                       rc.LayoutManagerConfig(**mgr))),
        (tb.run_regret(tdata_, stream, gens["port"],
                       tc.build_default_layout(0, tdata_, 8), 30.0,
                       tc.LayoutManagerConfig(**mgr), max_candidates=4),
         rb.run_regret(data, stream, gens["ref"],
                       rc.build_default_layout(0, data, 8), 30.0,
                       rc.LayoutManagerConfig(**mgr), max_candidates=4)),
        (tb.run_mts_optimal(tdata_, stream, gens["port"], 30.0, 8,
                            gamma=0.5, seed=2),
         rb.run_mts_optimal(data, stream, gens["ref"], 30.0, 8, gamma=0.5,
                            seed=2)),
        (tb.run_offline_optimal(tdata_, stream, gens["port"], 30.0, 8),
         rb.run_offline_optimal(data, stream, gens["ref"], 30.0, 8)),
    ]
    for got, ref in pairs:
        assert got.name == ref.name
        same_trace(got, ref)
    per_t = tb.per_template_layouts(tdata_, stream, gens["port"], 8, 50)
    per_r = rb.per_template_layouts(data, stream, gens["ref"], 8, 50)
    assert sorted(per_t) == sorted(per_r)
    for tid, lay in per_t.items():
        assert lay.name == per_r[tid].name
        same_meta(lay.true_meta, per_r[tid].true_meta)


def test_cost_model_equals_reference(bench):
    data, stream = bench
    ref_l = rz.build_zorder_layout(1, data, stream.queries[:200], 16)
    got_l = tz.build_zorder_layout(1, t(data), stream.queries[:200], 16)
    a, b = tcm.CostModel(alpha=60.0, full_scan_seconds=0.5), \
        rcm.CostModel(alpha=60.0, full_scan_seconds=0.5)
    for q in stream.queries[:50]:
        assert a.query_cost(got_l, q) == b.query_cost(ref_l, q)
    q_lo, q_hi = rc.stack_queries(stream.queries[:300])
    assert np.array_equal(a.query_costs(got_l, q_lo, q_hi),
                          b.query_costs(ref_l, q_lo, q_hi))
    assert a.reorg_cost == b.reorg_cost == 60.0
    assert a.to_seconds(3.0) == b.to_seconds(3.0)
    assert tc.CostModel is tcm.CostModel


@pytest.mark.parametrize("kappa,seed", [(1, 0), (2, 3), (3, 7)])
def test_multicopy_dumts_equals_reference(kappa, seed):
    rng = np.random.default_rng(seed)
    a = text.MultiCopyDUMTS(5.0, [0, 1, 2], kappa=kappa, seed=seed)
    b = rext.MultiCopyDUMTS(5.0, [0, 1, 2], kappa=kappa, seed=seed)
    for i in range(400):
        if i in (50, 120, 260):
            a.add_state(10 + i)
            b.add_state(10 + i)
        costs = {s: float(rng.random()) for s in sorted(b.states)}
        assert a.observe(costs) == b.observe(costs)
        assert a.held == b.held
    assert (a.moves, a.phase, a.total_reorg_cost) == \
        (b.moves, b.phase, b.total_reorg_cost)
    assert b.moves > 0
    with pytest.raises(ValueError):
        text.MultiCopyDUMTS(1.0, [0], kappa=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_two_state_functions_equal_reference(seed):
    rng = np.random.default_rng(seed)
    ca = rng.random(300) * (1 + np.sin(np.arange(300) / 20))
    cb = rng.random(300) * (1 + np.cos(np.arange(300) / 20))
    ab, ba = float(rng.uniform(1, 5)), float(rng.uniform(1, 5))
    total, seq = text.two_state_asymmetric(ca, cb, ab, ba)
    assert (total, seq) == rext.two_state_asymmetric(ca, cb, ab, ba)
    opt = text.offline_two_state(ca, cb, ab, ba)
    assert opt == rext.offline_two_state(ca, cb, ab, ba)
    assert opt <= total and len(set(seq)) == 2


# ---------------------------------------------------------------------------
# Datasets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tpch", "tpcds", "telemetry"])
def test_datasets_equal_reference_bit_for_bit(name):
    for rows, seed in ((3000, 0), (1, 5), (20_001, 11)):
        want, names = rdata.DATASETS[name](rows, seed=seed)
        got, got_names = tdata.DATASETS[name](rows, seed=seed, device="cpu")
        assert got_names == names
        assert got.dtype == torch.float64 and got.is_contiguous()
        assert torch.equal(got, t(want))
    default_seed = {"tpch": 0, "tpcds": 1, "telemetry": 2}[name]
    assert torch.equal(tdata.DATASETS[name](500, device="cpu")[0],
                       t(rdata.DATASETS[name](500, seed=default_seed)[0]))


def test_telemetry_templates_equal_reference():
    for seed in (0, 4):
        want = rdata.telemetry_templates(9, seed=seed)
        got = tdata.telemetry_templates(9, seed=seed)
        assert [(x.template_id, x.columns, x.selectivities) for x in got] \
            == [(x.template_id, x.columns, x.selectivities) for x in want]
        assert all(isinstance(x, tc.QueryTemplate) for x in got)
