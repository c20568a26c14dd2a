"""Block estimates held against per-query estimates and the JAX package's.

``LayoutEngine.run`` hands the backend a lookahead
(:class:`repro_torch.engine.state_matrix.BlockEstimates`): the policies'
estimates are scanned a block of queries per pruning launch and each query
takes its row while the plane is unchanged; ``step`` scans one query per
launch.  Every row must equal the per-query estimate and ``repro``'s
``eval_cost_states`` bit for bit, and every trace (OREO, Regret, MTS
Optimal and Greedy under both generators, incremental engines with a
finite row budget, ``DiskBackend``) must equal the port's ``step`` loop
and ``repro``'s ``run``.  On the CPU the block scan is the kernel's plain
version; the CUDA kernel's tiles are tested on a card in
``test_torch_cuda.py``.
"""
import math

import numpy as np
import pytest
import torch

import repro.core as rc
import repro.engine as re_
from repro.core import layout_manager as rlm
from repro.core import layouts as rl

import repro_torch.core as tc
import repro_torch.engine as te
from repro_torch.core import layout_manager as tlm
from repro_torch.engine.state_matrix import BlockEstimates
from repro_torch.kernels.pruning import pruning, ref
from test_torch_cuda import operands
from test_torch_engine import make_meta, make_query, port_meta

PKGS = {"ref": (rc, re_, rlm), "port": (tc, te, tlm)}


def t(a):
    return torch.as_tensor(a)


@pytest.fixture
def block_stats(monkeypatch):
    """(blocks, rows_discarded) of every lookahead closed in the test."""
    seen = []
    close = BlockEstimates.close

    def record(self):
        close(self)
        seen.append((self.blocks, self.rows_discarded))
    monkeypatch.setattr(BlockEstimates, "close", record)
    return seen


def same_trace(got, want):
    assert np.array_equal(got.query_costs, want.query_costs)
    assert got.reorg_indices == want.reorg_indices
    assert np.array_equal(got.state_seq, want.state_seq)
    assert got.total_cost == want.total_cost


# ---------------------------------------------------------------------------
# The block scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("counts", [(16, 16, 16), (16, 7, 37, 5, 1)])
def test_block_rows_equal_per_query_estimates_and_reference(counts):
    rng = np.random.default_rng(sum(counts))
    metas = [make_meta(rng, p) for p in counts]
    sm = te.StateMatrix(torch.device("cpu"))
    for i, m in enumerate(metas):
        sm.register(i, port_meta(m))
    assert sm.uniform == (len(set(counts)) == 1)
    lo, hi = map(np.stack, zip(*[make_query(rng) for _ in range(40)]))
    bounds = t(np.stack([lo, hi]))                     # (2, 40, C)
    scan = sm.scan_block(bounds[0, 3:33], bounds[1, 3:33])   # row slices
    assert scan.shape == (30, len(counts), max(counts))
    assert scan.dtype == np.bool_ and scan.flags.c_contiguous
    for b in range(30):
        k = 3 + b
        got = sm.reduce_scanned(scan[b])
        assert np.array_equal(got, sm.estimate(lo[k], hi[k]))
        assert np.array_equal(got, rl.eval_cost_states(metas, lo[k], hi[k]))


def test_block_overlap_rows_equal_masked_overlap_on_a_plane_view():
    rng = np.random.default_rng(2)
    lo, hi, mins, maxs = operands(rng, 12, 5 * 9, 6)
    mins[3, 2] = maxs[7, 0] = np.nan                   # NaN fails its compare
    plane_min, plane_max = (t(a).reshape(5, 9, 6)[:4] for a in (mins, maxs))
    wide = torch.zeros((2, 20, 8), dtype=torch.float64)
    wide[0, 4:16, :6], wide[1, 4:16, :6] = t(lo), t(hi)
    got = te.compute.block_overlap(plane_min, plane_max, wide[0, 4:16, :6],
                                   wide[1, 4:16, :6])
    assert got.shape == (12, 4, 9)
    for b in range(12):
        assert np.array_equal(got[b], te.compute.masked_overlap(
            plane_min, plane_max, lo[b], hi[b]))


def test_wrapper_takes_row_sliced_bounds_and_checks_path_on_the_cpu():
    rng = np.random.default_rng(3)
    lo, hi, mins, maxs = operands(rng, 10, 20, 5)
    want = ref.scan_matrix(t(lo), t(hi), t(mins), t(maxs))
    bounds = torch.zeros((2, 14, 7), dtype=torch.float64)
    bounds[0, 2:12, :5], bounds[1, 2:12, :5] = t(lo), t(hi)
    for path in pruning.PATHS:
        got = pruning.scan_matrix(bounds[0, 2:12, :5], bounds[1, 2:12, :5],
                                  t(mins), t(maxs), path=path)
        assert torch.equal(got, want)
    for bad in (3, -1):
        with pytest.raises(ValueError, match="path"):
            pruning.scan_matrix(t(lo), t(hi), t(mins), t(maxs), path=bad)
    # One row with strided columns is not dense: the card path refuses it.
    with pytest.raises(ValueError, match="unit column stride"):
        pruning._row_stride("q_lo", torch.zeros((1, 6))[:, ::2])
    assert pruning._row_stride("q_lo", bounds[0, 2:12, :5]) == 7


# ---------------------------------------------------------------------------
# The lookahead: no stale rows, block counts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_bench():
    rng = np.random.default_rng(4)
    data = rng.uniform(0, 100, size=(4000, 6))
    stream = rc.generate_workload(rc.make_templates(3, 6, rng), data.min(0),
                                  data.max(0), total_queries=300, seed=5,
                                  segment_length=(60, 120))
    return data, stream


def test_lookahead_never_hands_out_a_row_of_an_older_plane(small_bench):
    data, stream = small_bench
    tdata = t(data)
    backend = te.InMemoryBackend(tdata)
    layouts = [tc.build_default_layout(i, tdata, 8, sort_col=i)
               for i in range(4)]
    backend.register(layouts[0])
    backend.activate(0)
    queries = stream.queries[:60]
    ahead = backend.open_lookahead(queries, *tc.stack_queries(queries))
    changes = {10: ("register", 1), 11: ("register", 2),
               30: ("deregister", 0), 45: ("activate", 2)}
    sm = backend.state_matrix
    for k, q in enumerate(queries):
        ahead.cursor = k
        ids = sm.state_ids
        got = backend.estimate_costs([s for s in ids if s >= 0], q)
        want = sm.estimate(q.lo, q.hi)
        assert got == {s: float(want[sm.slot(s)]) for s in ids if s >= 0}
        assert np.array_equal(backend.estimate_vector(q), want)
        assert backend.serve(q) == float(want[sm.slot(-1)])    # the memo
        # A query off the cursor takes the per-query path.
        other = queries[(k + 1) % len(queries)]
        blocks = ahead.blocks
        assert np.array_equal(backend.estimate_vector(other),
                              sm.estimate(other.lo, other.hi))
        assert ahead.blocks == blocks
        if k in changes:                # between two steps
            op, sid = changes[k]
            if op == "register":
                backend.register(layouts[sid])
            elif op == "deregister":
                backend.deregister(sid)
            else:
                backend.activate(sid)
    backend.close_lookahead()
    # One block at the start and one after each of the four plane changes;
    # the rows past each change were never consumed.
    assert ahead.blocks == 5
    assert ahead.rows_discarded == 4 * 60 - (11 + 12 + 31 + 46)
    assert backend._lookahead is None


class EstimateProbe:
    """Estimates every query through the backend and checks it against a
    per-query scan of the current plane; registers or deregisters a state
    after the estimate at each position in ``churn``."""

    name = "probe"
    alpha = 1.0

    def __init__(self, layouts, churn=()):
        self.layouts = layouts
        self.churn = dict(churn)
        self.checked = 0

    def bind(self, backend):
        backend.register(self.layouts[0])
        return 0

    def decide(self, index, query, backend):
        sm = backend.state_matrix
        got = backend.estimate_vector(query)
        assert np.array_equal(got, sm.estimate(query.lo, query.hi))
        self.checked += 1
        op = self.churn.get(index)
        if op is not None:
            sid = op[1]
            if op[0] == "register":
                backend.register(self.layouts[sid])
            else:
                backend.deregister(sid)
        return te.Decision(state=0)

    def info(self):
        return {}


@pytest.mark.parametrize("rows", [256, 100, 1000])
def test_a_stream_with_no_plane_change_makes_one_scan_per_block(
        small_bench, block_stats, monkeypatch, rows):
    data, stream = small_bench
    tdata = t(data)
    monkeypatch.setattr(BlockEstimates, "rows", rows)
    queries = list(stream) * 4                          # 1,200 queries
    probe = EstimateProbe([tc.build_default_layout(0, tdata, 8)])
    got = te.LayoutEngine(probe, te.InMemoryBackend(tdata)).run(queries)
    assert probe.checked == len(queries) == len(got.query_costs)
    assert block_stats == [(math.ceil(len(queries) / rows), 0)]


def test_churn_between_steps_is_seen_by_the_next_estimate(
        small_bench, block_stats, monkeypatch):
    data, stream = small_bench
    tdata = t(data)
    monkeypatch.setattr(BlockEstimates, "rows", 1000)   # one block to the end
    layouts = [tc.build_default_layout(i, tdata, 8, sort_col=i % 6)
               for i in range(6)]
    churn = {17: ("register", 1), 18: ("register", 2), 90: ("deregister", 1),
             91: ("register", 3), 150: ("register", 4),
             230: ("deregister", 2)}
    probe = EstimateProbe(layouts, churn)
    te.LayoutEngine(probe, te.InMemoryBackend(tdata)).run(stream)
    n = len(stream)
    starts = [0] + [k + 1 for k in sorted(churn)]
    assert probe.checked == n
    assert block_stats == [(len(starts), sum(n - s for s in starts[1:]))]


# ---------------------------------------------------------------------------
# Whole traces: run (blocks) == step loop (per query) == repro's run
# ---------------------------------------------------------------------------

def policy_for(pkg, data, stream, method, technique, alpha=20.0, parts=8):
    core, eng, lm = PKGS[pkg]
    gen = core.make_generator(technique)
    mgr = lm.LayoutManagerConfig(target_partitions=parts, window_size=60,
                                 gen_every=40)
    initial = core.build_default_layout(0, data, parts)
    if method == "OREO":
        return eng.OreoPolicy(data, initial, gen, core.OreoConfig(
            alpha=alpha, seed=3, manager=mgr))
    if method == "MTS Optimal":
        return eng.MTSOptimalPolicy(data, stream, gen, alpha,
                                    target_partitions=parts, seed=3)
    cls = getattr(eng, f"{method}Policy")
    return cls(data, initial, gen, alpha, mgr_cfg=mgr)


def three_ways(data, stream, method, technique, backend=None, **engine_kw):
    """(port run, port step loop, repro run) of one method; ``backend``
    makes a backend from (package, table)."""
    backend = backend or (lambda pkg, d: PKGS[pkg][1].InMemoryBackend(d))
    out = []
    for pkg, mode in (("port", "run"), ("port", "step"), ("ref", "run")):
        eng = PKGS[pkg][1]
        d = t(data) if pkg == "port" else data
        b = backend(pkg, d)
        engine = eng.LayoutEngine(policy_for(pkg, d, stream, method,
                                             technique), b, **engine_kw)
        if mode == "run":
            res = engine.run(stream)
        else:
            for q in stream:
                engine.step(q)
            res = engine.result()
        ledgers = ([] if engine.reorg_executor is None else
                   [(m.begun_at, m.completed_at, m.charges, m.charged)
                    for m in engine.reorg_executor.migrations])
        if hasattr(b, "close"):
            b.close()
        out.append((res, ledgers))
    return out


@pytest.fixture(scope="module")
def trace_bench():
    rng = np.random.default_rng(6)
    data = rng.uniform(0, 100, size=(4000, 6))
    stream = rc.generate_workload(rc.make_templates(4, 6, rng), data.min(0),
                                  data.max(0), total_queries=400, seed=7,
                                  segment_length=(70, 110))
    return data, stream


@pytest.mark.parametrize("technique", ["qdtree", "zorder"])
@pytest.mark.parametrize("method", ["OREO", "Regret", "MTS Optimal",
                                    "Greedy"])
def test_block_run_equals_step_loop_and_reference(trace_bench, block_stats,
                                                  method, technique):
    data, stream = trace_bench
    (run, _), (step, _), (want, _) = three_ways(data, stream, method,
                                                technique)
    same_trace(run, step)
    same_trace(run, want)
    assert run.info == want.info
    (blocks, discarded), = block_stats
    if method == "Greedy":                  # Greedy never estimates
        assert blocks == 0
    else:
        assert 0 < blocks < len(stream) // 4
    if method in ("OREO", "MTS Optimal", "Greedy"):
        assert run.num_reorgs > 0                     # the trace really moves


@pytest.mark.parametrize("method", ["OREO", "Regret"])
def test_incremental_block_run_equals_step_loop_and_reference(
        trace_bench, block_stats, method):
    """A finite row budget lands hybrid states mid-block: each bumps the
    plane version and the block's later rows are discarded."""
    data, stream = trace_bench
    (run, led), (step, step_led), (want, want_led) = three_ways(
        data, stream, method, "qdtree", incremental=True,
        rows_per_tick=300)
    same_trace(run, step)
    same_trace(run, want)
    assert led == step_led == want_led
    assert any(end > begin for begin, end, _, _ in led)   # spans many ticks
    (blocks, discarded), = block_stats
    assert discarded > 0 and blocks < len(stream)


@pytest.mark.parametrize("rows_per_tick", [None, 600])
def test_disk_backend_block_run_equals_step_loop_and_reference(
        trace_bench, block_stats, tmp_path, rows_per_tick):
    data, stream = trace_bench
    roots = iter(["run", "step", "ref"])

    def disk(pkg, d):
        return PKGS[pkg][1].DiskBackend(d, str(tmp_path / next(roots)),
                                        background=False)
    (run, led), (step, step_led), (want, want_led) = three_ways(
        data, stream, "OREO", "qdtree", backend=disk, delta=5,
        incremental=rows_per_tick is not None, rows_per_tick=rows_per_tick)
    same_trace(run, step)
    same_trace(run, want)
    assert led == step_led == want_led
    assert run.num_reorgs > 0
    (blocks, _), = block_stats
    assert 0 < blocks < len(stream) // 4
