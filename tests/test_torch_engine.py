"""The port's engine held against the JAX package's, on the CPU.

StateMatrix estimates, backend serving and whole ``LayoutEngine`` traces
(OREO, Static, Greedy, Regret; ``step`` and the batched ``run``) must equal
``repro``'s bit for bit on the same seeded inputs: the scan is exact and
both packages reduce it through the same host einsum.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as rc
import repro.engine as re_
from repro.core import layouts as rl

import repro_torch.core as tc
import repro_torch.engine as te
from repro_torch.kernels.pruning import pruning

ROOT = Path(__file__).resolve().parents[1]


def t(a):
    return torch.as_tensor(a)


def make_meta(rng, p, c=6, n=3000):
    data = rng.uniform(0, 1, (n, c))
    order = np.argsort(data[:, int(rng.integers(c))], kind="stable")
    assignment = np.empty(n, dtype=np.int64)
    assignment[order] = np.arange(n) * p // n
    return rl.metadata_from_assignment(data, assignment, p)


def port_meta(meta):
    return tc.layouts.PartitionMetadata(mins=t(meta.mins), maxs=t(meta.maxs),
                                        rows=t(meta.rows))


def make_query(rng, c=6):
    lo = np.full(c, -np.inf)
    hi = np.full(c, np.inf)
    for col in rng.choice(c, size=int(rng.integers(0, c + 1)),
                          replace=False):
        lo[col] = rng.uniform(0, 0.7)
        hi[col] = lo[col] + rng.uniform(0, 0.4)
    return lo, hi


# ---------------------------------------------------------------------------
# StateMatrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("counts", [(16, 16, 16, 16), (16, 7, 32, 5)])
def test_estimate_bit_identical_to_reference(counts):
    rng = np.random.default_rng(0)
    metas = [make_meta(rng, p) for p in counts]
    ref, got = re_.StateMatrix(), te.StateMatrix(torch.device("cpu"))
    for i, m in enumerate(metas):
        ref.register(i, m)
        got.register(i, port_meta(m))
    assert got.uniform == ref.uniform
    for _ in range(30):
        lo, hi = make_query(rng)
        assert np.array_equal(got.estimate(lo, hi), ref.estimate(lo, hi))
        assert got.estimate_costs([3, 0], lo, hi) == \
            ref.estimate_costs([3, 0], lo, hi)


def test_estimate_under_register_deregister_churn_and_slot_wipe():
    rng = np.random.default_rng(1)
    ref, got = re_.StateMatrix(), te.StateMatrix(torch.device("cpu"))
    live = set()
    for _ in range(160):
        if live and rng.random() < 0.4:
            sid = int(rng.choice(sorted(live)))
            live.discard(sid)
            ref.deregister(sid)
            got.deregister(sid)
            n = len(got)
            assert torch.isinf(got._mins[n]).all()            # wiped slot
            assert (got._mins[n] > 0).all() and (got._maxs[n] < 0).all()
            assert not got._rows[n].any() and got._totals_arr[n] == 1.0
        else:
            sid = int(rng.integers(0, 12))
            meta = make_meta(rng, int(rng.integers(3, 40)), n=500)
            live.add(sid)
            ref.register(sid, meta)
            got.register(sid, port_meta(meta))
        assert got.state_ids == ref.state_ids and got.version == ref.version
        lo, hi = make_query(rng)
        assert np.array_equal(got.estimate(lo, hi), ref.estimate(lo, hi))
    for sid in got.state_ids:
        m, r = got.metadata(sid), ref.metadata(sid)
        assert torch.equal(m.mins, t(r.mins)) and np.array_equal(
            m.rows_host, r.rows)
    got.deregister(999)                      # unknown id: no-op
    assert got.state_ids == ref.state_ids


def test_state_matrix_listeners_see_every_event():
    events = []

    class Mirror:
        def on_register(self, sid, meta):
            events.append(("reg", sid, meta.num_partitions))

        def on_deregister(self, sid):
            events.append(("dereg", sid))

    rng = np.random.default_rng(2)
    sm = te.StateMatrix(torch.device("cpu"))
    mirror = Mirror()
    sm._add_listener(mirror)
    sm.register(4, port_meta(make_meta(rng, 5)))
    sm.register(9, port_meta(make_meta(rng, 7)))
    sm.deregister(4)
    sm._remove_listener(mirror)
    sm.deregister(9)
    assert events == [("reg", 4, 5), ("reg", 9, 7), ("dereg", 4)]
    with pytest.raises(ValueError):
        te.StateMatrix(torch.device("meta"))


# ---------------------------------------------------------------------------
# Backend and engine traces
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


def make_policy(core, engine, data, stream, name):
    gen = core.make_generator("qdtree")
    mgr = core.LayoutManagerConfig(target_partitions=16)
    if name == "OREO":
        return engine.OreoPolicy(data, core.build_default_layout(0, data, 16),
                                 gen, core.OreoConfig(alpha=40.0, seed=3,
                                                      manager=mgr))
    if name == "Static":
        return engine.StaticPolicy(data, stream, gen, 40.0,
                                   target_partitions=16)
    cls = getattr(engine, f"{name}Policy")
    return cls(data, core.build_default_layout(0, data, 16), gen, 40.0,
               mgr_cfg=mgr)


@pytest.fixture(scope="module")
def reference_traces(bench):
    data, stream = bench
    return {name: re_.LayoutEngine(make_policy(rc, re_, data, stream, name),
                                   re_.InMemoryBackend(data)).run(stream)
            for name in ("OREO", "Static", "Greedy", "Regret")}


def same_trace(got, ref):
    assert np.array_equal(got.query_costs, ref.query_costs)
    assert got.reorg_indices == ref.reorg_indices
    assert np.array_equal(got.state_seq, ref.state_seq)
    assert got.total_cost == ref.total_cost


@pytest.mark.parametrize("name", ["OREO", "Static", "Greedy", "Regret"])
@pytest.mark.parametrize("mode", ["run", "run_stepwise", "step"])
def test_engine_traces_equal_reference(bench, reference_traces, name, mode):
    data, stream = bench
    tdata = t(data)
    engine = te.LayoutEngine(make_policy(tc, te, tdata, stream, name),
                             te.InMemoryBackend(tdata))
    if mode.startswith("run"):
        got = engine.run(stream, batch_serve=mode == "run")
    else:
        for k, q in enumerate(stream):
            step = engine.step(q)
            assert step.index == k and step.query is q
        got = engine.result()
    ref = reference_traces[name]
    same_trace(got, ref)
    assert got.info == ref.info
    if name in ("OREO", "Greedy"):
        assert got.num_reorgs > 0                     # the trace really moves


def test_delayed_swaps_match_reference(bench):
    data, stream = bench
    cfg = dict(alpha=40.0, seed=5, delta=25)
    ref = re_.LayoutEngine(
        re_.OreoPolicy(data, rc.build_default_layout(0, data, 16),
                       rc.make_generator("qdtree"), rc.OreoConfig(**cfg)),
        re_.InMemoryBackend(data), delta=25).run(stream)
    tdata = t(data)
    engine = te.LayoutEngine(
        te.OreoPolicy(tdata, tc.build_default_layout(0, tdata, 16),
                      tc.make_generator("qdtree"), tc.OreoConfig(**cfg)),
        te.InMemoryBackend(tdata), delta=25)
    for q in stream.queries[:700]:
        engine.step_fast(q)
    got = engine.run(stream.queries[700:])
    same_trace(got, ref)


def test_backend_serving_memo_priming_and_blocks(bench):
    data, stream = bench
    lay = rc.build_default_layout(0, data, 16, sort_col=1)
    ref = re_.InMemoryBackend(data)
    got = te.InMemoryBackend(t(data))
    assert isinstance(got, te.StorageBackend)
    tlay = tc.build_default_layout(0, t(data), 16, sort_col=1)
    ref.register(lay)
    got.register(tlay)
    ref.activate(0)
    got.activate(0)
    assert got.serving_state == 0 and got.pending_states == []
    for q in stream.queries[:50]:
        assert got.estimate_costs([0], q) == ref.estimate_costs([0], q)
        assert got._serve_memo[0] is q
        assert got.serve(q) == ref.serve(q)
        assert np.array_equal(got.estimate_vector(q), ref.estimate_vector(q))
    q = stream.queries[60]
    fake = np.array([0.25, 0.5])
    got.prime_estimates(q, got.state_matrix.version, fake)
    assert got.estimate_costs([0], q) == {0: 0.25}
    got.prime_estimates(q, got.state_matrix.version - 1, fake)   # stale
    assert got.estimate_costs([0], q) == ref.estimate_costs([0], q)
    lo, hi = rc.stack_queries(stream.queries)
    assert np.array_equal(got.serve_block(lo, hi), ref.serve_block(lo, hi))
    assert got.serve_block(lo[:0], hi[:0]).shape == (0,)
    with pytest.raises(TypeError):
        te.InMemoryBackend(data)


@pytest.mark.parametrize("kw", [{"governor": object(), "incremental": True},
                                {"rows_per_tick": 10},
                                {"ingest": te.IngestConfig()}])
def test_later_slices_raise_not_implemented(bench, kw):
    """The incremental plane and streaming ingest are ported, so every
    case checks the reference's own refusals: an incremental or ingesting
    engine refuses block serving (and an ingesting one still runs the
    stepwise loop, to ``repro``'s trace), and a row budget needs
    incremental mode."""
    data, stream = bench
    tdata = t(data)
    policy = make_policy(tc, te, tdata, stream, "Static")
    if "ingest" in kw:
        engine = te.LayoutEngine(policy, te.InMemoryBackend(tdata), **kw)
        with pytest.raises(ValueError, match="batch_serve"):
            engine.run(stream.queries[:5], batch_serve=True)
        got = engine.run(stream.queries[:40])
        ref = re_.LayoutEngine(make_policy(rc, re_, data, stream, "Static"),
                               re_.InMemoryBackend(data),
                               ingest=re_.IngestConfig()).run(
            stream.queries[:40])
        assert np.array_equal(got.query_costs, ref.query_costs)
        assert engine.ingest_stats() == {
            "ingested_rows": 0, "pending_batches": 0, "pending_rows": 0,
            "clustering_debt": 0.0, "total_excess": 0.0, "compactions": []}
    elif "rows_per_tick" in kw:
        with pytest.raises(ValueError, match="requires incremental"):
            te.LayoutEngine(policy, te.InMemoryBackend(tdata), **kw)
    else:
        engine = te.LayoutEngine(policy, te.InMemoryBackend(tdata), **kw)
        assert engine.incremental and engine.reorg_executor is not None
        with pytest.raises(ValueError, match="batch_serve"):
            engine.run(stream.queries[:5], batch_serve=True)


def test_cpu_run_launches_no_kernel(bench):
    data, stream = bench
    before = pruning.scan_matrix.launches
    tdata = t(data)
    te.LayoutEngine(make_policy(tc, te, tdata, stream, "Static"),
                    te.InMemoryBackend(tdata)).run(stream.queries[:50])
    assert pruning.scan_matrix.launches == before


# ---------------------------------------------------------------------------
# The port stands alone
# ---------------------------------------------------------------------------

def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py"]
    assert len(files) > 20
    for path in files:
        for mod in imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
