"""The port's ``compute="reference"`` backends held against the JAX
package's, on the CPU.

``InMemoryBackend(data, compute="reference")`` and ``DiskBackend(...,
compute="reference")`` keep no StateMatrix plane: estimates re-pad the
states' zone maps per query (``layouts.eval_cost_states``) and serving
scans the serving layout's metadata.  Their estimates, serve costs and
whole engine traces must equal the default mode's and ``repro``'s
reference mode's bit for bit, and the paths that need the plane
(incremental reorganization and ingest on the in-memory backend, the
fleet's batched path) must refuse it with "reference" in the message.
"""
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
from repro_torch.kernels.pruning import pruning

PKGS = {"ref": (rc, re_, rlm), "port": (tc, te, tlm)}


def t(a):
    return torch.as_tensor(a)


def table(pkg, data):
    return t(data) if pkg == "port" else data


@pytest.fixture(scope="module")
def bench():
    rng = np.random.default_rng(0)
    data = rng.uniform(0, 100, size=(8_000, 6))
    templates = rc.make_templates(4, 6, rng)
    stream = rc.generate_workload(templates, data.min(0), data.max(0),
                                  total_queries=600, seed=1,
                                  segment_length=(150, 250))
    return data, stream


def make_meta(rng, p, c=6, n=2000):
    data = rng.uniform(0, 1, (n, c))
    order = np.argsort(data[:, int(rng.integers(c))], kind="stable")
    assignment = np.empty(n, dtype=np.int64)
    assignment[order] = np.arange(n) * p // n
    return rl.metadata_from_assignment(data, assignment, p)


def make_query(rng, c=6):
    lo = np.full(c, -np.inf)
    hi = np.full(c, np.inf)
    for col in rng.choice(c, size=int(rng.integers(0, c + 1)),
                          replace=False):
        lo[col] = rng.uniform(0, 0.7)
        hi[col] = lo[col] + rng.uniform(0, 0.4)
    return lo, hi


def oreo_policy(pkg, data, alpha=40.0, seed=3):
    core, eng, lm = PKGS[pkg]
    return eng.OreoPolicy(data, core.build_default_layout(0, data, 16),
                          core.make_generator("qdtree"),
                          core.OreoConfig(alpha=alpha, seed=seed, delta=5,
                                          manager=lm.LayoutManagerConfig(
                                              target_partitions=16)))


def static_policy(pkg, data, stream):
    core, eng, _ = PKGS[pkg]
    return eng.StaticPolicy(data, stream, core.make_generator("qdtree"),
                            40.0, target_partitions=16)


def same_trace(got, ref):
    assert np.array_equal(got.query_costs, ref.query_costs)
    assert got.reorg_indices == ref.reorg_indices
    assert np.array_equal(got.state_seq, ref.state_seq)
    assert got.total_cost == ref.total_cost


# ---------------------------------------------------------------------------
# Backends: estimates and serving (tests/test_engine.py,
# tests/test_state_matrix.py)
# ---------------------------------------------------------------------------

def test_estimate_costs_modes_bit_identical(bench):
    """Plane estimates == the reference re-padding path == per-state
    eval_cost == repro's reference mode, for layouts with differing
    partition counts."""
    data, stream = bench
    tdata = t(data)
    lays = {"ref": [], "port": []}
    for pkg, d in (("ref", data), ("port", tdata)):
        core = PKGS[pkg][0]
        gen = core.make_generator("qdtree")
        lays[pkg] = [core.build_default_layout(0, d, 16),
                     gen(1, d, stream.queries[:100], 16),
                     gen(2, d, stream.queries[200:300], 7)]
    mem = te.InMemoryBackend(tdata)
    ref = te.InMemoryBackend(tdata, compute="reference")
    want = re_.InMemoryBackend(data, compute="reference")
    assert ref.state_matrix is None and mem.state_matrix is not None
    for lay in lays["port"]:
        mem.register(lay)
        ref.register(lay)
    for lay in lays["ref"]:
        want.register(lay)
    before = pruning.scan_matrix.launches
    for q in stream.queries[:50]:
        got = mem.estimate_costs([0, 1, 2], q)
        assert got == ref.estimate_costs([0, 1, 2], q)
        assert got == want.estimate_costs([0, 1, 2], q)
        for lay in lays["port"]:
            assert got[lay.layout_id] == float(
                tc.layouts.eval_cost(lay.meta, q.lo, q.hi))
    assert pruning.scan_matrix.launches == before       # CPU: no launch


def test_backend_registry_mirrors_matrix():
    """register / deregister keep the dict and the plane in sync, and
    plane estimates equal the reference mode's bit for bit."""
    rng = np.random.default_rng(4)
    data = t(rng.uniform(0, 1, (2000, 6)))
    mem = te.InMemoryBackend(data)
    ref = te.InMemoryBackend(data, compute="reference")
    lays = [tc.layouts.Layout(
        layout_id=i, name=f"l{i}", technique="synthetic",
        meta=tc.layouts.PartitionMetadata(
            mins=t(m.mins), maxs=t(m.maxs), rows=t(m.rows)))
        for i, m in enumerate(make_meta(rng, p) for p in (8, 8, 20))]
    for b in (mem, ref):
        for lay in lays:
            b.register(lay)
    for _ in range(20):
        lo, hi = make_query(rng)
        q = tc.workload.Query(lo=lo, hi=hi)
        assert mem.estimate_costs([0, 1, 2], q) == ref.estimate_costs(
            [0, 1, 2], q)
    for b in (mem, ref):
        b.deregister(1)
        assert b.states == [0, 2]
    assert sorted(mem.state_matrix.state_ids) == [0, 2]
    assert ref.estimate_costs([2, 0], q) == mem.estimate_costs([2, 0], q)


def test_reference_serving_equals_plane_and_repro(bench):
    """serve and serve_block read the serving layout's own metadata and
    equal the plane's memoized serve and repro's reference mode."""
    data, stream = bench
    tdata = t(data)
    got = {mode: te.InMemoryBackend(tdata, compute=mode)
           for mode in ("state_matrix", "reference")}
    want = re_.InMemoryBackend(data, compute="reference")
    tlay = tc.build_default_layout(0, tdata, 16, sort_col=1)
    for b in got.values():
        b.register(tlay)
        b.activate(0)
    want.register(rc.build_default_layout(0, data, 16, sort_col=1))
    want.activate(0)
    ref = got["reference"]
    assert ref._serve_primable is False and got["state_matrix"]._serve_primable
    for q in stream.queries[:40]:
        assert ref.serve(q) == want.serve(q) == got["state_matrix"].serve(q)
    lo, hi = rc.stack_queries(stream.queries)
    block = ref.serve_block(lo, hi)
    assert np.array_equal(block, want.serve_block(lo, hi))
    assert np.array_equal(block, got["state_matrix"].serve_block(lo, hi))
    assert ref.open_lookahead(stream.queries, lo, hi) is None
    with pytest.raises(AttributeError):
        ref.estimate_vector(stream.queries[0])
    with pytest.raises(ValueError, match="compute mode"):
        te.InMemoryBackend(tdata, compute="numpy")


@pytest.mark.parametrize("name", ["OREO", "Static"])
@pytest.mark.parametrize("mode", ["run", "step"])
def test_engine_traces_equal_default_mode_and_repro(bench, name, mode):
    """Whole engines in reference mode: the trace equals the default
    mode's and repro's reference mode's, through run and step."""
    data, stream = bench
    tdata = t(data)

    def policy(pkg, d):
        return (oreo_policy(pkg, d) if name == "OREO"
                else static_policy(pkg, d, stream))

    want = re_.LayoutEngine(policy("ref", data), re_.InMemoryBackend(
        data, compute="reference"), delta=5).run(stream)
    traces = {}
    for compute in ("state_matrix", "reference"):
        engine = te.LayoutEngine(policy("port", tdata), te.InMemoryBackend(
            tdata, compute=compute), delta=5)
        if mode == "run":
            traces[compute] = engine.run(stream)
        else:
            for q in stream:
                engine.step(q)
            traces[compute] = engine.result()
        same_trace(traces[compute], want)
    assert traces["reference"].info == want.info
    if name == "OREO":
        assert want.num_reorgs > 0


def test_disk_backend_reference_mode(bench, tmp_path):
    """DiskBackend(compute="reference") estimates by re-padding and serves
    from its store: an OREO engine's trace equals the plane mode's, the
    in-memory reference backend's and repro's, atomic and incremental
    (repro's DiskBackend takes incremental reorganization in this mode,
    and so does the port's)."""
    data, stream = bench
    tdata = t(data)
    queries = stream.queries[:300]

    def run(pkg, backend, **kw):
        d = tdata if pkg == "port" else data
        eng = PKGS[pkg][1]
        return eng.LayoutEngine(oreo_policy(pkg, d, alpha=10.0), backend,
                                delta=5, **kw).run(queries)

    want = run("ref", re_.InMemoryBackend(data, compute="reference"))
    assert want.num_reorgs > 0
    for compute in ("state_matrix", "reference"):
        disk = te.DiskBackend(tdata, str(tmp_path / f"a-{compute}"),
                              compress=False, background=False,
                              compute=compute)
        same_trace(run("port", disk), want)
        disk.close()
    incr = {}
    for pkg, eng, d in (("ref", re_, data), ("port", te, tdata)):
        disk = eng.DiskBackend(d, str(tmp_path / f"i-{pkg}"),
                               compress=False, background=False,
                               compute="reference")
        assert disk.supports_incremental
        incr[pkg] = run(pkg, disk, incremental=True, rows_per_tick=2_000)
        disk.close()
    same_trace(incr["port"], incr["ref"])
    assert incr["port"].num_reorgs > 0


# ---------------------------------------------------------------------------
# Refusals (tests/test_fleet_matrix.py, tests/test_reorg.py,
# tests/test_ingest.py)
# ---------------------------------------------------------------------------

def test_run_batched_requires_matrix_backed_backends(bench):
    data, _ = bench
    tdata = t(data)
    engine = te.LayoutEngine(oreo_policy("port", tdata),
                             te.InMemoryBackend(tdata, compute="reference"))
    fleet = te.FleetEngine({"t0": engine})
    with pytest.raises(ValueError, match="reference"):
        fleet.run_batched([])
    with pytest.raises(ValueError, match="reference"):
        fleet.drain(batched=True)


def test_incremental_rejects_reference_backend(bench):
    data, _ = bench
    tdata = t(data)
    backend = te.InMemoryBackend(tdata, compute="reference")
    assert not backend.supports_incremental
    with pytest.raises(ValueError, match="reference"):
        te.LayoutEngine(oreo_policy("port", tdata), backend,
                        incremental=True)


def test_engine_requires_ingest_capable_backend():
    rng = np.random.default_rng(4)
    data = t(rng.uniform(0, 100, size=(300, 3)))
    lay = tc.build_default_layout(0, data, 4)
    policy = te.ThresholdSwitchPolicy([lay], alpha=5.0, threshold=1e9)
    with pytest.raises(ValueError, match="reference"):
        te.LayoutEngine(policy, te.InMemoryBackend(data, compute="reference"),
                        ingest=te.IngestConfig())
