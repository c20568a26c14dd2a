"""The fleet kernels' edge inputs held against the JAX package, and the
build of their shared header.

``csrc/decision_fused.cu`` and ``csrc/fleet_scan.cu`` share one
shared-memory tile (``csrc/fleet_tile.cuh``).  Their contract is the
plain versions': float64 compares written ``min <= hi && max >= lo``, so a
NaN bound fails its compare, and +-inf and ties at the zone-map ends are
exact.  The same numpy inputs go through ``repro``'s oracle and Pallas
kernels (interpret mode; float32, so the inputs are float32-exact) and
its exact numpy fleet scan, and through the port's wrappers on CPU
tensors.  ``scan`` and ``freq`` are compared exactly, ``cost`` at rtol
1e-6 against float32 and 1e-12 against float64.  The CUDA kernels are
held to the same plain versions on a card (``test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.engine import compute as jcompute
from repro.kernels.decision_fused import decision_fused as jdf
from repro.kernels.decision_fused import ref as jdf_ref
from repro.kernels.fleet_scan import fleet_scan as jfs
from repro.kernels.fleet_scan import ref as jfs_ref
from repro_torch.kernels import _backend
from repro_torch.kernels.decision_fused import decision_fused
from repro_torch.kernels.fleet_scan import fleet_scan
from test_torch_cuda import plane_operands, with_nans


def tt(*arrays):
    return [None if a is None else torch.as_tensor(a) for a in arrays]


def edge_operands(seed, b, t, s, p, c, w):
    """Float32-exact operands with +-inf bounds, padding slots, dummy
    queries, ties at the zone-map ends and NaN in 5 % of every bound."""
    rng = np.random.default_rng(seed)
    ops = plane_operands(rng, b, t, s, p, c, f32_exact=True, window=w)
    lo, hi, mins, maxs, rows, inv, w_lo, w_hi = ops
    with_nans(rng, lo, hi, mins, maxs, w_lo, w_hi)
    inv = (1.0 / np.maximum(rows.sum(-1), 1.0)).astype(np.float32)
    return lo, hi, mins, maxs, rows, inv.astype(np.float64), w_lo, w_hi


def numpy_frames(lo, hi, mins, maxs):
    """(B, T, S, P) scan by the reference's direct numpy fleet scan."""
    (b, t, c), (_, s, p, _) = lo.shape, mins.shape
    flat_min, flat_max = mins.reshape(t, s * p, c), maxs.reshape(t, s * p, c)
    return np.stack([jcompute.fleet_scan_matrix(
        lo[k], hi[k], flat_min, flat_max, backend="numpy")
        for k in range(b)]).reshape(b, t, s, p)


@pytest.mark.parametrize("b,t,s,p,c,w", [(2, 3, 2, 8, 4, 4),
                                         (3, 5, 4, 33, 5, 7),
                                         (1, 9, 3, 6, 2, 3)])
def test_fused_decision_on_nan_and_inf_bounds_matches_jax(b, t, s, p, c, w):
    ops = edge_operands(b * 100 + p, b, t, s, p, c, w)
    assert np.isnan(ops[2]).any() and np.isnan(ops[3]).any()
    scan, cost, freq = decision_fused.fused_decision(*tt(*ops))
    j = [jnp.asarray(a, jnp.float32) for a in ops]
    for want in (jdf.fused_decision_pallas(*j, interpret=True),
                 jdf_ref.fused_decision(*j)):
        w_scan, w_cost, w_freq = (np.asarray(x) for x in want)
        assert np.array_equal(scan.numpy(), w_scan > 0.5)
        assert np.array_equal(freq.numpy().astype(np.float32), w_freq)
        np.testing.assert_allclose(cost.numpy(), w_cost, rtol=1e-6,
                                   atol=1e-7)
    lo, hi, mins, maxs, rows, inv, w_lo, w_hi = ops
    exact = numpy_frames(lo, hi, mins, maxs)
    assert np.array_equal(scan.numpy(), exact)
    np.testing.assert_allclose(
        cost.numpy(), np.einsum("btsp,tsp->bts", exact, rows) * inv[None],
        rtol=1e-12, atol=0)
    window = numpy_frames(np.broadcast_to(w_lo[:, None], (w, t, c)),
                          np.broadcast_to(w_hi[:, None], (w, t, c)),
                          mins, maxs)
    assert np.array_equal(freq.numpy(), window.sum(0) / w)


@pytest.mark.parametrize("t,s,p,c", [(4, 8, 8, 8), (17, 2, 65, 7),
                                     (3, 5, 1, 1)])
def test_scan_fleet_on_nan_and_inf_bounds_matches_jax(t, s, p, c):
    lo, hi, mins, maxs, *_ = edge_operands(t + p, 1, t, s, p, c, 0)
    lo, hi = lo[0], hi[0]
    mins, maxs = mins.reshape(t, s * p, c), maxs.reshape(t, s * p, c)
    got = fleet_scan.scan_fleet(*tt(lo, hi, mins, maxs)).numpy()
    j = [jnp.asarray(a, jnp.float32) for a in (lo, hi, mins, maxs)]
    assert np.array_equal(got, np.asarray(jfs_ref.scan_fleet(*j)) > 0.5)
    assert np.array_equal(
        got, np.asarray(jfs.scan_fleet_pallas(*j, interpret=True)) > 0.5)
    assert np.array_equal(got, jcompute.fleet_scan_matrix(
        lo, hi, mins, maxs, backend="numpy"))


def test_ties_at_the_zone_map_ends_overlap_and_nan_never_does():
    # One tenant, four slots of one column: [1, 2], [2, 3], NaN ends, and
    # the padding slot [+inf, -inf].
    mins = np.array([[[1.0], [2.0], [np.nan], [np.inf]]])
    maxs = np.array([[[2.0], [3.0], [5.0], [-np.inf]]])
    cases = {(2.0, 2.0): [1, 1, 0, 0],       # a point query on both ends
             (-np.inf, 1.0): [1, 0, 0, 0],   # hi equal to a min
             (3.0, np.inf): [0, 1, 0, 0],    # lo equal to a max
             (-np.inf, np.inf): [1, 1, 0, 1],  # padding too
             (np.nan, 9.0): [0, 0, 0, 0]}
    for (lo, hi), want in cases.items():
        q_lo, q_hi = np.array([[lo]]), np.array([[hi]])
        got = fleet_scan.scan_fleet(*tt(q_lo, q_hi, mins, maxs)).numpy()
        assert got.tolist() == [[bool(x) for x in want]], (lo, hi)
        scan, _, freq = decision_fused.fused_decision(
            *tt(q_lo[None], q_hi[None], mins[:, None], maxs[:, None]),
            w_lo=torch.as_tensor(q_lo), w_hi=torch.as_tensor(q_hi))
        assert np.array_equal(scan.numpy().reshape(1, 4), got)
        assert np.array_equal(freq.numpy().reshape(1, 4), got.astype(float))
        assert np.array_equal(got, jcompute.fleet_scan_matrix(
            q_lo, q_hi, mins, maxs, backend="numpy"))


def test_nan_zone_maps_where_the_reference_masked_paths_differ():
    """``repro``'s masked overlap skips a column that every query leaves
    unbounded, so a NaN zone-map end there counts as overlapping, while
    its direct fleet scan, its kernels and the port's kernels compare it
    and find no overlap."""
    mins = np.array([[[np.nan, 0.0], [1.0, 1.0]]])       # (T, N, C)
    maxs = np.array([[[5.0, 3.0], [2.0, np.nan]]])
    lo, hi = np.array([[-np.inf, 0.0]]), np.array([[np.inf, 4.0]])
    got = fleet_scan.scan_fleet(*tt(lo, hi, mins, maxs)).numpy()
    assert got.tolist() == [[False, False]]
    assert np.array_equal(got, jcompute.fleet_scan_matrix(
        lo, hi, mins, maxs, backend="numpy"))
    j = [jnp.asarray(a, jnp.float32) for a in (lo, hi, mins, maxs)]
    assert np.array_equal(got, np.asarray(jfs_ref.scan_fleet(*j)) > 0.5)
    twin_min = np.ascontiguousarray(np.moveaxis(mins, -1, 0))
    twin_max = np.ascontiguousarray(np.moveaxis(maxs, -1, 0))
    masked = jcompute.masked_overlap(twin_min, twin_max, lo[0], hi[0])
    assert masked.tolist() == [[True, False]]


def test_fused_decision_with_no_slots_gives_zero_costs_times_inv():
    rng = np.random.default_rng(4)
    ops = tt(*plane_operands(rng, 3, 4, 2, 0, 3, window=2))
    ops[5][1, 0] = float("inf")
    scan, cost, freq = decision_fused.fused_decision(*ops)
    assert scan.shape == (3, 4, 2, 0) and freq.shape == (4, 2, 0)
    want = torch.zeros((3, 4, 2), dtype=torch.float64) * ops[5][None]
    assert torch.equal(cost.isnan(), want.isnan())
    assert torch.equal(cost.nan_to_num(), want.nan_to_num())


def write(path, text):
    path.write_text(text)
    return path


def test_build_dir_changes_with_a_shared_header(tmp_path, monkeypatch):
    monkeypatch.setattr(_backend, "CSRC", tmp_path)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    write(tmp_path / "a.cu", '#include "tile.cuh"\n')
    header = write(tmp_path / "tile.cuh", "// v1\n")
    first = _backend.build_dir()
    assert first == _backend.build_dir()         # stable while unchanged
    write(header, "// v2\n")
    second = _backend.build_dir()
    assert second != first
    write(header, "// v1\n")
    assert _backend.build_dir() == first         # keyed by content
    write(tmp_path / "b.cuh", "// another header\n")
    assert _backend.build_dir() != first


def test_sources_lists_only_the_compiled_cu_files(tmp_path, monkeypatch):
    monkeypatch.setattr(_backend, "CSRC", tmp_path)
    for name in ("b.cu", "a.cu", "tile.cuh", "notes.txt"):
        write(tmp_path / name, "")
    assert [p.name for p in _backend.sources()] == ["a.cu", "b.cu"]


def test_the_repo_headers_are_in_the_build_key():
    headers = sorted(_backend.CSRC.glob("*.cuh"))
    assert [p.name for p in headers] == ["fleet_tile.cuh"]
    for src in ("decision_fused.cu", "fleet_scan.cu"):
        text = (_backend.CSRC / src).read_text()
        assert '#include "fleet_tile.cuh"' in text
    assert all(p.suffix == ".cu" for p in _backend.sources())


@pytest.mark.parametrize("path", [0, 1, 2])
def test_cpu_wrappers_take_every_path_and_refuse_others(path):
    rng = np.random.default_rng(21)
    ops = tt(*plane_operands(rng, 3, 4, 2, 9, 3, window=4))
    want = decision_fused.fused_decision(*ops)
    got = decision_fused.fused_decision(*ops, path=path)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    flat = ops[2].reshape(4, 18, 3), ops[3].reshape(4, 18, 3)
    assert torch.equal(fleet_scan.scan_fleet(ops[0][0], ops[1][0], *flat,
                                             path=path),
                       fleet_scan.scan_fleet(ops[0][0], ops[1][0], *flat))
    with pytest.raises(ValueError, match="path"):
        decision_fused.fused_decision(*ops, path=path + 3)
    with pytest.raises(ValueError, match="path"):
        fleet_scan.scan_fleet(ops[0][0], ops[1][0], *flat, path=-1 - path)
