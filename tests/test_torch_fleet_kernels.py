"""The port's fleet kernels held against the JAX package's.

The same numpy inputs go through ``repro``'s Pallas kernels (in interpret
mode) and its exact numpy paths, and through ``repro_torch``'s plain
versions and compute entry points on the CPU.  ``scan`` and ``freq`` are
compared exactly; ``cost`` is a sum, which the JAX kernel takes in float32
(rtol 1e-6 there) and the port in float64 in another order than numpy
(rel 1e-12).  The CUDA kernels themselves are tested on a card, in
``test_torch_cuda.py``.
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
from repro_torch.engine import compute
from repro_torch.kernels.decision_fused import decision_fused, ops as df_ops
from repro_torch.kernels.fleet_scan import fleet_scan, ops as fs_ops
from test_torch_cuda import plane_operands


def tt(*arrays):
    return [None if a is None else torch.as_tensor(a) for a in arrays]


def transposed(mins, maxs):
    """The reference's (C, T, S, P) twin of a (T, S, P, C) plane."""
    return (np.ascontiguousarray(np.moveaxis(mins, -1, 0)),
            np.ascontiguousarray(np.moveaxis(maxs, -1, 0)))


def reference_frames(lo, hi, mins, maxs):
    """(B, T, S, P) scan of the reference's exact numpy paths: its fleet
    scan per frame and, where it takes the shape (C > 0), its masked
    overlap over the transposed twin, which must agree."""
    (b, t, c), (_, s, p, _) = lo.shape, mins.shape
    want = np.stack([jcompute.fleet_scan_matrix(
        lo[k], hi[k], mins.reshape(t, s * p, c), maxs.reshape(t, s * p, c),
        backend="numpy") for k in range(b)]).reshape(b, t, s, p)
    if c:
        twin = jcompute.fleet_masked_overlap(*transposed(mins, maxs), lo, hi)
        assert np.array_equal(twin, want)
    return want


# ---------------------------------------------------------------------------
# fleet_scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,s,p,c", [(1, 1, 8, 4), (4, 8, 8, 8),
                                     (17, 2, 65, 7), (3, 5, 1, 1)])
def test_fleet_scan_plain_matches_jax_oracle_and_pallas_interpret(t, s, p, c):
    rng = np.random.default_rng(t * 1000 + s * p)
    lo, hi, mins, maxs, *_ = plane_operands(rng, 1, t, s, p, c,
                                            f32_exact=True)
    lo, hi = lo[0], hi[0]
    mins, maxs = mins.reshape(t, s * p, c), maxs.reshape(t, s * p, c)
    got = fleet_scan.scan_fleet(*tt(lo, hi, mins, maxs)).numpy()
    j = [jnp.asarray(a, jnp.float32) for a in (lo, hi, mins, maxs)]
    assert got.dtype == np.bool_ and got.shape == (t, s * p)
    assert np.array_equal(got, np.asarray(jfs_ref.scan_fleet(*j)) > 0.5)
    kernel = jfs.scan_fleet_pallas(*j, interpret=True)
    assert np.array_equal(got, np.asarray(kernel) > 0.5)


@pytest.mark.parametrize("b,t,s,p,c", [(1, 3, 4, 16, 6), (5, 8, 3, 9, 5),
                                       (2, 1, 1, 3, 0), (3, 6, 2, 7, 1)])
def test_fleet_scan_matrix_matches_exact_numpy_paths_in_float64(b, t, s, p,
                                                                c):
    rng = np.random.default_rng(b + 10 * t + 100 * p + c)
    lo, hi, mins, maxs, *_ = plane_operands(rng, b, t, s, p, c)
    mins3, maxs3 = mins.reshape(t, s * p, c), maxs.reshape(t, s * p, c)
    want = reference_frames(lo, hi, mins, maxs)
    got = compute.fleet_scan_matrix(lo, hi, *tt(mins3, maxs3))
    assert isinstance(got, np.ndarray) and got.shape == (b, t, s * p)
    assert np.array_equal(got.reshape(b, t, s, p), want)
    for k in range(b):
        single = compute.fleet_scan_matrix(lo[k], hi[k], *tt(mins3, maxs3))
        assert np.array_equal(single, jcompute.fleet_scan_matrix(
            lo[k], hi[k], mins3, maxs3, backend="numpy"))
        assert np.array_equal(single, got[k])


def test_fleet_scan_reads_a_strided_plane_view_in_place():
    rng = np.random.default_rng(3)
    lo, hi, mins, maxs, *_ = plane_operands(rng, 1, 8, 3, 10, 5)
    mins3, maxs3 = mins.reshape(8, 30, 5), maxs.reshape(8, 30, 5)
    # Every other tenant of a plane two columns wider: tenant, slot and
    # column strides (60 * 7, 7, 1), read without a copy.
    wmin = torch.zeros((8, 30, 7), dtype=torch.float64)
    wmax = torch.zeros((8, 30, 7), dtype=torch.float64)
    wmin[:, :, :5], wmax[:, :, :5] = tt(mins3, maxs3)
    vmin, vmax = wmin[::2, :, :5], wmax[::2, :, :5]
    assert vmin.stride() == (420, 7, 1)
    got = fleet_scan.scan_fleet(*tt(lo[0, ::2], hi[0, ::2]), vmin, vmax)
    want = jcompute.fleet_scan_matrix(lo[0, ::2], hi[0, ::2], mins3[::2],
                                      maxs3[::2], backend="numpy")
    assert np.array_equal(got.numpy(), want)


def test_fleet_scan_fractions_match_numpy():
    rng = np.random.default_rng(13)
    lo, hi, mins, maxs, *_ = plane_operands(rng, 1, 3, 4, 4, 4)
    mins3, maxs3 = mins.reshape(3, 16, 4), maxs.reshape(3, 16, 4)
    rows = rng.integers(0, 100, (3, 16)).astype(np.float64)
    scan = jcompute.fleet_scan_matrix(lo[0], hi[0], mins3, maxs3)
    want = (scan * rows).sum(1) / np.maximum(rows.sum(1), 1.0)
    assert fs_ops.scan_fleet is fleet_scan.scan_fleet
    got = fs_ops.fleet_scan_fractions(*tt(lo[0], hi[0], mins3, maxs3), rows)
    assert isinstance(got, np.ndarray) and np.array_equal(got, want)


# ---------------------------------------------------------------------------
# decision_fused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,t,s,p,c,w", [(1, 1, 1, 1, 1, 1),
                                         (2, 3, 2, 8, 4, 4),
                                         (3, 5, 4, 33, 5, 7)])
def test_fused_decision_plain_matches_jax_pallas_interpret(b, t, s, p, c, w):
    rng = np.random.default_rng(b * 1000 + t * 100 + p)
    ops = plane_operands(rng, b, t, s, p, c, f32_exact=True, window=w)
    rows = ops[4]
    inv = (1.0 / np.maximum(rows.sum(-1), 1.0)).astype(np.float32)
    ops = (*ops[:5], inv.astype(np.float64), *ops[6:])
    scan, cost, freq = decision_fused.fused_decision(*tt(*ops))
    j = [jnp.asarray(a, jnp.float32) for a in ops]
    for want in (jdf.fused_decision_pallas(*j, interpret=True),
                 jdf_ref.fused_decision(*j)):
        w_scan, w_cost, w_freq = (np.asarray(x) for x in want)
        assert np.array_equal(scan.numpy(), w_scan > 0.5)
        assert np.array_equal(freq.numpy().astype(np.float32), w_freq)
        np.testing.assert_allclose(cost.numpy(), w_cost, rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("b,t,s,p,c,w", [(4, 3, 5, 16, 6, 9),
                                         (1, 7, 2, 40, 3, 1),
                                         (3, 2, 3, 5, 0, 4),
                                         (2, 4, 1, 0, 3, 2)])
def test_fused_decision_matches_exact_numpy_in_float64(b, t, s, p, c, w):
    rng = np.random.default_rng(7 * b + t + 31 * p + c)
    lo, hi, mins, maxs, rows, inv, w_lo, w_hi = plane_operands(
        rng, b, t, s, p, c, window=w)
    scan, cost, freq = decision_fused.fused_decision(
        *tt(lo, hi, mins, maxs, rows, inv, w_lo, w_hi))
    mT, xT = transposed(mins, maxs)
    want = reference_frames(lo, hi, mins, maxs)
    assert scan.dtype == torch.bool and np.array_equal(scan.numpy(), want)
    want_cost = np.einsum("btsp,tsp->bts", want, rows) * inv[None]
    np.testing.assert_allclose(cost.numpy(), want_cost, rtol=1e-12, atol=0)
    count = sum(jcompute.masked_overlap(mT, xT, w_lo[k], w_hi[k])
                for k in range(w))
    assert np.array_equal(freq.numpy(), count / w)
    frames = compute.fused_frames_scan(lo, hi, *tt(mins, maxs))
    assert frames.dtype == np.bool_ and frames.flags.c_contiguous
    assert frames.shape == (b, t, s, p) and np.array_equal(frames, want)


def test_fused_decision_partial_outputs_and_nothing_to_emit():
    rng = np.random.default_rng(55)
    ops = tt(*plane_operands(rng, 2, 4, 2, 20, 4, window=6))
    full = decision_fused.fused_decision(*ops)
    scan_only = decision_fused.fused_decision(*ops[:4])
    assert scan_only[1] is None and scan_only[2] is None
    assert torch.equal(scan_only[0], full[0])
    cost_only = decision_fused.fused_decision(*ops[:6], emit_scan=False)
    assert cost_only[0] is None and cost_only[2] is None
    assert torch.equal(cost_only[1], full[1])
    freq_only = decision_fused.fused_decision(*ops[:4], w_lo=ops[6],
                                              w_hi=ops[7], emit_scan=False)
    assert freq_only[0] is None and freq_only[1] is None
    assert torch.equal(freq_only[2], full[2])
    assert df_ops.fused_decision is decision_fused.fused_decision
    with pytest.raises(ValueError, match="nothing to emit"):
        decision_fused.fused_decision(*ops[:4], emit_scan=False)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    rng = np.random.default_rng(5)
    ops = tt(*plane_operands(rng, 2, 3, 2, 6, 3, window=2))
    before = (fleet_scan.scan_fleet.launches,
              decision_fused.fused_decision.launches)
    fleet_scan.scan_fleet(ops[0][0], ops[1][0], ops[2].reshape(3, 12, 3),
                          ops[3].reshape(3, 12, 3))
    decision_fused.fused_decision(*ops)
    assert (fleet_scan.scan_fleet.launches,
            decision_fused.fused_decision.launches) == before


BAD = ["float32", "rank", "tenants", "columns", "lohi", "not_tensor",
       "devices"]


def bad_operands(bad, q_shape, p_shape):
    z = {k: torch.zeros(shape, dtype=torch.float64) for k, shape in
         (("q_lo", q_shape), ("q_hi", q_shape), ("p_min", p_shape),
          ("p_max", p_shape))}
    wrong_t = (p_shape[0] + 1,) + p_shape[1:]
    wrong_c = p_shape[:-1] + (p_shape[-1] - 1,)
    if bad == "float32":
        z["q_hi"] = z["q_hi"].float()
    elif bad == "rank":
        z["p_min"] = z["p_min"][None]
    elif bad == "tenants":
        z["p_min"] = z["p_max"] = torch.zeros(wrong_t, dtype=torch.float64)
    elif bad == "columns":
        z["p_min"] = z["p_max"] = torch.zeros(wrong_c, dtype=torch.float64)
    elif bad == "lohi":
        z["q_hi"] = z["q_hi"][..., :-1]
    elif bad == "not_tensor":
        z["p_max"] = np.zeros(p_shape)
    elif bad == "devices":
        z["p_max"] = z["p_max"].to("meta")
    return z["q_lo"], z["q_hi"], z["p_min"], z["p_max"]


@pytest.mark.parametrize("bad", BAD)
def test_fleet_scan_rejects_what_the_kernel_does_not_take(bad):
    with pytest.raises((TypeError, ValueError)):
        fleet_scan.scan_fleet(*bad_operands(bad, (3, 4), (3, 10, 4)))


@pytest.mark.parametrize("bad", BAD + ["rows", "window"])
def test_fused_decision_rejects_what_the_kernel_does_not_take(bad):
    ops = bad_operands(bad if bad in BAD else None, (2, 3, 4), (3, 2, 5, 4))
    rows = torch.zeros((3, 2, 4 if bad == "rows" else 5),
                       dtype=torch.float64)
    inv = torch.zeros((3, 2), dtype=torch.float64)
    w = torch.zeros((2, 3 if bad == "window" else 4), dtype=torch.float64)
    with pytest.raises((TypeError, ValueError)):
        decision_fused.fused_decision(*ops, rows, inv, w, w)
