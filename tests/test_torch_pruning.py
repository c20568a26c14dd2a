"""The port's pruning scan held against the JAX package's.

The same numpy inputs go through ``repro``'s oracle, its Pallas kernel (in
interpret mode) and its exact numpy path, and through ``repro_torch``'s
plain version and compute entry points on the CPU.  Comparisons are exact:
the scan is a conjunction of comparisons, with nothing to round.  The CUDA
kernel itself is tested on a card, in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.engine import compute as jcompute
from repro.kernels.pruning import pruning as jpruning
from repro.kernels.pruning import ref as jref
from repro_torch.engine import compute
from repro_torch.kernels.pruning import ops, pruning, ref
from test_torch_cuda import operands


def plain(lo, hi, mins, maxs):
    t = [torch.as_tensor(a) for a in (lo, hi, mins, maxs)]
    return pruning.scan_matrix(*t).numpy()


@pytest.mark.parametrize("q,p,c", [(1, 32, 8), (17, 45, 6), (64, 130, 12),
                                   (3, 1, 1)])
def test_plain_matches_jax_oracle_and_pallas_interpret(q, p, c):
    rng = np.random.default_rng(q * 1000 + p)
    lo, hi, mins, maxs = operands(rng, q, p, c, f32_exact=True)
    got = plain(lo, hi, mins, maxs)
    j = [jnp.asarray(a, jnp.float32) for a in (lo, hi, mins, maxs)]
    oracle = np.asarray(jref.scan_matrix(*j))
    kernel = np.asarray(jpruning.scan_matrix_pallas(*j, interpret=True))
    assert got.dtype == np.bool_ and got.shape == (q, p)
    assert np.array_equal(got, oracle > 0.5)
    assert np.array_equal(got, kernel > 0.5)


@pytest.mark.parametrize("q,p,c", [(1, 288, 32), (1000, 37, 5), (7, 3, 0),
                                   (0, 5, 4), (5, 0, 4)])
def test_plain_matches_exact_numpy_path_in_float64(q, p, c):
    rng = np.random.default_rng(q + 7 * p + c)
    lo, hi, mins, maxs = operands(rng, q, p, c)
    want = jcompute.scan_matrix(lo, hi, mins, maxs, backend="numpy")
    assert np.array_equal(plain(lo, hi, mins, maxs), want)
    got = compute.scan_matrix(lo, hi, torch.as_tensor(mins),
                              torch.as_tensor(maxs))
    assert isinstance(got, np.ndarray)
    assert np.array_equal(got, want)


def test_zero_columns_scan_everything():
    got = plain(np.zeros((4, 0)), np.zeros((4, 0)), np.zeros((6, 0)),
                np.zeros((6, 0)))
    assert got.shape == (4, 6) and got.all()


def test_masked_overlap_over_a_packed_plane_matches_reference():
    rng = np.random.default_rng(3)
    s, p, c = 5, 24, 7
    mins = rng.uniform(0, 1, (s, p, c))
    maxs = mins + rng.uniform(0, 0.3, (s, p, c))
    mins[2, 20:], maxs[2, 20:] = np.inf, -np.inf          # padded state
    for _ in range(20):
        lo, hi, _, _ = operands(rng, 1, 1, c)
        want = jcompute.masked_overlap(
            np.ascontiguousarray(mins.transpose(2, 0, 1)),
            np.ascontiguousarray(maxs.transpose(2, 0, 1)), lo[0], hi[0])
        got = compute.masked_overlap(torch.as_tensor(mins),
                                     torch.as_tensor(maxs), lo[0], hi[0])
        assert got.shape == (s, p)
        assert np.array_equal(got, want)


def test_row_strided_partition_view_is_read_in_place():
    rng = np.random.default_rng(4)
    lo, hi, mins, maxs = operands(rng, 9, 30, 6)
    wide_min = torch.zeros((30, 9), dtype=torch.float64)
    wide_max = torch.zeros((30, 9), dtype=torch.float64)
    wide_min[:, :6], wide_max[:, :6] = torch.as_tensor(mins), \
        torch.as_tensor(maxs)
    view_min, view_max = wide_min[:, :6], wide_max[:, :6]
    assert pruning._row_stride("p_min", view_min) == 9
    got = pruning.scan_matrix(torch.as_tensor(lo), torch.as_tensor(hi),
                              view_min, view_max)
    assert np.array_equal(got.numpy(), plain(lo, hi, mins, maxs))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(5)
    before = pruning.scan_matrix.launches
    lo, hi, mins, maxs = operands(rng, 4, 10, 3)
    got = plain(lo, hi, mins, maxs)
    want = ref.scan_matrix(*[torch.as_tensor(a)
                             for a in (lo, hi, mins, maxs)]).numpy()
    assert np.array_equal(got, want)
    assert pruning.scan_matrix.launches == before


@pytest.mark.parametrize("bad", ["float32", "rank", "columns", "lohi",
                                 "not_tensor", "devices"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    t = {k: torch.zeros(shape, dtype=torch.float64) for k, shape in
         (("q_lo", (3, 4)), ("q_hi", (3, 4)), ("p_min", (5, 4)),
          ("p_max", (5, 4)))}
    if bad == "float32":
        t["q_hi"] = t["q_hi"].float()
    elif bad == "rank":
        t["p_min"] = t["p_min"][None]
    elif bad == "columns":
        t["p_min"] = t["p_max"] = torch.zeros((5, 3), dtype=torch.float64)
    elif bad == "lohi":
        t["q_hi"] = torch.zeros((2, 4), dtype=torch.float64)
    elif bad == "not_tensor":
        t["p_max"] = np.zeros((5, 4))
    elif bad == "devices":
        t["p_max"] = t["p_max"].to("meta")
    with pytest.raises((TypeError, ValueError)):
        pruning.scan_matrix(t["q_lo"], t["q_hi"], t["p_min"], t["p_max"])


def test_ops_scan_fractions_and_cost_vectors_match_numpy():
    rng = np.random.default_rng(6)
    lo, hi, mins, maxs = operands(rng, 12, 20, 5)
    rows = rng.integers(0, 500, 20).astype(np.float64)   # sums stay exact
    scanned = jcompute.scan_matrix(lo, hi, mins, maxs, backend="numpy")
    want = (scanned.astype(np.float64) @ rows) / max(rows.sum(), 1.0)
    t = [torch.as_tensor(a) for a in (lo, hi, mins, maxs)]
    assert ops.scan_matrix is pruning.scan_matrix
    got = ops.scan_fractions(*t, torch.as_tensor(rows))
    assert isinstance(got, np.ndarray) and np.array_equal(got, want)
    assert np.array_equal(ops.scan_fractions(*t, rows), want)
    cv = ops.cost_vectors(t[0], t[1], [(t[2], t[3], torch.as_tensor(rows)),
                                       (t[2][:7], t[3][:7], rows[:7])])
    assert cv.shape == (2, 12) and np.array_equal(cv[0], want)
    want_7 = (scanned[:, :7].astype(np.float64) @ rows[:7]) / max(
        rows[:7].sum(), 1.0)
    assert np.array_equal(cv[1], want_7)
