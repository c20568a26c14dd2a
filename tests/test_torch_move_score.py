"""The port's move-score kernel and the planner's scan frequencies, held
against the JAX package's.

The same numpy inputs go through ``repro``'s Pallas kernel (in interpret
mode) and its jnp oracle, which are float32, and through ``repro_torch``'s
plain version on the CPU.  On float32-exact data the port must agree with
them within rtol 1e-6 / atol 1e-7 (the reference averages a float32 0/1
tile).  Against the reference's exact ``compute="numpy"`` planner lane the
port's frequencies, on both of its lanes, must be bitwise equal: both are
``count / Q`` in float64.  The CUDA kernel itself is tested on a card, in
``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro.core import layouts as rl
from repro.engine.reorg.planner import scan_frequencies as ref_frequencies
from repro.kernels.move_score import move_score as jms
from repro.kernels.move_score import ref as jms_ref

from repro_torch.core import layouts as tl
from repro_torch.engine import compute
from repro_torch.engine.reorg import planner
from repro_torch.kernels.move_score import move_score, ops, ref

#: (Q, S, P, C): the shapes the reference's kernel tests take.
SHAPES = [(8, 2, 16, 4), (32, 2, 64, 8), (13, 3, 37, 5), (1, 2, 5, 1),
          (64, 4, 130, 7)]


def window_plane(rng, q, s, p, c, f32_exact):
    """A (Q, C) window and an (S, P, C) plane with empty partitions
    ([+inf, -inf]) and unbounded window columns; ``f32_exact`` keeps every
    finite value float32-representable."""
    def draw(lo, hi, shape):
        v = rng.uniform(lo, hi, shape)
        return v.astype(np.float32).astype(np.float64) if f32_exact else v
    p_min = draw(0, 1, (s, p, c))
    p_max = p_min + draw(0, 0.5, (s, p, c))
    empty = rng.random((s, p)) < 0.15
    p_min[empty], p_max[empty] = np.inf, -np.inf
    q_lo = draw(0, 1, (q, c))
    q_hi = q_lo + draw(0, 0.5, (q, c))
    q_lo[rng.random((q, c)) < 0.2] = -np.inf
    q_hi[rng.random((q, c)) < 0.2] = np.inf
    return q_lo, q_hi, p_min, p_max


def tt(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("q,s,p,c", SHAPES)
def test_plain_matches_jax_oracle_and_pallas_interpret(q, s, p, c):
    rng = np.random.default_rng(q * 1000 + p)
    ops_ = window_plane(rng, q, s, p, c, f32_exact=True)
    got = ref.move_scores(*tt(*ops_)).numpy()
    f32 = [a.astype(np.float32) for a in ops_]
    oracle = np.asarray(jms_ref.move_scores(*f32))
    pallas = np.asarray(jms.move_scores_pallas(*f32, interpret=True))
    np.testing.assert_allclose(got, oracle, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-7)
    assert got.dtype == np.float64 and got.shape == (s, p)


@pytest.mark.parametrize("q,s,p,c", SHAPES + [(5, 2, 9, 0)])
def test_plain_is_the_exact_count_over_q(q, s, p, c):
    """Bitwise equal to numpy's mean of the exact 0/1 scan matrix (what the
    reference's numpy planner lane computes), on float64 data."""
    rng = np.random.default_rng(7 * q + c)
    q_lo, q_hi, p_min, p_max = window_plane(rng, q, s, p, c, False)
    want = ((p_min[None] <= q_hi[:, None, None])
            & (p_max[None] >= q_lo[:, None, None])).all(-1).mean(axis=0)
    got = ops.move_scan_frequencies(*tt(q_lo, q_hi, p_min, p_max)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(compute.move_frequencies(
        q_lo, q_hi, *tt(p_min, p_max)), want)


def metas_pair(rng, c, p_s, p_t, n=600):
    """Two reference layouts' exact zone maps over one table, each with an
    empty partition (identity bounds)."""
    data = rng.uniform(0, 100, (n, c))
    out = []
    for p, col in ((p_s, 0), (p_t, c - 1)):
        order = np.argsort(data[:, col], kind="stable")
        assignment = np.empty(n, dtype=np.int64)
        assignment[order] = np.arange(n) * (p - 1) // n   # last one empty
        out.append(rl.metadata_from_assignment(data, assignment, p))
    return out


def port_meta(meta):
    return tl.PartitionMetadata(mins=torch.as_tensor(meta.mins),
                                maxs=torch.as_tensor(meta.maxs),
                                rows=torch.as_tensor(meta.rows))


@pytest.mark.parametrize("lane", planner.COMPUTES)
@pytest.mark.parametrize("p_s,p_t,q", [(8, 8, 64), (6, 11, 17), (16, 4, 1)])
def test_scan_frequencies_bitwise_equal_reference_numpy_lane(lane, p_s, p_t,
                                                            q):
    rng = np.random.default_rng(p_s * 100 + p_t)
    metas = metas_pair(rng, 5, p_s, p_t)
    q_lo = rng.uniform(0, 80, (q, 5))
    q_hi = q_lo + rng.uniform(0, 40, (q, 5))
    q_lo[rng.random((q, 5)) < 0.3] = -np.inf
    q_hi[rng.random((q, 5)) < 0.3] = np.inf
    want = ref_frequencies(metas, q_lo, q_hi, compute="numpy")
    got = planner.scan_frequencies([port_meta(m) for m in metas], q_lo,
                                   q_hi, compute=lane)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.flags.c_contiguous
        assert np.array_equal(g, w)


def test_fused_window_freq_equals_move_frequencies():
    rng = np.random.default_rng(3)
    q_lo, q_hi, p_min, p_max = window_plane(rng, 40, 3, 21, 6, False)
    plane = tt(p_min, p_max)
    fused = compute.fused_window_freq(q_lo, q_hi, plane[0][None],
                                      plane[1][None])
    assert fused.shape == (1, 3, 21)
    assert np.array_equal(fused[0], compute.move_frequencies(q_lo, q_hi,
                                                             *plane))


def test_wrapper_refuses_what_it_cannot_take_and_counts_no_cpu_launch():
    q = torch.zeros((4, 3), dtype=torch.float64)
    p = torch.zeros((2, 5, 3), dtype=torch.float64)
    before = move_score.move_scores.launches
    assert move_score.move_scores(q, q, p, p).shape == (2, 5)
    assert move_score.move_scores.launches == before
    with pytest.raises(ValueError, match="empty"):
        move_score.move_scores(q[:0], q[:0], p, p)
    with pytest.raises(TypeError, match="float64"):
        move_score.move_scores(q.float(), q.float(), p, p)
    with pytest.raises(ValueError, match="match"):
        move_score.move_scores(q[:, :2], q[:, :2], p, p)
    with pytest.raises(ValueError, match="3-D"):
        move_score.move_scores(q, q, p[0], p[0])
    with pytest.raises(ValueError, match="lane"):
        planner.scan_frequencies([], q.numpy(), q.numpy(), compute="numpy")


@pytest.mark.parametrize("path", sorted(move_score.PATHS))
def test_wrapper_takes_each_path_on_the_cpu_without_a_launch(path):
    """Every path runs the plain version on CPU tensors (the kernel's
    thread layout does not change the function) and counts no launch."""
    rng = np.random.default_rng(path)
    operands = tt(*window_plane(rng, 17, 3, 11, 4, False))
    before = move_score.move_scores.launches
    got = move_score.move_scores(*operands, path=path)
    assert move_score.move_scores.launches == before
    assert torch.equal(got, ref.move_scores(*operands))


@pytest.mark.parametrize("path", [-1, 3, 1.5, None])
def test_wrapper_refuses_other_paths_before_any_launch(path):
    q = torch.zeros((4, 3), dtype=torch.float64)
    p = torch.zeros((2, 5, 3), dtype=torch.float64)
    before = move_score.move_scores.launches
    with pytest.raises(ValueError, match="path"):
        move_score.move_scores(q, q, p, p, path=path)
    assert move_score.move_scores.launches == before


def test_wrapper_takes_columns_past_the_tile_limit_on_the_cpu():
    """3,000 columns (past the fleet tile's 2,905, where the card takes the
    thread-per-output kernel) give the plain result, which is numpy's exact
    mean; the windows leave all but a few columns unbounded so that some
    partitions are scanned."""
    rng = np.random.default_rng(3000)
    q_lo, q_hi, p_min, p_max = window_plane(rng, 12, 2, 6, 3_000, False)
    q_lo[:, 5:], q_hi[:, 5:] = -np.inf, np.inf
    want = ((p_min[None] <= q_hi[:, None, None])
            & (p_max[None] >= q_lo[:, None, None])).all(-1).mean(axis=0)
    assert 0 < want.max()
    got = move_score.move_scores(*tt(q_lo, q_hi, p_min, p_max))
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, ref.move_scores(*tt(q_lo, q_hi, p_min, p_max)))
