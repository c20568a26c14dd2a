"""Tests that need a CUDA card: the hand-written kernel against its plain
version, and the port's traces on the card against the CPU.

They import neither ``jax`` nor ``repro``, so they run where only the
port's dependencies are installed::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Without a card every test here skips.
"""
import numpy as np
import pytest
import torch

from repro_torch import core, engine
from repro_torch.data import make_tpch_like
from repro_torch.engine import compute
from repro_torch.kernels import _backend
from repro_torch.kernels.pruning import pruning, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def operands(rng, q, p, c, f32_exact=False):
    """Zone maps and query bounds with +-inf bounds, empty partitions and
    query bounds equal to zone-map ends.  ``f32_exact`` keeps every finite
    value on a grid float32 represents exactly."""
    def draw(lo, hi, shape):
        v = rng.uniform(lo, hi, shape)
        return np.round(v * 4) / 4 if f32_exact else v
    mins = draw(0, 100, (p, c))
    maxs = mins + draw(0, 30, (p, c))
    empty = rng.random(p) < 0.15
    mins[empty], maxs[empty] = np.inf, -np.inf
    lo = draw(-10, 110, (q, c))
    hi = lo + draw(0, 40, (q, c))
    if p and c:
        pick = rng.integers(0, p, (q, c))
        cols = np.broadcast_to(np.arange(c), (q, c))
        at_min = rng.random((q, c)) < 0.2
        at_max = rng.random((q, c)) < 0.2
        hi[at_min] = mins[pick, cols][at_min]
        lo[at_max] = maxs[pick, cols][at_max]
    lo[rng.random((q, c)) < 0.35] = -np.inf
    hi[rng.random((q, c)) < 0.35] = np.inf
    return lo, hi, mins, maxs


def plain(lo, hi, mins, maxs):
    return ref.scan_matrix(*[torch.as_tensor(a)
                             for a in (lo, hi, mins, maxs)]).numpy()


@pytest.mark.parametrize("q,p,c,pad", [(1, 288, 32, 0), (64, 32, 32, 0),
                                       (2048, 32, 32, 0), (1000, 37, 5, 0),
                                       (16, 40, 0, 0), (64, 288, 32, 3),
                                       (600_000, 3, 2, 0)])   # > 65,535 query blocks
def test_kernel_matches_plain(cuda_device, q, p, c, pad):
    rng = np.random.default_rng(q + p + c)
    lo, hi, mins, maxs = operands(rng, q, p, c)
    dev = [torch.as_tensor(a, device=cuda_device) for a in (lo, hi)]
    wide_min = torch.zeros((p, c + pad), dtype=torch.float64,
                           device=cuda_device)
    wide_max = torch.zeros_like(wide_min)
    wide_min[:, :c] = torch.as_tensor(mins, device=cuda_device)
    wide_max[:, :c] = torch.as_tensor(maxs, device=cuda_device)
    before = pruning.scan_matrix.launches
    got = pruning.scan_matrix(*dev, wide_min[:, :c], wide_max[:, :c])
    torch.cuda.synchronize()
    assert pruning.scan_matrix.launches == before + 1
    assert np.array_equal(got.cpu().numpy(), plain(lo, hi, mins, maxs))


def test_compute_and_state_matrix_reach_the_kernel(cuda_device):
    rng = np.random.default_rng(1)
    lo, hi, mins, maxs = operands(rng, 3, 40, 6)
    dmin, dmax = (torch.as_tensor(a, device=cuda_device)
                  for a in (mins, maxs))
    before = pruning.scan_matrix.launches
    assert np.array_equal(compute.scan_matrix(lo, hi, dmin, dmax),
                          plain(lo, hi, mins, maxs))
    plane = torch.stack([dmin, dmin + 1]), torch.stack([dmax, dmax + 1])
    got = compute.masked_overlap(*plane, lo[0], hi[0])
    want = compute.masked_overlap(*(t.cpu() for t in plane), lo[0], hi[0])
    assert np.array_equal(got, want)
    assert pruning.scan_matrix.launches == before + 2


def test_cuda_operands_the_kernel_cannot_take_raise(cuda_device):
    q = torch.zeros((4, 6), dtype=torch.float64, device=cuda_device)
    p = torch.zeros((5, 3), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError):
        pruning.scan_matrix(q[:, ::2], q[:, ::2], p, p)   # strided queries
    with pytest.raises(ValueError):
        pruning.scan_matrix(q[:, :3], q[:, :3], p, p.cpu())


def test_traces_on_the_card_equal_the_cpu(cuda_device):
    rng = np.random.default_rng(0)
    table = rng.uniform(0, 100, size=(20_000, 8))
    templates = core.make_templates(4, 8, rng)
    stream = core.generate_workload(templates, table.min(0), table.max(0),
                                    total_queries=600, seed=1,
                                    segment_length=(150, 250))
    traces = []
    for dev in (cuda_device, torch.device("cpu")):
        data = torch.as_tensor(table, device=dev)
        policy = engine.OreoPolicy(
            data, core.build_default_layout(0, data, 16),
            core.make_generator("qdtree"),
            core.OreoConfig(alpha=20.0, seed=3, manager=core.
                            LayoutManagerConfig(target_partitions=16)))
        before = pruning.scan_matrix.launches
        traces.append(engine.LayoutEngine(
            policy, engine.InMemoryBackend(data)).run(stream))
        launched = pruning.scan_matrix.launches - before
        assert (launched > 0) == (dev.type == "cuda")
    card, cpu = traces
    assert card.num_reorgs > 0
    assert np.array_equal(card.query_costs, cpu.query_costs)
    assert card.reorg_indices == cpu.reorg_indices
    assert np.array_equal(card.state_seq, cpu.state_seq)


def test_default_device_is_the_card(cuda_device):
    assert _backend.resolve_device().type == "cuda"
    data, _ = make_tpch_like(1000, seed=2)
    assert data.device.type == "cuda"
    cpu, _ = make_tpch_like(1000, seed=2, device="cpu")
    assert torch.equal(data.cpu(), cpu)
