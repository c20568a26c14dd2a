"""Tests that need a CUDA card: the hand-written kernels against their
plain versions, and the port's traces on the card against the CPU.

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


def plane_operands(rng, b, t, s, p, c, f32_exact=False, window=0):
    """Frames (B, T, C) and a packed plane (T, S, P, C) with +-inf bounds,
    empty partitions, padded states, query bounds equal to zone-map ends
    and, in every frame, one query-less tenant row of [-inf, +inf]
    dummies; plus rows (T, S, P), inverse totals (T, S) and a (W, C)
    window when ``window`` > 0.  ``f32_exact`` keeps every finite value on
    a grid float32 represents exactly."""
    lo, hi, mins, maxs = operands(rng, b * t, t * s * p, c, f32_exact)
    lo, hi = lo.reshape(b, t, c), hi.reshape(b, t, c)
    mins, maxs = mins.reshape(t, s, p, c), maxs.reshape(t, s, p, c)
    if s > 1:
        mins[:, -1, p // 2:], maxs[:, -1, p // 2:] = np.inf, -np.inf
    if t > 1:
        dummy = rng.integers(0, t, b)
        lo[np.arange(b), dummy], hi[np.arange(b), dummy] = -np.inf, np.inf
    rows = rng.integers(0, 1000, (t, s, p)).astype(np.float64)
    inv = 1.0 / np.maximum(rows.sum(-1), 1.0)
    w_lo, w_hi, _, _ = operands(rng, window, 1, c, f32_exact)
    return lo, hi, mins, maxs, rows, inv, w_lo, w_hi


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


def nan_inf_zone_maps(rng, mins, maxs):
    """NaN and +-inf entries in zone maps (a NaN bound fails its compare,
    an infinite one passes or fails as numpy says)."""
    mins, maxs = mins.copy(), maxs.copy()
    for a, v, share in ((mins, np.nan, 0.03), (maxs, np.nan, 0.03),
                        (mins, -np.inf, 0.05), (maxs, np.inf, 0.05)):
        a[rng.random(a.shape) < share] = v
    return mins, maxs


@pytest.mark.parametrize("path", [1, 2])
@pytest.mark.parametrize("q,p,c,pad,lead", [
    (1, 288, 32, 0, 0), (1, 37, 5, 2, 3), (8, 300, 33, 0, 0),
    (64, 288, 32, 3, 7), (256, 288, 32, 0, 0), (1024, 288, 32, 1, 5),
    (1000, 37, 70, 1, 3), (33, 65, 1, 0, 0), (16, 40, 0, 0, 0),
    (257, 31, 64, 2, 1)])
def test_each_tile_matches_plain(cuda_device, path, q, p, c, pad, lead):
    """Each forced tile, bitwise, on NaN and +-inf zone maps, a row-strided
    plane and query bounds that are a row slice of a wider tensor."""
    rng = np.random.default_rng(q * 7 + p + c + path)
    lo, hi, mins, maxs = operands(rng, q, p, c)
    mins, maxs = nan_inf_zone_maps(rng, mins, maxs)
    bounds = torch.zeros((2, q + lead + 2, c + pad), dtype=torch.float64,
                         device=cuda_device)
    bounds[0, lead:lead + q, :c] = torch.as_tensor(lo, device=cuda_device)
    bounds[1, lead:lead + q, :c] = torch.as_tensor(hi, device=cuda_device)
    plane = torch.zeros((2, p, c + pad), dtype=torch.float64,
                        device=cuda_device)
    plane[0, :, :c] = torch.as_tensor(mins, device=cuda_device)
    plane[1, :, :c] = torch.as_tensor(maxs, device=cuda_device)
    before = pruning.scan_matrix.launches
    got = pruning.scan_matrix(bounds[0, lead:lead + q, :c],
                              bounds[1, lead:lead + q, :c], plane[0, :, :c],
                              plane[1, :, :c], path=path)
    torch.cuda.synchronize()
    assert pruning.scan_matrix.launches == before + 1
    assert np.array_equal(got.cpu().numpy(), plain(lo, hi, mins, maxs))


def test_the_kernel_chooses_its_tile_from_the_operands(cuda_device):
    # The row tile while Q x ceil(P / 64) row blocks stay at most 512.
    assert [pruning.chosen_path(q, 288, 32) for q in (1, 102, 103, 256)] == \
        [1, 1, 2, 2]
    assert [pruning.chosen_path(q, 32, 32) for q in (200, 512, 513)] == \
        [1, 1, 2]
    q = torch.zeros((4, 3), dtype=torch.float64, device=cuda_device)
    before = pruning.scan_matrix.launches
    with pytest.raises(ValueError, match="path"):
        pruning.scan_matrix(q, q, q, q, path=3)
    assert pruning.scan_matrix.launches == before


def test_block_run_on_the_card_equals_step_loop_and_cpu(cuda_device):
    """run() scores estimates a block per launch, step() one per launch:
    equal traces, and far fewer launches for run()."""
    rng = np.random.default_rng(2)
    table = rng.uniform(0, 100, size=(20_000, 8))
    stream = core.generate_workload(core.make_templates(4, 8, rng),
                                    table.min(0), table.max(0),
                                    total_queries=600, seed=1,
                                    segment_length=(150, 250))
    traces, launches = {}, {}
    for where, dev, mode in (("card", cuda_device, "run"),
                             ("card", cuda_device, "step"),
                             ("cpu", torch.device("cpu"), "run")):
        data = torch.as_tensor(table, device=dev)
        for method in ("OREO", "MTS Optimal"):
            gen = core.make_generator("qdtree")
            if method == "OREO":
                policy = engine.OreoPolicy(
                    data, core.build_default_layout(0, data, 16), gen,
                    core.OreoConfig(alpha=20.0, seed=3, manager=core.
                                    LayoutManagerConfig(target_partitions=16)))
            else:
                policy = engine.MTSOptimalPolicy(data, stream, gen, 20.0,
                                                 target_partitions=16)
            eng = engine.LayoutEngine(policy, engine.InMemoryBackend(data))
            before = pruning.scan_matrix.launches
            if mode == "run":
                res = eng.run(stream)
            else:
                for q in stream:
                    eng.step(q)
                res = eng.result()
            traces[where, mode, method] = res
            launches[where, mode, method] = (pruning.scan_matrix.launches
                                             - before)
    for method in ("OREO", "MTS Optimal"):
        want = traces["cpu", "run", method]
        for mode in ("run", "step"):
            got = traces["card", mode, method]
            assert np.array_equal(got.query_costs, want.query_costs)
            assert got.reorg_indices == want.reorg_indices
            assert np.array_equal(got.state_seq, want.state_seq)
        assert launches["cpu", "run", method] == 0
        assert launches["card", "step", method] >= len(stream)
        assert (4 * launches["card", "run", method]
                < launches["card", "step", method])


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


# ---------------------------------------------------------------------------
# The fleet kernels
# ---------------------------------------------------------------------------

def plane_on(device, mins, maxs, c_pad=0, t_step=1):
    """The (T, S, P, C) plane on ``device``, as a view of a plane with
    ``c_pad`` more columns and ``t_step`` times the tenants when asked."""
    t, s, p, c = mins.shape
    wide = torch.zeros((t * t_step, s, p, c + c_pad), dtype=torch.float64,
                       device=device)
    wmin, wmax = wide, wide.clone()
    wmin[::t_step, ..., :c] = torch.as_tensor(mins, device=device)
    wmax[::t_step, ..., :c] = torch.as_tensor(maxs, device=device)
    return wmin[::t_step, ..., :c], wmax[::t_step, ..., :c]


@pytest.mark.parametrize("b,t,s,p,c,c_pad,t_step", [
    (16, 32, 8, 16, 8, 0, 1),         # fleet16 pass: T_cap x S_cap x P_cap
    (16, 128, 12, 8, 10, 0, 1),       # fleet64 pass
    (3, 17, 2, 65, 7, 0, 1),          # ragged everywhere
    (2, 3, 4, 40, 0, 0, 1),           # no columns: every slot scanned
    (1, 1, 1, 1, 1, 0, 1),            # one frame, one slot
    (4, 6, 3, 10, 5, 2, 2),           # strided plane view
    (1, 70_000, 1, 4, 2, 0, 1),       # tenants past a 65,535-block axis
])
def test_fleet_scan_kernel_matches_plain(cuda_device, b, t, s, p, c, c_pad,
                                         t_step):
    from repro_torch.kernels.fleet_scan import fleet_scan
    from repro_torch.kernels.fleet_scan import ref as fref
    rng = np.random.default_rng(b + t + s + p + c)
    lo, hi, mins, maxs, *_ = plane_operands(rng, b, t, s, p, c)
    vmin, vmax = plane_on(cuda_device, mins, maxs, c_pad, t_step)
    vmin3, vmax3 = vmin.flatten(1, 2), vmax.flatten(1, 2)    # views
    assert vmin3.data_ptr() == vmin.data_ptr()
    for k in range(b):
        q = [torch.as_tensor(a[k], device=cuda_device) for a in (lo, hi)]
        before = fleet_scan.scan_fleet.launches
        got = fleet_scan.scan_fleet(*q, vmin3, vmax3)
        torch.cuda.synchronize()
        assert fleet_scan.scan_fleet.launches == before + 1
        want = fref.scan_fleet(*[torch.as_tensor(a) for a in (
            lo[k], hi[k], mins.reshape(t, s * p, c),
            maxs.reshape(t, s * p, c))])
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("b,t,s,p,c,w,c_pad,t_step", [
    (16, 32, 8, 16, 8, 0, 0, 1),      # fleet16 pass
    (16, 128, 12, 8, 10, 80, 0, 1),   # fleet64 pass, with a window
    (3, 17, 3, 130, 7, 5, 0, 1),      # ragged
    (2, 3, 2, 300, 3, 2, 0, 1),       # partitions past one tile
    (2, 4, 2, 33, 100, 3, 0, 1),      # bounds past 48 KB of shared memory
    (2, 3, 4, 40, 0, 2, 0, 1),        # no columns
    (1, 5, 3, 9, 4, 1, 0, 1),         # B = 1, W = 1
    (4, 6, 3, 10, 5, 3, 2, 2),        # strided plane view
    (2, 70_000, 1, 4, 2, 3, 0, 1),    # tenants past a 65,535-block axis
    (3, 2, 3, 700, 40, 3, 0, 1),      # S * P past one shared-memory tile
    (2, 3, 2, 650, 40, 2, 1, 2),      # the same, strided
    (2, 4, 2, 0, 3, 2, 0, 1),         # no slots: costs 0 * inv
])
def test_decision_fused_kernel_matches_plain(cuda_device, b, t, s, p, c, w,
                                             c_pad, t_step):
    from repro_torch.kernels.decision_fused import decision_fused
    from repro_torch.kernels.decision_fused import ref as dref
    rng = np.random.default_rng(b * t + s * p + c + w)
    lo, hi, mins, maxs, rows, inv, w_lo, w_hi = plane_operands(
        rng, b, t, s, p, c, window=w)
    vmin, vmax = plane_on(cuda_device, mins, maxs, c_pad, t_step)
    dev = [torch.as_tensor(a, device=cuda_device)
           for a in (lo, hi, rows, inv, w_lo, w_hi)]
    window = dev[4:] if w else [None, None]
    before = decision_fused.fused_decision.launches
    scan, cost, freq = decision_fused.fused_decision(
        dev[0], dev[1], vmin, vmax, dev[2], dev[3], *window)
    again = decision_fused.fused_decision(dev[0], dev[1], vmin, vmax, dev[2],
                                          dev[3])
    torch.cuda.synchronize()
    assert decision_fused.fused_decision.launches == before + 2
    w_scan, w_cost, w_freq = dref.fused_decision(*[
        None if a is None else torch.as_tensor(a) for a in (
            lo, hi, mins, maxs, rows, inv,
            w_lo if w else None, w_hi if w else None)])
    assert torch.equal(scan.cpu(), w_scan)
    assert torch.equal(again[0], scan) and torch.equal(again[1], cost)
    assert torch.allclose(cost.cpu(), w_cost, rtol=1e-12, atol=0)
    if w:
        assert torch.equal(freq.cpu(), w_freq)
    else:
        assert freq is None


def test_fleet_kernels_refuse_cuda_operands_they_cannot_take(cuda_device):
    from repro_torch.kernels.decision_fused import decision_fused
    from repro_torch.kernels.fleet_scan import fleet_scan
    kw = dict(dtype=torch.float64, device=cuda_device)
    q = torch.zeros((2, 3, 8), **kw)
    plane = torch.zeros((3, 2, 5, 8), **kw)
    with pytest.raises(ValueError):                    # strided frames
        decision_fused.fused_decision(q[..., ::2], q[..., ::2],
                                      plane[..., :4], plane[..., :4])
    with pytest.raises(ValueError):                    # column stride 2
        decision_fused.fused_decision(q[..., :4], q[..., :4],
                                      plane[..., ::2], plane[..., ::2])
    with pytest.raises(ValueError):                    # mixed devices
        decision_fused.fused_decision(q, q, plane, plane.cpu())
    c = decision_fused._lib().decision_fused_max_columns() + 1
    wide = torch.zeros((1, 1, 1, c), **kw)             # past shared memory
    with pytest.raises(ValueError, match="columns"):
        decision_fused.fused_decision(torch.zeros((1, 1, c), **kw),
                                      torch.zeros((1, 1, c), **kw),
                                      wide, wide)
    flat = plane.reshape(3, 10, 8)
    with pytest.raises(ValueError):                    # strided queries
        fleet_scan.scan_fleet(q[0, :, ::2], q[0, :, ::2], flat[..., :4],
                              flat[..., :4])
    with pytest.raises(ValueError):                    # column stride 2
        fleet_scan.scan_fleet(q[0, :, :4], q[0, :, :4], flat[..., ::2],
                              flat[..., ::2])


def with_nans(rng, *arrays):
    for a in arrays:
        a[rng.random(a.shape) < 0.05] = np.nan


def fleet_kernels_against_plain(device, rng, b, t, s, p, c, w, c_pad=0,
                                t_step=1, nan=False):
    """Both fleet kernels on one plane: the fused kernel's three outputs
    and a fleet-scan launch per frame, against the plain versions."""
    from repro_torch.kernels.decision_fused import decision_fused
    from repro_torch.kernels.decision_fused import ref as dref
    from repro_torch.kernels.fleet_scan import fleet_scan
    from repro_torch.kernels.fleet_scan import ref as fref
    lo, hi, mins, maxs, rows, inv, w_lo, w_hi = plane_operands(
        rng, b, t, s, p, c, window=w)
    if nan:
        with_nans(rng, lo, hi, mins, maxs, w_lo, w_hi)
    vmin, vmax = plane_on(device, mins, maxs, c_pad, t_step)
    dev = [torch.as_tensor(a, device=device)
           for a in (lo, hi, rows, inv, w_lo, w_hi)]
    scan, cost, freq = decision_fused.fused_decision(
        dev[0], dev[1], vmin, vmax, dev[2], dev[3], dev[4], dev[5])
    frames = [fleet_scan.scan_fleet(dev[0][k], dev[1][k], vmin.flatten(1, 2),
                                    vmax.flatten(1, 2)) for k in range(b)]
    torch.cuda.synchronize()
    cpu = [torch.as_tensor(a) for a in (lo, hi, mins, maxs, rows, inv, w_lo,
                                        w_hi)]
    w_scan, w_cost, w_freq = dref.fused_decision(*cpu)
    assert torch.equal(scan.cpu(), w_scan)
    assert torch.allclose(cost.cpu(), w_cost, rtol=1e-12, atol=0)
    assert torch.equal(freq.cpu(), w_freq)
    for k, got in enumerate(frames):
        want = fref.scan_fleet(cpu[0][k], cpu[1][k],
                               cpu[2].reshape(t, s * p, c),
                               cpu[3].reshape(t, s * p, c))
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("b,t,s,p,c,w,c_pad,t_step", [
    (16, 32, 8, 16, 8, 80, 0, 1),     # fleet16 pass, with a window
    (16, 128, 12, 8, 10, 80, 0, 1),   # fleet64 pass, with a window
    (3, 17, 3, 130, 7, 5, 2, 2),      # ragged, strided
])
def test_fleet_kernels_match_plain_on_nan_bounds(cuda_device, b, t, s, p, c,
                                                 w, c_pad, t_step):
    rng = np.random.default_rng(b + t + p)
    fleet_kernels_against_plain(cuda_device, rng, b, t, s, p, c, w, c_pad,
                                t_step, nan=True)


def test_fleet_kernels_take_columns_up_to_the_tile_limit(cuda_device):
    from repro_torch.kernels.decision_fused import decision_fused
    from repro_torch.kernels.fleet_scan import fleet_scan
    from repro_torch.kernels.fleet_scan import ref as fref
    c = decision_fused._lib().decision_fused_max_columns()
    assert c >= 453                   # the earlier design's limit
    rng = np.random.default_rng(9)
    fleet_kernels_against_plain(cuda_device, rng, 2, 2, 2, 5, c, 2)
    # Past the tile's limit the fleet scan still takes the rows (its
    # earlier design had none); the fused kernel refuses them.
    lo, hi, mins, maxs, *_ = plane_operands(rng, 1, 3, 2, 5, c + 7)
    q = [torch.as_tensor(a[0], device=cuda_device) for a in (lo, hi)]
    vmin, vmax = plane_on(cuda_device, mins, maxs)
    got = fleet_scan.scan_fleet(*q, vmin.flatten(1, 2), vmax.flatten(1, 2))
    want = fref.scan_fleet(*[torch.as_tensor(a) for a in (
        lo[0], hi[0], mins.reshape(3, 10, c + 7), maxs.reshape(3, 10, c + 7))])
    assert torch.equal(got.cpu(), want)


def test_decision_fused_freq_only_launch_matches_plain(cuda_device):
    from repro_torch.kernels.decision_fused import decision_fused
    from repro_torch.kernels.decision_fused import ref as dref
    rng = np.random.default_rng(11)
    for s, p, c, w in ((2, 16, 8, 1_000), (2, 16, 8, 64), (3, 37, 5, 1)):
        _, _, mins, maxs, _, _, w_lo, w_hi = plane_operands(
            rng, 0, 1, s, p, c, window=w)
        vmin, vmax = plane_on(cuda_device, mins, maxs)
        frames = torch.empty((0, 1, c), dtype=torch.float64,
                             device=cuda_device)
        dlo, dhi = (torch.as_tensor(a, device=cuda_device)
                    for a in (w_lo, w_hi))
        before = decision_fused.fused_decision.launches
        scan, cost, freq = decision_fused.fused_decision(
            frames, frames, vmin, vmax, w_lo=dlo, w_hi=dhi, emit_scan=False)
        torch.cuda.synchronize()
        assert decision_fused.fused_decision.launches == before + 1
        assert scan is None and cost is None
        want = dref.fused_decision(
            frames.cpu(), frames.cpu(), torch.as_tensor(mins),
            torch.as_tensor(maxs), w_lo=torch.as_tensor(w_lo),
            w_hi=torch.as_tensor(w_hi))[2]
        assert torch.equal(freq.cpu(), want)


@pytest.mark.parametrize("b,t,s,p,c", [(16, 128, 12, 8, 10),
                                       (3, 2, 3, 700, 40),
                                       (5, 7, 5, 3, 6)])
def test_decision_fused_cost_is_bitwise_equal_across_launches(cuda_device, b,
                                                              t, s, p, c):
    from repro_torch.kernels.decision_fused import decision_fused
    from repro_torch.kernels.decision_fused import ref as dref
    rng = np.random.default_rng(b * t + p)
    lo, hi, mins, maxs, rows, inv, *_ = plane_operands(rng, b, t, s, p, c)
    rows *= rng.uniform(0.5, 2.0, rows.shape)      # qd-tree scaled counts
    vmin, vmax = plane_on(cuda_device, mins, maxs)
    dev = [torch.as_tensor(a, device=cuda_device)
           for a in (lo, hi, rows, inv)]
    costs = [decision_fused.fused_decision(dev[0], dev[1], vmin, vmax,
                                           dev[2], dev[3],
                                           emit_scan=False)[1]
             for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(costs[0].view(torch.int64), costs[1].view(torch.int64))
    want = dref.fused_decision(*[torch.as_tensor(a) for a in (
        lo, hi, mins, maxs, rows, inv)])[1]
    assert torch.allclose(costs[0].cpu(), want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("path", [1, 2])
@pytest.mark.parametrize("b,t,s,p,c,w,c_pad,t_step", [
    (16, 128, 12, 8, 10, 80, 0, 1),   # fleet64 pass, with a window
    (1, 128, 12, 8, 10, 1, 0, 1),     # fleet64 frame
    (3, 17, 3, 130, 7, 5, 2, 2),      # ragged, strided
    (3, 2, 3, 700, 40, 3, 0, 1),      # S * P past one tile
    (2, 3, 4, 40, 0, 2, 0, 1),        # no columns
])
def test_each_fleet_path_matches_plain(cuda_device, path, b, t, s, p, c, w,
                                       c_pad, t_step):
    from repro_torch.kernels.decision_fused import decision_fused
    from repro_torch.kernels.decision_fused import ref as dref
    from repro_torch.kernels.fleet_scan import fleet_scan
    from repro_torch.kernels.fleet_scan import ref as fref
    rng = np.random.default_rng(path + b + p)
    lo, hi, mins, maxs, rows, inv, w_lo, w_hi = plane_operands(
        rng, b, t, s, p, c, window=w)
    with_nans(rng, lo, hi, mins, maxs)
    vmin, vmax = plane_on(cuda_device, mins, maxs, c_pad, t_step)
    dev = [torch.as_tensor(a, device=cuda_device)
           for a in (lo, hi, rows, inv, w_lo, w_hi)]
    scan, cost, freq = decision_fused.fused_decision(
        *dev[:2], vmin, vmax, *dev[2:], path=path)
    frames = [fleet_scan.scan_fleet(dev[0][k], dev[1][k], vmin.flatten(1, 2),
                                    vmax.flatten(1, 2), path=path)
              for k in range(b)]
    torch.cuda.synchronize()
    cpu = [torch.as_tensor(a) for a in (lo, hi, mins, maxs, rows, inv, w_lo,
                                        w_hi)]
    w_scan, w_cost, w_freq = dref.fused_decision(*cpu)
    assert torch.equal(scan.cpu(), w_scan)
    assert torch.allclose(cost.cpu(), w_cost, rtol=1e-12, atol=0)
    assert torch.equal(freq.cpu(), w_freq)
    for k, got in enumerate(frames):
        assert torch.equal(got.cpu(), fref.scan_fleet(
            cpu[0][k], cpu[1][k], cpu[2].reshape(t, s * p, c),
            cpu[3].reshape(t, s * p, c)))
    with pytest.raises(ValueError, match="path"):
        decision_fused.fused_decision(*dev[:2], vmin, vmax, path=3)
    with pytest.raises(ValueError, match="path"):
        fleet_scan.scan_fleet(dev[0][0], dev[1][0], vmin.flatten(1, 2),
                              vmax.flatten(1, 2), path=-1)


def test_fleet_lanes_reach_the_kernels_and_equal_the_cpu(cuda_device):
    from repro_torch.kernels.decision_fused import decision_fused
    from repro_torch.kernels.fleet_scan import fleet_scan
    rng = np.random.default_rng(2)
    tables = {f"t{t}": rng.uniform(0, 100, size=(4_000, 6)) for t in
              range(3)}
    lo = np.min([d.min(0) for d in tables.values()], axis=0)
    hi = np.max([d.max(0) for d in tables.values()], axis=0)
    stream = core.make_drift_scenario("sudden_shift", lo, hi, num_tenants=3,
                                      queries_per_tenant=90, seed=7)

    def fleet(dev):
        engines = {}
        for tid, table in tables.items():
            data = torch.as_tensor(table, device=dev)
            cfg = core.OreoConfig(alpha=10.0, seed=2, delta=5, manager=core.
                                  LayoutManagerConfig(target_partitions=8,
                                                      window_size=60,
                                                      gen_every=30))
            engines[tid] = engine.LayoutEngine(engine.OreoPolicy(
                data, core.build_default_layout(0, data, 8),
                core.make_generator("qdtree"), cfg),
                engine.InMemoryBackend(data), delta=cfg.delta)
        return engine.FleetEngine(engines, engine.KConcurrentScheduler(1))
    cpu = fleet(torch.device("cpu")).run(stream)
    assert cpu.num_reorgs > 0
    for lane, counter in (("fleet_scan", fleet_scan.scan_fleet),
                          ("decision_fused", decision_fused.fused_decision)):
        before = counter.launches
        card = fleet(cuda_device).run_batched(stream, compute=lane)
        assert counter.launches > before
        for tid in stream.tenant_ids:
            a, b = card.per_tenant[tid], cpu.per_tenant[tid]
            assert np.array_equal(a.query_costs, b.query_costs)
            assert a.reorg_indices == b.reorg_indices
            assert np.array_equal(a.state_seq, b.state_seq)
        assert (card.swaps_deferred, card.deferred_ticks,
                card.scheduler_stats) == (cpu.swaps_deferred,
                                          cpu.deferred_ticks,
                                          cpu.scheduler_stats)


# ---------------------------------------------------------------------------
# move_score and the incremental reorganization plane
# ---------------------------------------------------------------------------

def window_operands(rng, q, s, p, c):
    """A (Q, C) window and an (S, P, C) plane with empty partitions,
    +-inf window bounds and window bounds equal to zone-map ends."""
    mins = rng.uniform(0, 100, (s, p, c))
    maxs = mins + rng.uniform(0, 30, (s, p, c))
    empty = rng.random((s, p)) < 0.15
    mins[empty], maxs[empty] = np.inf, -np.inf
    lo = rng.uniform(-10, 110, (q, c))
    hi = lo + rng.uniform(0, 60, (q, c))
    if s * p and c:
        pick = rng.integers(0, s * p, (q, c))
        flat_min, flat_max = mins.reshape(-1, c), maxs.reshape(-1, c)
        cols = np.broadcast_to(np.arange(c), (q, c))
        at_min = rng.random((q, c)) < 0.2
        at_max = rng.random((q, c)) < 0.2
        hi[at_min] = flat_min[pick, cols][at_min]
        lo[at_max] = flat_max[pick, cols][at_max]
    lo[rng.random((q, c)) < 0.35] = -np.inf
    hi[rng.random((q, c)) < 0.35] = np.inf
    return lo, hi, mins, maxs


def move_score_against_plain(device, lo, hi, mins, maxs, path=0, c_pad=0,
                             p_pad=0):
    """One move_score launch on ``path`` over a view of a plane with
    ``c_pad`` more columns and ``p_pad`` more partitions: bitwise the plain
    version on the CPU copies, one launch counted."""
    from repro_torch.kernels.move_score import move_score, ref as mref
    s, p, c = mins.shape
    wide_min = torch.zeros((s, p + p_pad, c + c_pad), dtype=torch.float64,
                           device=device)
    wide_max = torch.zeros_like(wide_min)
    wide_min[:, :p, :c] = torch.as_tensor(mins, device=device)
    wide_max[:, :p, :c] = torch.as_tensor(maxs, device=device)
    dev = [torch.as_tensor(a, device=device) for a in (lo, hi)]
    before = move_score.move_scores.launches
    got = move_score.move_scores(*dev, wide_min[:, :p, :c],
                                 wide_max[:, :p, :c], path=path)
    torch.cuda.synchronize()
    assert move_score.move_scores.launches == before + 1
    want = mref.move_scores(*[torch.as_tensor(a)
                              for a in (lo, hi, mins, maxs)])
    assert torch.equal(got.cpu().view(torch.int64), want.view(torch.int64))
    return want


MOVE_SCORE_SHAPES = [
    (64, 2, 16, 8, 0), (64, 2, 32, 32, 0), (1, 2, 16, 8, 0),
    (40, 3, 37, 5, 0), (64, 2, 130, 7, 0), (64, 4096, 16, 8, 0),
    (64, 2, 32, 32, 3), (9, 2, 20, 0, 0),
    (200, 2, 33, 100, 0)]           # window tiles past 48 KB of shared memory


@pytest.mark.parametrize("q,s,p,c,pad", MOVE_SCORE_SHAPES)
def test_move_score_kernel_matches_plain(cuda_device, q, s, p, c, pad):
    rng = np.random.default_rng(q + s + p + c)
    move_score_against_plain(cuda_device, *window_operands(rng, q, s, p, c),
                             c_pad=pad)


@pytest.mark.parametrize("path", [1, 2])
@pytest.mark.parametrize("q,s,p,c,pad", MOVE_SCORE_SHAPES)
def test_each_move_score_path_matches_plain(cuda_device, path, q, s, p, c,
                                            pad):
    rng = np.random.default_rng(q + s + p + c)
    move_score_against_plain(cuda_device, *window_operands(rng, q, s, p, c),
                             path=path, c_pad=pad)


@pytest.mark.parametrize("path", [0, 1, 2])
def test_move_score_matches_plain_on_nan_and_inf_bounds(cuda_device, path):
    """NaN in 5 % of the zone-map ends and window bounds (a NaN fails its
    compare), on a ragged plane strided in both partitions and columns,
    and +-inf identity rows and padding."""
    rng = np.random.default_rng(50 + path)
    lo, hi, mins, maxs = window_operands(rng, 64, 3, 37, 8)
    for a in (lo, hi, mins, maxs):
        a[rng.random(a.shape) < 0.05] = np.nan
    move_score_against_plain(cuda_device, lo, hi, mins, maxs, path, 2, 1)
    lo, hi, mins, maxs = window_operands(rng, 64, 2, 16, 8)
    mins[:, 12:], maxs[:, 12:] = np.inf, -np.inf
    lo[::2], hi[::2] = -np.inf, np.inf
    want = move_score_against_plain(cuda_device, lo, hi, mins, maxs, path)
    # [+inf, -inf] padding overlaps only the [-inf, +inf] rows, as in numpy.
    assert (want[:, 12:] == 0.5).all()


@pytest.mark.parametrize("path", [0, 1, 2])
def test_move_score_window_of_1000_rows_is_count_over_q(cuda_device, path):
    """count / 1,000 is not the product with the reciprocal: the kernel's
    one division must give the plain version's bits."""
    rng = np.random.default_rng(1_000 + path)
    move_score_against_plain(cuda_device,
                             *window_operands(rng, 1_000, 2, 16, 8), path)


@pytest.mark.parametrize("path", [0, 1, 2])
def test_move_score_slots_past_one_tile(cuda_device, path):
    """16,000 slots of 100 columns: a block loops over two tiles of zone
    maps; dense and with a state stride past P * C."""
    rng = np.random.default_rng(16_000 + path)
    ops = window_operands(rng, 64, 4, 4_000, 100)
    move_score_against_plain(cuda_device, *ops, path)
    move_score_against_plain(cuda_device, *ops, path, p_pad=3)


@pytest.mark.parametrize("path", [0, 1, 2])
def test_move_score_takes_columns_past_the_tile_limit(cuda_device, path):
    """At the tile's limit the tile takes the plane; one column past it the
    thread-per-output kernel does.  Windows bound only their first eight
    columns, so partitions are scanned."""
    from repro_torch.kernels.decision_fused import decision_fused
    limit = decision_fused._lib().decision_fused_max_columns()
    assert limit == 2_905
    rng = np.random.default_rng(limit + path)
    for c in (limit, limit + 1):
        lo, hi, mins, maxs = window_operands(rng, 100, 2, 5, c)
        lo[:, 8:], hi[:, 8:] = -np.inf, np.inf
        want = move_score_against_plain(cuda_device, lo, hi, mins, maxs,
                                        path, c_pad=1)
        assert want.max() > 0


def test_move_score_refuses_cuda_operands_it_cannot_take(cuda_device):
    from repro_torch.kernels.move_score import move_score
    kw = dict(dtype=torch.float64, device=cuda_device)
    q = torch.zeros((4, 8), **kw)
    plane = torch.zeros((2, 5, 8), **kw)
    with pytest.raises(ValueError):                    # strided window
        move_score.move_scores(q[:, ::2], q[:, ::2], plane[..., :4],
                               plane[..., :4])
    with pytest.raises(ValueError):                    # column stride 2
        move_score.move_scores(q[:, :4], q[:, :4], plane[..., ::2],
                               plane[..., ::2])
    with pytest.raises(ValueError):                    # mixed devices
        move_score.move_scores(q, q, plane, plane.cpu())
    with pytest.raises(ValueError, match="empty"):
        move_score.move_scores(q[:0], q[:0], plane, plane)
    with pytest.raises(ValueError, match="path"):
        move_score.move_scores(q, q, plane, plane, path=3)
    # 500 columns, refused by the kernel's earlier design, are taken.
    rng = np.random.default_rng(500)
    lo, hi, mins, maxs = window_operands(rng, 4, 1, 3, 500)
    lo[:, 4:], hi[:, 4:] = -np.inf, np.inf
    move_score_against_plain(cuda_device, lo, hi, mins, maxs)


def test_incremental_fleet_on_the_card_equals_the_cpu(cuda_device):
    """A small incremental fleet under a tight row budget: both fleet lanes
    and both planner lanes on the card give the CPU run's traces and
    migration ledgers, and the planner launched its kernel."""
    from repro_torch.kernels.decision_fused import decision_fused
    from repro_torch.kernels.move_score import move_score
    rng = np.random.default_rng(4)
    tables = {f"t{t}": rng.uniform(0, 100, size=(4_000, 6)) for t in
              range(3)}
    lo = np.min([d.min(0) for d in tables.values()], axis=0)
    hi = np.max([d.max(0) for d in tables.values()], axis=0)
    stream = core.make_drift_scenario("sudden_shift", lo, hi, num_tenants=3,
                                      queries_per_tenant=90, seed=7)

    def fleet(dev, planner):
        engines = {}
        for tid, table in tables.items():
            data = torch.as_tensor(table, device=dev)
            cfg = core.OreoConfig(alpha=10.0, seed=2, delta=5, manager=core.
                                  LayoutManagerConfig(target_partitions=8,
                                                      window_size=60,
                                                      gen_every=30))
            engines[tid] = engine.LayoutEngine(engine.OreoPolicy(
                data, core.build_default_layout(0, data, 8),
                core.make_generator("qdtree"), cfg),
                engine.InMemoryBackend(data), delta=cfg.delta,
                incremental=True, rows_per_tick=150, reorg_compute=planner)
        return engine.FleetEngine(engines, engine.KConcurrentScheduler(1))

    def ledgers(f):
        return {tid: [(m.begun_at, m.completed_at, m.charges)
                      for m in f.tenant(tid).reorg_executor.migrations]
                for tid in stream.tenant_ids}
    cpu_fleet = fleet(torch.device("cpu"), "move_score")
    cpu = cpu_fleet.run(stream)
    assert cpu.num_reorgs > 0
    for planner, counter in (("move_score", move_score.move_scores),
                             ("decision_fused",
                              decision_fused.fused_decision)):
        for lane in ("fleet_scan", "decision_fused"):
            before = counter.launches
            f = fleet(cuda_device, planner)
            card = f.run_batched(stream, compute=lane)
            assert counter.launches > before
            for tid in stream.tenant_ids:
                a, b = card.per_tenant[tid], cpu.per_tenant[tid]
                assert np.array_equal(a.query_costs, b.query_costs)
                assert a.reorg_indices == b.reorg_indices
                assert np.array_equal(a.state_seq, b.state_seq)
            assert ledgers(f) == ledgers(cpu_fleet)
            assert (card.swaps_deferred, card.deferred_ticks,
                    card.scheduler_stats) == (cpu.swaps_deferred,
                                              cpu.deferred_ticks,
                                              cpu.scheduler_stats)


# ---------------------------------------------------------------------------
# Flash attention and the serving substrate
# ---------------------------------------------------------------------------

FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}   # atol = rtol


def flash_operands(seed, b, t, s, hq, hkv, dh, dtype, device, head_pad=0):
    rng = np.random.default_rng(seed)

    def draw(n, h):
        a = torch.as_tensor(rng.standard_normal((b, n, h + head_pad, dh),
                                                dtype=np.float32))
        return a.to(device=device, dtype=dtype)[:, :, :h]
    return draw(t, hq), draw(s, hkv), draw(s, hkv)


@pytest.mark.parametrize("dtype,route", [
    (torch.float32, "scalar"), (torch.bfloat16, "tensor_core"),
    (torch.bfloat16, "scalar")])
@pytest.mark.parametrize("b,t,s,hq,hkv,dh,kw,pad", [
    (2, 16, 16, 4, 2, 16, {}, 0),
    (2, 300, 300, 16, 8, 128, {}, 0),
    (1, 1000, 1000, 8, 1, 64, {}, 0),
    (2, 100, 230, 4, 2, 128, {"causal": False, "kv_valid_len": 150}, 0),
    (1, 128, 128, 4, 4, 128, {"prefix_len": 96}, 0),
    (2, 64, 128, 4, 2, 128, {"q_offset": 64}, 0),
    (2, 70, 70, 4, 2, 128, {"kv_valid_len": 0}, 0),
    (1, 90, 90, 4, 1, 256, {}, 0),
    (1, 65, 65, 6, 2, 80, {}, 3),
    (1, 33, 0, 2, 1, 32, {"causal": False}, 0),
    (1, 65, 65, 4, 4, 64, {}, 0),
    (1, 127, 127, 8, 2, 128, {}, 0),
    (2, 127, 127, 4, 2, 16, {"kv_valid_len": 100}, 0),
    (1, 512, 512, 16, 8, 128, {"prefix_len": 200}, 0),
    (1, 256, 256, 32, 4, 256, {}, 0),
    (1, 300, 300, 2, 2, 256, {}, 0),
])
def test_flash_attention_kernel_matches_plain(cuda_device, b, t, s, hq, hkv,
                                              dh, kw, pad, dtype, route):
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fref
    q, k, v = flash_operands(0, b, t, s, hq, hkv, dh, dtype, cuda_device,
                             pad)
    before = fa.flash_attention.launches
    on_route = fa.flash_attention.launches_by_route[route]
    got = fa.flash_attention(q, k, v, route=route, **kw)
    want = fref.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert fa.flash_attention.launches_by_route[route] == on_route + 1
    assert got.dtype == dtype and got.shape == (b, t, hq, dh)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if kw.get("kv_valid_len") == 0 or s == 0:
        assert not got.float().abs().max()


@pytest.mark.parametrize("dtype,dh,route", [
    (torch.bfloat16, 128, "tensor_core"), (torch.bfloat16, 24, "scalar"),
    (torch.float32, 128, "scalar")])
def test_flash_attention_chooses_its_route_from_the_operands(
        cuda_device, dtype, dh, route):
    from repro_torch.kernels.flash_attention import flash_attention as fa
    q, k, v = flash_operands(2, 1, 70, 70, 4, 2, dh, dtype, cuda_device)
    before = dict(fa.flash_attention.launches_by_route)
    fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    before[route] += 1
    assert fa.flash_attention.launches_by_route == before


@pytest.mark.parametrize("dtype,dh", [(torch.float32, 128),
                                      (torch.bfloat16, 24)])
def test_flash_attention_tensor_core_route_refuses_operands(cuda_device,
                                                            dtype, dh):
    """A route that cannot take the operands raises and launches
    nothing; no other route is tried."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    q, k, v = flash_operands(2, 1, 70, 70, 4, 2, dh, dtype, cuda_device)
    before = (fa.flash_attention.launches,
              dict(fa.flash_attention.launches_by_route))
    with pytest.raises(RuntimeError, match="tensor_core route"):
        fa.flash_attention(q, k, v, route="tensor_core")
    with pytest.raises(ValueError, match="route"):
        fa.flash_attention(q, k, v, route="mma")
    assert (fa.flash_attention.launches,
            fa.flash_attention.launches_by_route) == before


def test_flash_attention_refuses_what_the_kernel_cannot_take(cuda_device):
    from repro_torch.kernels.flash_attention import flash_attention as fa
    q, k, v = flash_operands(1, 1, 8, 8, 2, 1, 300, torch.float32,
                             cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, k, v)
    q, k, v = (x.double() for x in flash_operands(
        1, 1, 8, 8, 2, 1, 16, torch.float32, cuda_device))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(q, k, v)
    q, k, v = flash_operands(1, 1, 8, 8, 2, 1, 16, torch.float32,
                             cuda_device)
    with pytest.raises(ValueError, match="unit stride"):
        fa.flash_attention(q[..., ::2], k[..., ::2], v[..., ::2])
    with pytest.raises(ValueError, match="is on"):
        fa.flash_attention(q, k.cpu(), v)


def test_serving_on_the_card_equals_the_cpu(cuda_device):
    """qwen3's smoke model in float32 (TF32 off): greedy tokens and logits
    and the slot loop's tokens, card against CPU, with every prefill
    attention launching the kernel."""
    from repro_torch import convert, serve
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("qwen3-1.7b", smoke=True)
    model = build_model(cfg)
    assert model.device.type == "cuda"
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    card_params = model.init_params(gen)
    assert card_params.embed.is_cuda
    tree = _tree_of(card_params)
    params = {dev: convert.transformer_params(tree, cfg, dev, torch.float32)
              for dev in ("cuda", "cpu")}
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, (3, 20))
    out = {}
    for dev in ("cuda", "cpu"):
        m = build_model(cfg, dev)
        before = fa.flash_attention.launches
        toks = serve.greedy_generate(m, params[dev], prompt, steps=6)
        with torch.inference_mode():
            logits = m.forward(params[dev], {"tokens": prompt})
        rng = np.random.default_rng(2)
        batcher = serve.SlotBatcher(2)
        for rid in range(5):
            batcher.submit(serve.Request(rid, rng.integers(0, cfg.vocab, 8),
                                         max_new_tokens=4))
        pf, dc = serve.build_serve_fns(m, 32)
        serve.serve_requests(batcher, pf, dc, params[dev], 8, 32, m.device)
        out[dev] = (toks.cpu(), logits.cpu(),
                    [(r.request_id, r.generated) for r in batcher.completed],
                    fa.flash_attention.launches - before)
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], atol=1e-4,
                               rtol=1e-4)
    assert out["cuda"][2] == out["cpu"][2] and len(out["cuda"][2]) == 5
    assert out["cuda"][3] > 0 and out["cpu"][3] == 0


def _tree_of(params):
    """The reference-layout numpy tree of a port transformer."""
    def stack(get):
        return np.stack([get(b).float().cpu().numpy() for b in params.layers])
    attn = {n: stack(lambda b, n=n: getattr(b.attn, n))
            for n in ("wq", "wk", "wv", "wo", "q_norm", "k_norm")
            if getattr(params.layers[0].attn, n) is not None}
    mlp = {n: stack(lambda b, n=n: getattr(b.mlp, n))
           for n, _ in params.layers[0].mlp.named_parameters()}
    return {"embed": params.embed.float().cpu().numpy(),
            "layers": {"attn": attn, "mlp": mlp,
                       "ln1": stack(lambda b: b.ln1),
                       "ln2": stack(lambda b: b.ln2)},
            "final_norm": params.final_norm.float().cpu().numpy(),
            "head": params.head.float().cpu().numpy()}


# ---------------------------------------------------------------------------
# Z-order keys and the evaluation baselines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,bits,narrow", [
    (1_000_000, 3, 10, False),      # the bench shape
    (4097, 3, 8, True), (33, 4, 8, False), (1025, 4, 8, True),
    (500, 5, 6, True), (64, 1, 16, False), (1024, 2, 16, True),
    (77, 32, 1, False), (1, 3, 10, False)])
def test_zorder_kernel_matches_plain(cuda_device, n, m, bits, narrow):
    from repro_torch.kernels.zorder import ref as zref, zorder
    rng = np.random.default_rng(n + m + bits)
    vals = rng.uniform(-5, 5, (n, m)).astype(np.float32)
    lo, hi = vals.min(0), vals.max(0)
    if narrow:                      # values past both ends, one flat column
        lo, hi = lo + 1, hi - 1
        hi[0] = lo[0]
    args = [torch.as_tensor(a) for a in (vals, lo, hi)]
    before = zorder.zorder_keys.launches
    got = zorder.zorder_keys(*[a.to(cuda_device) for a in args], bits)
    torch.cuda.synchronize()
    assert zorder.zorder_keys.launches == before + 1
    assert torch.equal(got.cpu(), zref.zorder_keys(*args, bits))


@pytest.mark.parametrize("n,c,zcols,row_step", [
    (1_199_721, 32, (0, 4, 9), 1),  # the tpch-sf10-zorder sample
    (5000, 8, (3,), 1), (5000, 8, (1, 6), 1), (5000, 8, (0, 2, 7), 3),
    (4099, 8, (0, 3, 5, 6), 1), (4099, 8, (1, 2, 4, 5, 7), 2),
    (3000, 40, tuple(range(0, 40, 4)), 1), (1, 4, (2, 0), 1)])
def test_zorder64_kernel_matches_plain(cuda_device, n, c, zcols, row_step):
    from repro_torch.kernels.zorder import ref as zref, zorder
    rng = np.random.default_rng(n + c)
    table = rng.uniform(-50, 150, (n * row_step, c))
    cols = list(zcols)
    sub = table[: max(1, n // 3), cols]
    lo, hi = sub.min(0), sub.max(0)     # the rest of the rows lie outside
    if len(cols) > 1:
        hi[1] = lo[1]
    view = torch.as_tensor(table, device=cuda_device)[::row_step]
    before = zorder.zorder_keys64.launches
    got = zorder.zorder_keys64(view, cols,
                               torch.as_tensor(lo, device=cuda_device),
                               torch.as_tensor(hi, device=cuda_device))
    torch.cuda.synchronize()
    assert zorder.zorder_keys64.launches == before + 1
    want = zref.zorder_keys64(torch.as_tensor(table)[::row_step], cols,
                              torch.as_tensor(lo), torch.as_tensor(hi))
    assert torch.equal(got.cpu(), want)


def zorder_table(rng, n, c, zcols, layout, device):
    """A (n, c) float64 table in ``layout`` ("row", "col": column-major,
    "stride2": every other column of a table twice as wide) and lo/hi from
    its first third (the rest lies outside; one column flat)."""
    table = rng.uniform(-50, 150, (n, c))
    cols = list(zcols)
    sub = table[: max(1, n // 3), cols]
    lo, hi = sub.min(0), sub.max(0)
    if len(cols) > 1:
        hi[1] = lo[1]
    card = torch.as_tensor(table, device=device)
    if layout == "col":
        card = card.t().contiguous().t()
    elif layout == "stride2":
        wide = torch.zeros((n, 2 * c), dtype=torch.float64, device=device)
        wide[:, ::2] = card
        card = wide[:, ::2]
    return (torch.as_tensor(table), card, cols, torch.as_tensor(lo),
            torch.as_tensor(hi))


@pytest.mark.parametrize("layout", ["col", "stride2"])
@pytest.mark.parametrize("n,c,zcols", [
    (1_199_721, 32, (0, 4, 9)),     # the tpch-sf10-zorder sample
    (5000, 8, (3,)), (5000, 8, (1, 6)), (4099, 8, (0, 3, 5, 6)),
    (4099, 8, (1, 2, 4, 5, 7)), (1, 4, (2, 0))])
def test_zorder64_kernel_reads_any_strides(cuda_device, n, c, zcols, layout):
    from repro_torch.kernels.zorder import ref as zref, zorder
    rng = np.random.default_rng(n + c + len(layout))
    table, card, cols, lo, hi = zorder_table(rng, n, c, zcols, layout,
                                             cuda_device)
    before = zorder.zorder_keys64.launches
    got = zorder.zorder_keys64(card, cols, lo.to(cuda_device),
                               hi.to(cuda_device))
    torch.cuda.synchronize()
    assert zorder.zorder_keys64.launches == before + 1
    assert torch.equal(got.cpu(), zref.zorder_keys64(table, cols, lo, hi))


@pytest.mark.parametrize("n,c,zcols,k,layout", [
    (1_199_721, 32, (0, 4, 9), 32, "row"),   # the tpch-sf10-zorder sample
    (1_199_721, 32, (0, 4, 9), 32, "col"),
    (5000, 8, (0, 2, 7), 1, "row"), (5000, 8, (0, 2, 7), 2, "row"),
    (5000, 8, (1, 6), 16, "stride2"), (100_003, 8, (0, 3, 5), 1024, "row"),
    (20_000, 8, (1, 2, 4, 5), 4097, "row"),
    (4099, 8, (1, 2, 4, 5, 7), 32, "col"), (1, 4, (2, 0), 32, "row")])
def test_zorder_route_kernel_matches_plain(cuda_device, n, c, zcols, k,
                                           layout):
    """Key-quantile boundaries, so k - 1 rows' keys equal a boundary."""
    from repro_torch.kernels.zorder import ref as zref, zorder
    rng = np.random.default_rng(n + k)
    table, card, cols, lo, hi = zorder_table(rng, n, c, zcols, layout,
                                             cuda_device)
    keys = zref.zorder_keys64(table, cols, lo, hi)
    cut = np.minimum((np.arange(1, k) * n) // k, n - 1)
    bnd = torch.sort(keys).values[torch.as_tensor(cut, dtype=torch.int64)]
    if k > 1:
        assert torch.isin(keys, bnd).any()
    before = zorder.zorder_route64.launches
    got = zorder.zorder_route64(card, cols, lo.to(cuda_device),
                                hi.to(cuda_device), bnd.to(cuda_device), k)
    torch.cuda.synchronize()
    assert zorder.zorder_route64.launches == before + 1
    want = zref.zorder_route64(table, cols, lo, hi, bnd, k)
    assert torch.equal(got.cpu(), want)
    assert int(want.max()) <= k - 1


@pytest.mark.parametrize("zcols", [(4, 8, 29), (0, 3, 5), (5, 6, 7),
                                   (31,), (1, 9), (0, 8, 16, 24)])
def test_zorder64_every_row_path_matches_plain(cuda_device, zcols):
    """The kernel's three ways of taking rows (one row a thread, four, a
    warp tile), each forced, on a row-major 32-column table: keys and
    routes equal the plain versions."""
    import ctypes
    from repro_torch.kernels.zorder import ref as zref, zorder
    rng = np.random.default_rng(sum(zcols))
    n, k = 70_001, 32
    table, card, cols, lo, hi = zorder_table(rng, n, 32, zcols, "row",
                                             cuda_device)
    keys = zref.zorder_keys64(table, cols, lo, hi)
    cut = np.minimum((np.arange(1, k) * n) // k, n - 1)
    bnd = torch.sort(keys).values[torch.as_tensor(cut, dtype=torch.int64)]
    want = zref.zorder_route64(table, cols, lo, hi, bnd, k)
    lib = zorder._lib()
    m = len(cols)
    host_cols = (ctypes.c_int64 * m)(*cols)
    dlo, dhi, dbnd = (a.to(cuda_device) for a in (lo, hi, bnd))
    out = torch.empty(n, dtype=torch.int64, device=cuda_device)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    for path in (1, 2, 3):
        assert lib.zorder_keys64(card.data_ptr(), 32, 1,
                                 ctypes.addressof(host_cols), dlo.data_ptr(),
                                 dhi.data_ptr(), out.data_ptr(), n, m, path,
                                 stream) == 0
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), keys), path
        assert lib.zorder_route64(card.data_ptr(), 32, 1,
                                  ctypes.addressof(host_cols),
                                  dlo.data_ptr(), dhi.data_ptr(),
                                  dbnd.data_ptr(), k, out.data_ptr(), n, m,
                                  path, stream) == 0
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), want), path
    # The tile reads only unit column strides; an unknown path is refused.
    assert lib.zorder_keys64(card.data_ptr(), 32, 2,
                             ctypes.addressof(host_cols), dlo.data_ptr(),
                             dhi.data_ptr(), out.data_ptr(), n // 2, m, 3,
                             stream) != 0
    assert lib.zorder_keys64(card.data_ptr(), 32, 1,
                             ctypes.addressof(host_cols), dlo.data_ptr(),
                             dhi.data_ptr(), out.data_ptr(), n, m, 9,
                             stream) != 0


def test_zorder_refuses_cuda_operands_it_cannot_take(cuda_device):
    from repro_torch.kernels.zorder import ref as zref, zorder
    v = torch.zeros((8, 6), device=cuda_device)
    b3 = torch.zeros(3, device=cuda_device)
    with pytest.raises(ValueError):                    # strided values
        zorder.zorder_keys(v[:, ::2], b3, b3, 10)
    with pytest.raises(ValueError):                    # mixed devices
        zorder.zorder_keys(v[:, :3].contiguous(), b3.cpu(), b3, 10)
    t64 = torch.as_tensor(np.random.default_rng(6).uniform(0, 1, (8, 6)),
                          device=cuda_device)
    b2 = torch.zeros(2, dtype=torch.float64, device=cuda_device)
    # A column stride of 2 is read in place, as the plain version reads it.
    assert torch.equal(
        zorder.zorder_keys64(t64[:, ::2], [0, 1], b2, b2 + 1).cpu(),
        zref.zorder_keys64(t64[:, ::2].cpu(), [0, 1], b2.cpu(),
                           b2.cpu() + 1))
    assert zorder._lib().zorder_max_parts() == zorder.MAX_PARTS
    big = zorder.MAX_PARTS + 1
    with pytest.raises(ValueError, match="partitions"):
        zorder.zorder_route64(t64, [0, 1], b2, b2,
                              torch.zeros(big - 1, dtype=torch.int64,
                                          device=cuda_device), big)
    with pytest.raises(ValueError):                    # mixed devices
        zorder.zorder_route64(t64, [0, 1], b2, b2,
                              torch.zeros(2, dtype=torch.int64), 3)
    with pytest.raises(ValueError, match="contiguous"):
        zorder.zorder_route64(t64, [0, 1], b2, b2,
                              torch.zeros(4, dtype=torch.int64,
                                          device=cuda_device)[::2], 3)
    with pytest.raises(ValueError, match="columns"):
        zorder.zorder_keys64(torch.zeros((2, 40), dtype=torch.float64,
                                         device=cuda_device), range(33),
                             torch.zeros(33, dtype=torch.float64,
                                         device=cuda_device),
                             torch.zeros(33, dtype=torch.float64,
                                         device=cuda_device))


def test_zorder_methods_on_the_card_equal_the_cpu(cuda_device):
    """The six methods of comparison under the Z-order generator: the card
    runs the kernel (every build and materialization) and gives the CPU's
    traces; the layouts equal the CPU's."""
    from repro_torch.kernels.zorder import zorder
    rng = np.random.default_rng(0)
    table = rng.uniform(0, 100, size=(20_000, 8))
    templates = core.make_templates(4, 8, rng)
    stream = core.generate_workload(templates, table.min(0), table.max(0),
                                    total_queries=900, seed=1,
                                    segment_length=(200, 300))
    gen = core.make_generator("zorder")
    card = torch.as_tensor(table, device=cuda_device)
    cpu = torch.as_tensor(table)
    a, b = gen(3, card, stream.queries[:200], 16), gen(
        3, cpu, stream.queries[:200], 16)
    assert a.name == b.name and a.info == b.info
    assert torch.equal(a.route.boundaries.cpu(), b.route.boundaries)
    assert torch.equal(a.meta.mins.cpu(), b.meta.mins)
    assert torch.equal(a.route(card).cpu(), b.route(cpu))

    def policies(data):
        init = core.build_default_layout
        mgr = core.LayoutManagerConfig(target_partitions=16)
        return {
            "Static": engine.StaticPolicy(data, stream, gen, 40.0, 16),
            "Greedy": engine.GreedyPolicy(data, init(0, data, 16), gen,
                                          40.0, mgr_cfg=mgr),
            "Regret": engine.RegretPolicy(data, init(0, data, 16), gen,
                                          40.0, mgr_cfg=mgr),
            "OREO": engine.OreoPolicy(data, init(0, data, 16), gen,
                                      core.OreoConfig(alpha=40.0,
                                                      manager=mgr)),
            "MTS Optimal": engine.MTSOptimalPolicy(data, stream, gen, 40.0,
                                                   16),
            "Offline Optimal": engine.OfflineOptimalPolicy(data, stream, gen,
                                                           40.0, 16)}
    traces = {}
    for data in (card, cpu):
        before = (zorder.zorder_keys64.launches,
                  zorder.zorder_route64.launches)
        for name, policy in policies(data).items():
            res = engine.LayoutEngine(policy, engine.InMemoryBackend(data)
                                      ).run(stream)
            traces[data.device.type, name] = res
        if data.is_cuda:
            assert zorder.zorder_keys64.launches > before[0]
            assert zorder.zorder_route64.launches > before[1]
    for name in ("Static", "Greedy", "Regret", "OREO", "MTS Optimal",
                 "Offline Optimal"):
        x, y = traces["cuda", name], traces["cpu", name]
        assert np.array_equal(x.query_costs, y.query_costs), name
        assert x.reorg_indices == y.reorg_indices
        assert np.array_equal(x.state_seq, y.state_seq)


# ---------------------------------------------------------------------------
# The streaming ingest plane
# ---------------------------------------------------------------------------

def test_ingest_delta_log_on_the_card_equals_the_cpu(cuda_device):
    """DeltaLog.compose and source_assignment on the card give the CPU's
    zone maps, row counts and assignment bitwise; with no batches compose
    returns the base itself."""
    from repro_torch.engine.ingest import DeltaLog
    rng = np.random.default_rng(40)
    data = rng.uniform(0, 100, size=(3_000, 6))
    batches = [rng.uniform(0, 100, size=(n, 6)) for n in (40, 1, 300, 77)]
    out = []
    for dev in (torch.device("cpu"), cuda_device):
        table = torch.as_tensor(data, device=dev)
        layout = core.build_default_layout(0, table, 16, sort_col=0)
        base = layout.materialize(table)
        log = DeltaLog(len(data))
        assert log.compose(base) is base
        start = len(data)
        for rows in batches:
            log.append(torch.as_tensor(rows, device=dev), start)
            start += len(rows)
        composed = log.compose(base)
        assign = log.source_assignment(layout.route(table).to(torch.int64),
                                       base.num_partitions, start)
        assert composed.device.type == dev.type and assign.device.type \
            == dev.type
        out.append((composed.mins.cpu(), composed.maxs.cpu(),
                    composed.rows_host, assign.cpu()))
    cpu, card = out
    assert torch.equal(card[0], cpu[0]) and torch.equal(card[1], cpu[1])
    assert np.array_equal(card[2], cpu[2]) and torch.equal(card[3], cpu[3])
    assert torch.equal(cpu[0][16:], torch.as_tensor(np.stack(
        [b.min(0) for b in batches])))


def delta_plane(rng, b, t, s, p, c):
    """A fleet pass over delta-bearing planes: the first 16 partitions of
    every state clustered, the rest delta partitions whose bounds span
    nearly the whole domain (one append each), the padded last state's
    tail empty."""
    lo, hi, mins, maxs, rows, inv, *_ = plane_operands(rng, b, t, s, p, c)
    if p > 16:
        wide = rng.uniform(0, 3, (t, s, p - 16, c))
        mins[:, :, 16:] = wide
        maxs[:, :, 16:] = 100 - wide
    return lo, hi, mins, maxs, rows, inv


@pytest.mark.parametrize("t,s,p", [
    (16, 8, 17),          # one pending delta partition
    (16, 8, 80),          # 64 deltas
    (16, 8, 141),         # mixed_rw's 125 deltas: S * P past one tile
    (32, 12, 256),        # the fleet plane's P_cap after 125 appends
])
def test_ingest_widened_planes_match_plain(cuda_device, t, s, p):
    """pruning, fleet_scan and decision_fused at plane shapes that only
    delta partitions produce equal their plain versions bitwise."""
    from repro_torch.kernels.decision_fused import decision_fused
    from repro_torch.kernels.decision_fused import ref as dref
    from repro_torch.kernels.fleet_scan import fleet_scan
    from repro_torch.kernels.fleet_scan import ref as fref
    rng = np.random.default_rng(t + s + p)
    lo, hi, mins, maxs, rows, inv = delta_plane(rng, 16, t, s, p, 8)
    dev = [torch.as_tensor(a, device=cuda_device)
           for a in (lo, hi, mins, maxs, rows, inv)]
    host = [torch.as_tensor(a) for a in (lo, hi, mins, maxs, rows, inv)]
    for path in (0, 1, 2):
        scan, cost, _ = decision_fused.fused_decision(*dev, path=path)
        w_scan, w_cost, _ = dref.fused_decision(*host)
        assert torch.equal(scan.cpu(), w_scan)
        assert torch.allclose(cost.cpu(), w_cost, rtol=1e-12, atol=0)
        for k in (0, 15):
            got = fleet_scan.scan_fleet(dev[0][k], dev[1][k],
                                        dev[2].flatten(1, 2),
                                        dev[3].flatten(1, 2), path=path)
            want = fref.scan_fleet(host[0][k], host[1][k],
                                   host[2].flatten(1, 2),
                                   host[3].flatten(1, 2))
            assert torch.equal(got.cpu(), want)
    # one tenant's StateMatrix plane: a block of run's estimates, a step's
    # estimate and a serve over the shadow alone
    flat_min, flat_max = dev[2][0].flatten(0, 1), dev[3][0].flatten(0, 1)
    q_lo, q_hi, _, _ = operands(rng, 256, 1, 8)
    ops = [torch.as_tensor(a, device=cuda_device) for a in (q_lo, q_hi)]
    for path in (0, 1, 2):
        for q, pm, px in ((256, flat_min, flat_max), (1, flat_min, flat_max),
                          (1, dev[2][0, 0], dev[3][0, 0])):
            got = pruning.scan_matrix(ops[0][:q], ops[1][:q], pm, px,
                                      path=path)
            want = ref.scan_matrix(ops[0][:q].cpu(), ops[1][:q].cpu(),
                                   pm.cpu(), px.cpu())
            assert torch.equal(got.cpu(), want)


def test_ingest_mixed_rw_fleet_on_the_card_equals_the_cpu(cuda_device):
    """A short mixed_rw fleet (appends, a drift shift, debt-triggered
    compactions): ``run`` and ``run_batched`` on both lanes on the card
    give the CPU run's traces, compaction indices and ingest counters
    bitwise, and the appended rows live on the card."""
    from repro_torch.kernels.decision_fused import decision_fused
    rng = np.random.default_rng(41)
    tables = {f"t{t}": rng.uniform(0, 100, size=(4_000, 6)) for t in
              range(2)}
    lo = np.min([d.min(0) for d in tables.values()], axis=0)
    hi = np.max([d.max(0) for d in tables.values()], axis=0)
    stream = core.make_ingest_scenario("mixed_rw", lo, hi, num_tenants=2,
                                       queries_per_tenant=160, seed=7,
                                       batch_rows=60)

    def fleet(dev):
        engines = {}
        for tid, table in tables.items():
            data = torch.as_tensor(table, device=dev)
            cfg = core.OreoConfig(alpha=2.0, seed=0, delta=5, manager=core.
                                  LayoutManagerConfig(target_partitions=8,
                                                      window_size=60,
                                                      gen_every=30))
            engines[tid] = engine.LayoutEngine(engine.OreoPolicy(
                data, core.build_default_layout(0, data, 8, sort_col=0),
                core.make_generator("qdtree"), cfg),
                engine.InMemoryBackend(data), delta=cfg.delta,
                ingest=engine.IngestConfig())
        return engine.FleetEngine(engines, engine.UnlimitedScheduler())

    def trace(f, res):
        return {tid: (res.per_tenant[tid].query_costs.tobytes(),
                      res.per_tenant[tid].reorg_indices,
                      res.per_tenant[tid].state_seq.tobytes(),
                      f.tenant(tid).compaction_indices,
                      f.tenant(tid).ingest_stats())
                for tid in f.tenant_ids}
    cpu_fleet = fleet(torch.device("cpu"))
    want = trace(cpu_fleet, cpu_fleet.run(stream))
    assert any(w[3] for w in want.values())          # it compacted
    for mode in ("run", "fleet_scan", "decision_fused"):
        before = (pruning.scan_matrix.launches,
                  decision_fused.fused_decision.launches)
        f = fleet(cuda_device)
        res = f.run(stream) if mode == "run" else f.run_batched(
            stream, compute=mode)
        assert trace(f, res) == want, mode
        assert pruning.scan_matrix.launches > before[0]
        if mode == "decision_fused":
            assert decision_fused.fused_decision.launches > before[1]
        for tid in f.tenant_ids:
            data = f.tenant(tid).backend.data
            assert data.is_cuda and len(data) == 4_000 + sum(
                b.num_rows for b in stream.tenant_batches(tid))


@pytest.mark.parametrize("scenario", ["sudden_shift", "gradual_drift",
                                      "cyclic_diurnal", "flash_crowd",
                                      "template_churn"])
def test_ingest_enabled_but_unused_changes_no_trace_or_launch(cuda_device,
                                                              scenario):
    """``ingest=IngestConfig()`` with no appends: under every scheduler,
    ``run`` and ``run_batched`` on both lanes give the traces, deferrals
    and per-kernel launch counts of the same fleet without ingest."""
    from repro_torch.kernels.decision_fused import decision_fused
    from repro_torch.kernels.fleet_scan import fleet_scan
    counters = (pruning.scan_matrix, fleet_scan.scan_fleet,
                decision_fused.fused_decision)
    rng = np.random.default_rng(42)
    tables = {f"t{t}": torch.as_tensor(rng.uniform(0, 100, size=(2_000, 5)),
                                       device=cuda_device) for t in range(2)}
    lo = np.min([d.amin(0).cpu().numpy() for d in tables.values()], axis=0)
    hi = np.max([d.amax(0).cpu().numpy() for d in tables.values()], axis=0)
    stream = core.make_drift_scenario(scenario, lo, hi, num_tenants=2,
                                      queries_per_tenant=80, seed=7)
    schedulers = {"unlimited": engine.UnlimitedScheduler,
                  "k1": lambda: engine.KConcurrentScheduler(1),
                  "bucket": lambda: engine.TokenBucketScheduler(
                      rate=0.01, capacity=1.0, initial=0.0)}

    def run(sched, mode, ingest):
        engines = {}
        for tid, data in tables.items():
            cfg = core.OreoConfig(alpha=10.0, seed=2, delta=5, manager=core.
                                  LayoutManagerConfig(target_partitions=8,
                                                      window_size=60,
                                                      gen_every=30))
            engines[tid] = engine.LayoutEngine(engine.OreoPolicy(
                data, core.build_default_layout(0, data, 8),
                core.make_generator("qdtree"), cfg),
                engine.InMemoryBackend(data), delta=cfg.delta,
                ingest=engine.IngestConfig() if ingest else None)
        f = engine.FleetEngine(engines, schedulers[sched]())
        before = [c.launches for c in counters]
        res = f.run(stream) if mode == "run" else f.run_batched(
            stream, compute=mode)
        return ({tid: (r.query_costs.tobytes(), r.reorg_indices,
                       r.state_seq.tobytes())
                 for tid, r in res.per_tenant.items()},
                res.swaps_deferred, res.deferred_ticks,
                [c.launches - b for c, b in zip(counters, before)])
    for sched in schedulers:
        for mode in ("run", "fleet_scan", "decision_fused"):
            assert run(sched, mode, True) == run(sched, mode, False), \
                (sched, mode)


# ---------------------------------------------------------------------------
# The reference compute mode, the routing plane and the serving front end
# ---------------------------------------------------------------------------

def router_tenants(device, incremental=False, compute="state_matrix", n=4):
    engines = {}
    for t in range(n):
        data = torch.as_tensor(np.random.default_rng(700 + t).uniform(
            0, 100, size=(2_000, 5)), device=device)
        cfg = core.OreoConfig(alpha=10.0, seed=2, delta=5, manager=core.
                              LayoutManagerConfig(target_partitions=8,
                                                  window_size=60,
                                                  gen_every=30))
        engines[f"t{t}"] = engine.LayoutEngine(engine.OreoPolicy(
            data, core.build_default_layout(0, data, 8),
            core.make_generator("qdtree"), cfg),
            engine.InMemoryBackend(data, compute=compute), delta=cfg.delta,
            incremental=incremental,
            rows_per_tick=60 if incremental else None)
    return engines


def tenant_traces(res):
    return {tid: (r.query_costs.tobytes(), tuple(r.reorg_indices),
                  r.state_seq.tobytes()) for tid, r in res.per_tenant.items()}


def router_stream(n=4, qpt=100, seed=11):
    return core.make_drift_scenario("sudden_shift", np.zeros(5),
                                    np.full(5, 100.0), num_tenants=n,
                                    queries_per_tenant=qpt, seed=seed)


def test_reference_mode_on_the_card_equals_default_and_cpu(cuda_device):
    stream = router_stream()
    before = pruning.scan_matrix.launches
    got = {}
    for dev in (cuda_device, torch.device("cpu")):
        for compute_mode in ("state_matrix", "reference"):
            fleet = engine.FleetEngine(router_tenants(
                dev, compute=compute_mode))
            got[dev.type, compute_mode] = tenant_traces(fleet.run(stream))
    assert len(set(map(str, got.values()))) == 1
    assert pruning.scan_matrix.launches > before
    backend = engine.InMemoryBackend(torch.zeros(4, 2, dtype=torch.float64,
                                                 device=cuda_device),
                                     compute="reference")
    assert backend.state_matrix is None and not backend.supports_incremental


@pytest.mark.parametrize("lane", ["fleet_scan", "decision_fused"])
def test_router_migration_on_the_card_equals_the_cpu(cuda_device, lane):
    """Incremental tenants migrated between 2 shards mid-stream on a
    batched lane: traces and ledgers equal the CPU's and the unsharded
    fleet's; the lane's kernel and move_score launch."""
    from repro_torch.kernels.move_score import move_score
    stream = router_stream()
    events = list(stream)
    got = {}
    for dev in (cuda_device, torch.device("cpu")):
        ref = engine.FleetEngine(router_tenants(dev, incremental=True))
        want = tenant_traces(ref.run(stream))
        router = engine.FleetRouter(router_tenants(dev, incremental=True),
                                    num_shards=2)
        before = move_score.move_scores.launches
        third = len(events) // 3
        for ev in events[:third]:
            router.submit(ev)
        router.drain(batched=True, compute=lane)
        for tid in stream.tenant_ids:
            src = router.shard_of(tid)
            router.migrate_tenant(tid, next(s for s in router.shard_ids
                                            if s != src))
        for ev in events[third:]:
            router.submit(ev)
        router.drain(batched=True, compute=lane)
        got[dev.type] = (tenant_traces(router.result()), {
            tid: [m.charges for m in router.tenant(
                tid).reorg_executor.migrations] for tid in stream.tenant_ids})
        assert got[dev.type][0] == want
        if dev.type == "cuda":
            assert move_score.move_scores.launches > before
    assert got["cuda"] == got["cpu"]


def test_frontend_overload_on_the_card_equals_the_cpu(cuda_device):
    from repro_torch import serve
    stream = router_stream(qpt=120)
    got = {}
    for dev in (cuda_device, torch.device("cpu")):
        router = engine.FleetRouter(router_tenants(dev), num_shards=2,
                                    scheduler=engine.SchedulerSpec
                                    .k_concurrent(1))
        fe = serve.ServeFrontend(router, serve.FrontendConfig(
            queue_capacity=48, breaker_open_frac=0.5, breaker_close_frac=0.1,
            breaker_min_open_events=16, pump_chunk=4, record_latency=False))
        res = fe.run(stream)
        got[dev.type] = (tenant_traces(res), fe.stats())
    assert got["cuda"] == got["cpu"]
    assert got["cuda"][1]["breaker"]["opens"] >= 1
    assert got["cuda"][1]["cache"]["hits"] + got["cuda"][1]["cache"][
        "misses"] > 0


def test_process_shards_on_the_card_leave_the_parent_without_cuda(
        cuda_device):
    """A ProcessShardSet whose workers build their tenants on the card,
    run from a fresh interpreter: a migration crosses as a file, the traces
    equal the inline router's on the card, and that parent never
    initializes CUDA."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    child = f"""
import functools, json, sys
sys.path.insert(0, {str(root)!r}); sys.path.insert(0, {str(root / 'src')!r})
import numpy as np, torch
import chip_smoke
from repro_torch import core
from repro_torch.launch import shard_host
stream = core.make_drift_scenario("sudden_shift", np.zeros(8),
    np.full(8, 100.0), num_tenants=4, queries_per_tenant=60, seed=7)
facs = {{f"t{{t}}": functools.partial(chip_smoke.fleet16_tenant, t, 20000)
        for t in range(4)}}
with shard_host.ProcessShardSet(facs, num_shards=2) as procs:
    for ev in list(stream)[:120]:
        procs.submit(ev)
    procs.drain(batched=True)
    tid = "t0"
    dst = next(s for s in procs.shard_ids if s != procs.shard_of(tid))
    procs.migrate_tenant(tid, dst)
    for ev in list(stream)[120:]:
        procs.submit(ev)
    procs.drain(batched=True)
    res = procs.result()
    mem = [procs.host(s).max_memory_allocated() for s in procs.shard_ids]
print(json.dumps({{"init": torch.cuda.is_initialized(), "mem": mem,
    "dst": dst, "traces": {{t: r.query_costs.tolist()
                            for t, r in res.per_tenant.items()}}}}))
"""
    proc = subprocess.run([sys.executable, "-c", child], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["init"] is False and all(m > 0 for m in out["mem"])
    sys.path.insert(0, str(root))
    import chip_smoke
    stream = core.make_drift_scenario("sudden_shift", np.zeros(8),
                                      np.full(8, 100.0), num_tenants=4,
                                      queries_per_tenant=60, seed=7)
    router = engine.FleetRouter({f"t{t}": chip_smoke.fleet16_tenant(
        t, 20000, cuda_device) for t in range(4)}, num_shards=2)
    events = list(stream)
    for ev in events[:120]:
        router.submit(ev)
    router.drain(batched=True)
    router.migrate_tenant("t0", out["dst"])
    for ev in events[120:]:
        router.submit(ev)
    router.drain(batched=True)
    want = {t: r.query_costs.tolist()
            for t, r in router.result().per_tenant.items()}
    assert out["traces"] == want
