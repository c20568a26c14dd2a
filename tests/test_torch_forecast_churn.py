"""Grower-driven state churn on the port's planes, held against the JAX
package's, on the CPU.

The cases of ``tests/test_forecast_churn.py``, on the port's own plane
tensors (it keeps no transposed twins): ``StateMatrix.deregister`` wipes
the vacated tail slot back to identity fills (``+inf`` mins, ``-inf``
maxs, zero rows, totals 1), and a ``FleetMatrix`` follows random
register/deregister churn slot for slot, identity-filled past each
tenant's live states and past each state's partitions -- the rows
``decision_fused``'s tile would otherwise scan.  Both planes also equal
``repro``'s after the same churn.  Then fleets whose
:class:`ForecastPolicy` grows and retires qd-tree states mid-stream:
``run_batched`` on both of the port's lanes equals ``run`` (a
registration inside ``decide`` bumps the plane version, and the primed
pass must fall back to the exact path), and ``run`` equals ``repro``'s,
over the five drift scenarios x three schedulers.  ``repro``'s traces are
computed once per scenario and scheduler.
"""
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.engine as re_
import repro.forecast as rf
from repro.core import layout_manager as rlm

import repro_torch.core as tc
import repro_torch.engine as te
import repro_torch.forecast as tf
from repro_torch.core import layout_manager as tlm
from test_torch_fleet import assert_same_plane

PKGS = {"ref": (rc, re_, rlm, rf), "port": (tc, te, tlm, tf)}
LANES = ("decision_fused", "fleet_scan")
ALL_SCENARIOS = ["sudden_shift", "gradual_drift", "cyclic_diurnal",
                 "flash_crowd", "template_churn"]
SCHEDULERS = {
    "unlimited": lambda eng: eng.UnlimitedScheduler(),
    "k1": lambda eng: eng.KConcurrentScheduler(1),
    "bucket": lambda eng: eng.TokenBucketScheduler(rate=0.01, capacity=1.0,
                                                   initial=0.0),
}


def table(pkg, data):
    return torch.as_tensor(data) if pkg == "port" else data


def make_meta(pkg, data, partitions, rows_per):
    assignment = np.repeat(np.arange(partitions), rows_per)
    if pkg == "ref":
        return rc.layouts.metadata_from_assignment(data, assignment,
                                                   partitions)
    return tc.layouts.metadata_from_assignment(
        torch.as_tensor(data), torch.as_tensor(assignment), partitions)


def new_plane(pkg):
    return re_.StateMatrix() if pkg == "ref" else te.StateMatrix("cpu")


def draw_meta(rng, partitions, columns, rows_per=40):
    """One state's numpy rows, drawn as the reference test draws them."""
    return (rng.uniform(0, 100, size=(partitions * rows_per, columns)),
            partitions, rows_per)


# ---------------------------------------------------------------------------
# StateMatrix slot hygiene under deregistration
# ---------------------------------------------------------------------------

def test_deregister_wipes_vacated_slot():
    rng = np.random.default_rng(0)
    drawn = [(sid, draw_meta(rng, p, 3)) for sid, p in [(1, 4), (2, 8),
                                                         (3, 6)]]
    sms = {}
    for pkg in PKGS:
        sm = new_plane(pkg)
        for sid, args in drawn:
            sm.register(sid, make_meta(pkg, *args))
        sm.deregister(2)                  # 3 swaps into slot 1
        sms[pkg] = sm
    sm, ref = sms["port"], sms["ref"]
    vac = len(sm)
    mins, maxs = sm._mins[vac].numpy(), sm._maxs[vac].numpy()
    assert np.all(np.isinf(mins)) and np.all(mins > 0)
    assert np.all(np.isinf(maxs)) and np.all(maxs < 0)
    assert np.all(sm._rows[vac] == 0.0)
    assert np.all(sm._totals_arr[vac] == 1.0)
    # the whole plane, live slots and the wiped tail, equals the reference's
    assert sm.state_ids == ref.state_ids and sm.version == ref.version
    assert np.array_equal(sm._mins.numpy(), ref._mins)
    assert np.array_equal(sm._maxs.numpy(), ref._maxs)
    assert np.array_equal(sm._rows, ref._rows)
    assert np.array_equal(sm._totals_arr, ref._totals_arr)


def test_fleet_mirror_tracks_random_register_deregister_churn():
    rng = np.random.default_rng(7)
    fleets, planes = {}, {}
    for pkg in PKGS:
        fleets[pkg] = (re_.FleetMatrix() if pkg == "ref"
                       else te.FleetMatrix(device="cpu"))
        planes[pkg] = {tid: new_plane(pkg) for tid in ("a", "b", "c")}
        for tid, sm in planes[pkg].items():
            fleets[pkg].attach(tid, sm)
    next_sid = 0
    for _ in range(200):
        tid = ("a", "b", "c")[int(rng.integers(3))]
        n = len(planes["ref"][tid])
        if n and rng.uniform() < 0.4:
            sid = planes["ref"][tid].state_ids[int(rng.integers(n))]
            for pkg in PKGS:
                planes[pkg][tid].deregister(sid)
        else:
            args = draw_meta(rng, int(rng.integers(2, 9)), 3)
            for pkg in PKGS:
                planes[pkg][tid].register(next_sid, make_meta(pkg, *args))
            next_sid += 1
    fm = fleets["port"]
    for tid, sm in planes["port"].items():
        assert fm.state_ids(tid) == sm.state_ids
        row = fm.tenant_row(tid)
        for sid in sm.state_ids:
            slot = sm.slot(sid)
            assert fm.slot(tid, sid) == slot
            meta = sm.metadata(sid)
            p = meta.num_partitions
            assert torch.equal(fm._mins[row, slot, :p], meta.mins)
            assert torch.equal(fm._maxs[row, slot, :p], meta.maxs)
            assert np.array_equal(fm._rows[row, slot, :p], meta.rows_host)
            assert torch.all(torch.isinf(fm._mins[row, slot, p:]))
            assert torch.all(fm._maxs[row, slot, p:] == -np.inf)
            assert np.all(fm._rows[row, slot, p:] == 0.0)
        # slots past the live count are identity-filled in the mirror too
        assert torch.all(fm._mins[row, len(sm):] == np.inf)
        assert torch.all(fm._maxs[row, len(sm):] == -np.inf)
        assert np.all(fm._rows[row, len(sm):] == 0.0)
        assert np.all(fm._totals[row, len(sm):] == 1.0)
    assert_same_plane(fm, fleets["ref"])


# ---------------------------------------------------------------------------
# Golden loop vs batched traces with mid-stream growth + retirement
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tenant_data():
    return {f"t{t}": np.random.default_rng(100 + t).uniform(
        0, 100, size=(3_000, 6)) for t in range(3)}


@pytest.fixture(scope="module")
def bounds(tenant_data):
    lo = np.min([d.min(0) for d in tenant_data.values()], axis=0)
    hi = np.max([d.max(0) for d in tenant_data.values()], axis=0)
    return lo, hi


def forecast_engine(pkg, data, alpha=10.0, delta=5, seed=2):
    """The reference test's eager grower: lax admission, period forecasts
    eligible, one-deep grown pool, a short retirement window."""
    core, eng, lm, fc = PKGS[pkg]
    data = table(pkg, data)
    cfg = core.OreoConfig(alpha=alpha, seed=seed, delta=delta,
                          manager=lm.LayoutManagerConfig(target_partitions=8,
                                                         window_size=60,
                                                         gen_every=30))
    inner = eng.OreoPolicy(data, core.build_default_layout(0, data, 8),
                           core.make_generator("qdtree"), cfg)
    config = fc.ForecastConfig(grow=True, max_grown=1, grow_retire_after=30,
                               grow_sources=("period", "trend",
                                             "adversarial"))
    grower = fc.QdTreeGrower(data, 8, min_queries=4, gain=0.0,
                             cost_floor=0.0, alpha=0.0, seed=seed + 101)
    policy = fc.ForecastPolicy(inner, config=config, grower=grower)
    return eng.LayoutEngine(policy, eng.InMemoryBackend(data),
                            delta=cfg.delta)


def fleet_trace(fs, res):
    per = tuple((res.per_tenant[t].query_costs.tobytes(),
                 tuple(res.per_tenant[t].reorg_indices),
                 res.per_tenant[t].state_seq.tobytes(),
                 res.per_tenant[t].info.get("grown_admitted"),
                 res.per_tenant[t].info.get("prepositions"),
                 res.per_tenant[t].info)
                for t in fs.tenant_ids)
    return per, res.ticks, res.swaps_deferred, res.deferred_ticks, \
        res.scheduler_stats


class Loops:
    """``run`` once per package, scenario and scheduler (memoized)."""

    def __init__(self, tenant_data, bounds):
        self.tenant_data, self.bounds, self._memo = tenant_data, bounds, {}

    def stream(self, pkg, scenario):
        lo, hi = self.bounds
        return PKGS[pkg][0].make_drift_scenario(
            scenario, lo, hi, num_tenants=3, queries_per_tenant=120, seed=7)

    def fleet(self, pkg, fs, sched):
        eng = PKGS[pkg][1]
        return eng.FleetEngine({tid: forecast_engine(pkg,
                                                     self.tenant_data[tid])
                                for tid in fs.tenant_ids},
                               SCHEDULERS[sched](eng))

    def run(self, pkg, scenario, sched):
        key = (pkg, scenario, sched)
        if key not in self._memo:
            fs = self.stream(pkg, scenario)
            fleet = self.fleet(pkg, fs, sched)
            self._memo[key] = (fs, fleet, fleet_trace(fs, fleet.run(fs)))
        return self._memo[key]


@pytest.fixture(scope="module")
def loops(tenant_data, bounds):
    return Loops(tenant_data, bounds)


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("scenario", ALL_SCENARIOS)
def test_grower_churn_batched_bit_identical_to_loop(scenario, lane, loops):
    for sched in SCHEDULERS:
        _, _, want = loops.run("ref", scenario, sched)
        fs, _, got = loops.run("port", scenario, sched)
        assert got == want, sched
        batched = loops.fleet("port", fs, sched)
        assert fleet_trace(fs, batched.run_batched(fs, compute=lane)) \
            == got, sched


def test_grower_churn_actually_churns(loops):
    for pkg in PKGS:
        fs, fleet, (per, *_) = loops.run(pkg, "cyclic_diurnal", "unlimited")
        admitted = sum(p[3] for p in per)
        assert admitted > 0
        live = sum(len(PKGS[pkg][3].grown_ids(
            fleet.tenant(t).policy.inner.dumts.states))
            for t in fs.tenant_ids)
        assert live < admitted
