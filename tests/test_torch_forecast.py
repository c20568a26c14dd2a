"""The port's forecast plane held against the JAX package's, on the CPU.

Every case of ``tests/test_forecast.py`` runs here on both packages from
the same seeded numpy inputs, and the port must pass the reference's own
assertions and equal ``repro`` bit for bit: forecast keys, sources,
confidences, leads, dwell and samples; the grower's admissions, ids and
zone maps; and, for :class:`ForecastPolicy`, ``query_costs``,
``reorg_indices``, ``state_seq``, ``info()``, the D-UMTS event ledger and
every ``MigrationRecord`` (its ``charges`` included).  Beyond the mirror:
the grower holds the manager's table itself (one storage through a
pickle), the adversarial mirror stays finite on one-sided predicates, a
growing policy's grown ids equal the reference's, and the lazy
``ForecastPolicy`` re-export works in either import order.
"""
import pickle
import subprocess
import sys
from pathlib import Path

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

PKGS = {"ref": (rc, re_, rlm, rf), "port": (tc, te, tlm, tf)}
COLS = 6


def table(pkg, data):
    return torch.as_tensor(data) if pkg == "port" else data


def host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def make_query(pkg, template_id, col, lo_v, hi_v, cols=COLS):
    lo = np.full(cols, -np.inf)
    hi = np.full(cols, np.inf)
    lo[col], hi[col] = lo_v, hi_v
    return PKGS[pkg][0].workload.Query(lo=lo, hi=hi, template_id=template_id)


def fc_fields(pkg, fc):
    """Everything of a Forecast that must be equal across the packages."""
    if fc is None:
        return None
    lo, hi = PKGS[pkg][0].stack_queries(fc.queries)
    return (fc.key, fc.source, fc.confidence, fc.dwell, fc.lead,
            lo.tobytes(), hi.tobytes(),
            tuple(q.template_id for q in fc.queries))


def both(fn):
    """``fn(pkg)`` on both packages; the results must be equal."""
    ref, port = fn("ref"), fn("port")
    assert port == ref
    return port


# ---------------------------------------------------------------------------
# template_key
# ---------------------------------------------------------------------------

def test_template_key_uses_ground_truth_template_id():
    key = both(lambda p: PKGS[p][3].template_key(make_query(p, 3, 0, 1., 2.)))
    assert key == ("tpl", 3)


def test_template_key_falls_back_to_predicate_columns():
    def keys(pkg):
        q = make_query(pkg, -1, 1, 0.0, 5.0)
        q.lo[4] = 3.0                    # one-sided predicate still counts
        return (PKGS[pkg][3].template_key(make_query(pkg, -1, 2, 1.0, 2.0)),
                PKGS[pkg][3].template_key(q))
    assert both(keys) == (("cols", 2), ("cols", 1, 4))


# ---------------------------------------------------------------------------
# PeriodDetector
# ---------------------------------------------------------------------------

def detect(codes, **kw):
    return both(lambda p: PKGS[p][3].PeriodDetector(**kw).detect(codes))


def test_period_detector_finds_planted_cycle():
    p, frac = detect(np.tile(np.repeat([0, 1, 2], 8), 4))
    assert p in (23, 24)
    assert frac >= 0.85


def test_period_detector_rejects_constant_history():
    assert detect(np.zeros(128, dtype=np.int64)) is None


def test_period_detector_rejects_short_history():
    assert detect(np.tile(np.repeat([0, 1], 4), 3), min_history=32) is None


def test_period_detector_prefers_smallest_period():
    assert detect(np.tile([0, 1, 0, 2], 32))[0] == 4


# ---------------------------------------------------------------------------
# EwmaMixtureForecaster
# ---------------------------------------------------------------------------

def cyclic_stream(pkg, blocks=12, block_len=8):
    qs = []
    for b in range(blocks):
        t = b % 3
        for j in range(block_len):
            qs.append(make_query(pkg, t, t, 10.0 * j, 10.0 * j + 5.0))
    return qs


def drift_stream(pkg, n=200, seed=0):
    ramp = np.linspace(0.0, 1.0, n)
    flags = np.random.default_rng(seed).uniform(size=n) < ramp
    return [make_query(pkg, 1 if f else 0, 1 if f else 0, 10.0, 40.0)
            for f in flags]


def observed(pkg, stream, forecaster=None):
    f = forecaster or PKGS[pkg][3].EwmaMixtureForecaster()
    for q in stream:
        f.observe(q)
    return f


def test_period_forecast_reads_key_off_the_cycle():
    def run(pkg):
        f = observed(pkg, cyclic_stream(pkg))
        return fc_fields(pkg, f.forecast(lead=16)), f.info()
    fields, info = both(run)
    key, source, _, dwell, lead = fields[:5]
    assert source == "period"
    assert dwell == 8.0
    assert 1 <= lead <= 4
    assert key == ("tpl", 0)
    assert set(fields[7]) == {0}
    assert info["observed"] == 96 and info["distinct_keys"] == 3


def test_trend_forecast_fires_on_gradual_drift_with_mixture_sample():
    def run(pkg):
        f = observed(pkg, drift_stream(pkg))
        return fc_fields(pkg, f.forecast(lead=16)), f.trend_dwell, \
            f.trend_share
    fields, trend_dwell, trend_share = both(run)
    assert fields[1] == "trend" and fields[0] == ("tpl", 1)
    assert fields[3] == trend_dwell
    tids = fields[7]
    assert set(tids) == {0, 1}
    assert sum(t == 1 for t in tids) / len(tids) >= trend_share


def test_single_template_stream_yields_no_forecast():
    def run(pkg):
        f = observed(pkg, [make_query(pkg, 0, 0, 1.0 * j, 1.0 * j + 5.0)
                           for j in range(128)])
        return f.forecast()
    assert both(run) is None


def test_short_history_yields_no_forecast():
    assert both(lambda p: observed(p, cyclic_stream(p, blocks=2))
                .forecast()) is None


def test_forecaster_pickles_mid_stream_and_stays_deterministic():
    def run(pkg):
        stream = cyclic_stream(pkg)
        a = observed(pkg, stream[:60])
        b = pickle.loads(pickle.dumps(a))
        for q in stream[60:]:
            a.observe(q)
            b.observe(q)
        fa, fb = fc_fields(pkg, a.forecast(16)), fc_fields(pkg, b.forecast(16))
        assert fa == fb
        return fa
    assert both(run) is not None


# ---------------------------------------------------------------------------
# AdversarialForecaster
# ---------------------------------------------------------------------------

def test_adversarial_mirrors_ranges_under_a_sentinel_key():
    def run(pkg):
        f = PKGS[pkg][3].AdversarialForecaster()
        low, high = make_query(pkg, 0, 0, 10., 20.), make_query(pkg, 1, 0,
                                                                70., 80.)
        f.observe(low)
        f.observe(high)
        fc = f.forecast()
        tk = PKGS[pkg][3].template_key
        assert fc.key != tk(low) and fc.key != tk(high)
        return fc_fields(pkg, fc), f.info()
    fields, info = both(run)
    assert fields[1] == "adversarial" and fields[3] >= 1e6
    lo = np.frombuffer(fields[5]).reshape(2, COLS)
    hi = np.frombuffer(fields[6]).reshape(2, COLS)
    assert (lo[0, 0], hi[0, 0], lo[1, 0], hi[1, 0]) == (70., 80., 10., 20.)
    assert info == {"forecaster": "adversarial", "observed": 2}


def test_adversarial_empty_history_yields_no_forecast():
    assert both(lambda p: PKGS[p][3].AdversarialForecaster().forecast()) \
        is None


def test_adversarial_mirror_of_one_sided_predicates_stays_finite_or_open():
    """inf + -inf domain sentinels fold to 0 before the sum: a mirrored
    bound is never NaN, so no NaN reaches the pruning kernel's queries."""
    def run(pkg):
        f = PKGS[pkg][3].AdversarialForecaster()
        rng = np.random.default_rng(4)
        for j in range(12):
            q = make_query(pkg, -1, j % COLS, *sorted(rng.uniform(0, 100, 2)))
            if j % 3 == 0:
                q.hi[(j + 1) % COLS] = rng.uniform(0, 100)   # one-sided
            f.observe(q)
        return fc_fields(pkg, f.forecast())
    fields = both(run)
    assert not np.isnan(np.frombuffer(fields[5])).any()
    assert not np.isnan(np.frombuffer(fields[6])).any()


# ---------------------------------------------------------------------------
# QdTreeGrower
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grow_table():
    return np.random.default_rng(5).uniform(0, 100, size=(2_000, COLS))


def narrow_forecast(pkg, dwell=200.0):
    qs = [make_query(pkg, 0, 0, 5.0 * j, 5.0 * j + 4.0) for j in range(16)]
    return PKGS[pkg][3].Forecast(key=("tpl", 0), queries=qs, source="trend",
                                 confidence=0.9, dwell=dwell, lead=8)


def whole_table_meta(pkg, data):
    if pkg == "ref":
        return rc.layouts.metadata_from_assignment(
            data, np.zeros(len(data), dtype=np.int64), 1)
    return tc.layouts.metadata_from_assignment(
        data, torch.zeros(len(data), dtype=torch.int64), 1)


def grower(pkg, data, *args, **kw):
    return PKGS[pkg][3].QdTreeGrower(table(pkg, data), *args, **kw)


def layout_fields(lay):
    if lay is None:
        return None
    m = lay.meta
    return (lay.layout_id, lay.name, lay.technique, m.num_partitions,
            host(m.mins).tobytes(), host(m.maxs).tobytes(),
            host(m.rows_host if hasattr(m, "rows_host") else m.rows)
            .tobytes(), lay.info)


def test_grower_admits_against_empty_state_space(grow_table):
    def run(pkg):
        g = grower(pkg, grow_table, 8, seed=3)
        cand = g.propose(narrow_forecast(pkg), [])
        again = g.propose(narrow_forecast(pkg), [])
        return layout_fields(cand), g.info(), layout_fields(again)
    cand, info, again = both(run)
    assert cand[0] == rf.GROWN_ID_BASE == tf.GROWN_ID_BASE
    assert cand[3] <= 8
    assert info == {"grown_proposed": 2, "grown_admitted": 2}
    assert again[0] == rf.GROWN_ID_BASE + 1


def test_grower_rejects_covered_regime_and_reuses_the_id(grow_table):
    def run(pkg):
        g = grower(pkg, grow_table, 8, seed=3)
        cand = g.propose(narrow_forecast(pkg), [])
        covered = g.propose(narrow_forecast(pkg), [cand.meta])
        next_id = g.next_id
        return covered, next_id, layout_fields(
            g.propose(narrow_forecast(pkg), []))
    covered, next_id, after = both(run)
    assert covered is None and next_id == rf.GROWN_ID_BASE + 1
    assert after[0] == rf.GROWN_ID_BASE + 1


def test_grower_needs_a_minimum_forecast_sample(grow_table):
    def run(pkg):
        g = grower(pkg, grow_table, 8, min_queries=8, seed=3)
        fc = narrow_forecast(pkg)
        fc.queries = fc.queries[:5]
        return g.propose(fc, []), g.num_proposed
    assert both(run) == (None, 0)


def test_grower_alpha_payback_bar_blocks_unprofitable_growth(grow_table):
    def run(pkg):
        base = [whole_table_meta(pkg, table(pkg, grow_table))]
        out = [layout_fields(grower(pkg, grow_table, 8, alpha=0.0, seed=3)
                             .propose(narrow_forecast(pkg), base)),
               grower(pkg, grow_table, 8, alpha=1e9, seed=3)
               .propose(narrow_forecast(pkg), base)]
        priced = grower(pkg, grow_table, 8, alpha=50.0, seed=3)
        out.append(priced.propose(narrow_forecast(pkg, dwell=10.0), base))
        out.append(layout_fields(
            priced.propose(narrow_forecast(pkg, dwell=1e4), base)))
        return out
    greedy, frugal, short, long_ = both(run)
    assert greedy is not None and frugal is None
    assert short is None and long_ is not None


def test_grower_pickles_and_reproposes_identically(grow_table):
    def run(pkg):
        g = grower(pkg, grow_table, 8, seed=3)
        g.propose(narrow_forecast(pkg), [])
        clone = pickle.loads(pickle.dumps(g))
        a = layout_fields(g.propose(narrow_forecast(pkg), []))
        b = layout_fields(clone.propose(narrow_forecast(pkg), []))
        assert a == b
        return a
    assert both(run)[0] == rf.GROWN_ID_BASE + 1


# ---------------------------------------------------------------------------
# ForecastPolicy golden traces
# ---------------------------------------------------------------------------

ALPHA, DELTA, PARTS = 10.0, 5, 8


@pytest.fixture(scope="module")
def data():
    return np.random.default_rng(11).uniform(0, 100, size=(3_000, COLS))


@pytest.fixture(scope="module")
def streams(data):
    lo, hi = data.min(0), data.max(0)
    out = {}
    for pkg in PKGS:
        for name in ("cyclic_diurnal", "gradual_drift"):
            fs = PKGS[pkg][0].make_drift_scenario(
                name, lo, hi, num_tenants=1, queries_per_tenant=400, seed=7)
            out[pkg, name] = fs.per_tenant[fs.tenant_ids[0]]
    return out


def make_inner(pkg, data, seed=2):
    core, eng, lm, _ = PKGS[pkg]
    data = table(pkg, data)
    cfg = core.OreoConfig(alpha=ALPHA, seed=seed, delta=DELTA,
                          manager=lm.LayoutManagerConfig(
                              target_partitions=PARTS, window_size=60,
                              gen_every=30))
    return eng.OreoPolicy(data, core.build_default_layout(0, data, PARTS),
                          core.make_generator("qdtree"), cfg)


def adversarial_policy(pkg, data, **cfg_kw):
    fc = PKGS[pkg][3]
    cfg = fc.ForecastConfig(grow=False, margin=0.0, min_gap=4, **cfg_kw)
    return fc.ForecastPolicy(make_inner(pkg, data),
                             forecaster=fc.AdversarialForecaster(),
                             config=cfg)


def engine_of(pkg, policy, data, **kw):
    eng = PKGS[pkg][1]
    return eng.LayoutEngine(policy, eng.InMemoryBackend(table(pkg, data)),
                            delta=DELTA, **kw)


def records(engine):
    ex = engine.reorg_executor
    return [] if ex is None else [
        (m.target_state, m.charged_at, m.begun_at, m.completed_at, m.alpha,
         m.total_rows, m.moved_rows, m.moves_total, m.moves_done,
         m.charges, m.charged) for m in ex.migrations]


def trace(res):
    return (res.query_costs.tobytes(), tuple(res.reorg_indices),
            res.state_seq.tobytes(), res.total_cost, res.total_reorg_cost,
            res.info)


def observed_run(pkg, make_policy, data, stream, **kw):
    """One engine run: (trace, ledgers, D-UMTS events, policy counters)."""
    policy = make_policy(pkg)
    eng = engine_of(pkg, policy, data, **kw)
    res = eng.run(stream)
    inner = getattr(policy, "inner", policy)
    counters = {k: getattr(policy, k, None) for k in (
        "prepositions", "reactive_moves", "forecast_checks",
        "forecast_hits", "num_forecasts")}
    return {"trace": trace(res), "ledgers": records(eng),
            "events": [(e.query_idx, e.from_state, e.to_state, e.reason)
                       for e in inner.dumts.events],
            "counters": counters, "res": res, "policy": policy}


class Runs:
    """Each run once per package; the port's must equal the reference's."""

    def __init__(self, data, streams):
        self.data, self.streams, self._memo = data, streams, {}

    def get(self, name, scenario, make_policy, **kw):
        if name not in self._memo:
            out = {pkg: observed_run(pkg, make_policy, self.data,
                                     self.streams[pkg, scenario], **kw)
                   for pkg in PKGS}
            for key in ("trace", "ledgers", "events", "counters"):
                assert out["port"][key] == out["ref"][key], (name, key)
            self._memo[name] = out
        return self._memo[name]


@pytest.fixture(scope="module")
def runs(data, streams):
    return Runs(data, streams)


@pytest.mark.parametrize("scenario", ["cyclic_diurnal", "gradual_drift"])
def test_gated_off_wrapper_is_bitwise_the_bare_policy(scenario, data, runs):
    bare = runs.get(f"bare/{scenario}", scenario,
                    lambda p: make_inner(p, data))
    gated = runs.get(f"gated/{scenario}", scenario,
                     lambda p: PKGS[p][3].ForecastPolicy(
                         make_inner(p, data), config=PKGS[p][3].ForecastConfig(
                             budget_frac=0.0, grow=False)))
    for pkg in PKGS:
        assert bare[pkg]["trace"][:3] == gated[pkg]["trace"][:3]
        assert gated[pkg]["counters"]["prepositions"] == 0
        assert gated[pkg]["res"].info["grown_admitted"] == 0
        assert gated[pkg]["events"] == bare[pkg]["events"]


def test_adversarial_forecaster_stays_inside_the_alpha_envelope(data, runs):
    bare = runs.get("bare/cyclic_diurnal", "cyclic_diurnal",
                    lambda p: make_inner(p, data))
    adv = runs.get("adversarial", "cyclic_diurnal",
                   lambda p: adversarial_policy(p, data))
    for pkg in PKGS:
        pol, res = adv[pkg]["policy"], adv[pkg]["res"]
        assert pol.prepositions > 0
        assert pol.prepositions <= pol.config.budget_frac * pol.reactive_moves
        events = pol.inner.dumts.events
        assert sum(e.reason == "preposition" for e in events) \
            == pol.prepositions
        assert pol.reactive_moves \
            == sum(e.reason != "preposition" for e in events)
        assert pol.forecast_checks > 0 and pol.forecast_hits == 0
        assert res.total_cost \
            <= bare[pkg]["res"].total_cost + pol.prepositions * 3.0 * ALPHA
        assert res.total_reorg_cost == ALPHA * len(res.reorg_indices)
        assert res.info == pol.info()
    assert adv["port"]["policy"].info() == adv["ref"]["policy"].info()


def test_adversarial_prepositions_ride_the_incremental_ledger(data, runs):
    atomic = runs.get("adversarial", "cyclic_diurnal",
                      lambda p: adversarial_policy(p, data))
    incr = runs.get("adversarial/incremental", "cyclic_diurnal",
                    lambda p: adversarial_policy(p, data), incremental=True)
    for pkg in PKGS:
        a, i = atomic[pkg], incr[pkg]
        assert a["policy"].prepositions == i["policy"].prepositions > 0
        assert a["trace"][:3] == i["trace"][:3]
        migs = i["ledgers"]
        assert len(migs) > 0
        for mig in migs:
            assert mig[3] == mig[2]                  # unbounded budget
            assert mig[10] == mig[4]                 # charged == alpha


def test_adversarial_bounded_migration_ledger_still_closes(data, runs):
    out = runs.get("adversarial/rows400", "cyclic_diurnal",
                   lambda p: adversarial_policy(p, data), incremental=True,
                   rows_per_tick=400)
    for pkg in PKGS:
        assert out[pkg]["policy"].prepositions > 0
        done = [m for m in out[pkg]["ledgers"] if m[3] >= 0]
        assert len(done) > 0
        assert any(m[3] > m[2] for m in done)
        for mig in done:
            assert mig[10] == mig[4]


def test_preposition_budget_clamp_binds(data, runs):
    free = runs.get("adversarial", "cyclic_diurnal",
                    lambda p: adversarial_policy(p, data))
    clamped = runs.get("adversarial/clamp0.1", "cyclic_diurnal",
                       lambda p: adversarial_policy(p, data, budget_frac=0.1))
    for pkg in PKGS:
        c = clamped[pkg]["policy"]
        assert c.prepositions <= 0.1 * c.reactive_moves
        assert c.prepositions < free[pkg]["policy"].prepositions


def test_forecast_engine_pickles_mid_run_and_continues_identically(data,
                                                                   streams):
    def run(pkg):
        queries = streams[pkg, "cyclic_diurnal"].queries
        fc = PKGS[pkg][3].ForecastConfig(min_gap=4, forecast_every=5)

        def engine():
            return engine_of(pkg, PKGS[pkg][3].ForecastPolicy(
                make_inner(pkg, data), config=fc), data)
        straight = engine()
        for q in queries:
            straight.step_fast(q)
        resumed = engine()
        for q in queries[:150]:
            resumed.step_fast(q)
        resumed = pickle.loads(pickle.dumps(resumed))
        for q in queries[150:]:
            resumed.step_fast(q)
        a, b = straight.result(), resumed.result()
        assert trace(a) == trace(b)
        return trace(a)
    assert both(run)[5]["forecasts"] > 0


# ---------------------------------------------------------------------------
# Beyond the mirror
# ---------------------------------------------------------------------------

def growing_policy(pkg, data):
    fc = PKGS[pkg][3]
    grower = fc.QdTreeGrower(table(pkg, data), PARTS, min_queries=4,
                             gain=0.0, cost_floor=0.0, alpha=0.0, seed=103)
    return fc.ForecastPolicy(make_inner(pkg, data), grower=grower,
                             config=fc.ForecastConfig(
                                 grow_sources=("period", "trend"),
                                 grow_retire_after=40, max_grown=2))


def test_growing_policy_admits_the_reference_grown_ids(data, runs):
    """Growth from both forecast sources, retired and re-grown mid-run: the
    grown ids, the live grown set and the plane equal the reference's."""
    out = runs.get("growing", "cyclic_diurnal",
                   lambda p: growing_policy(p, data))
    ref, port = out["ref"]["policy"], out["port"]["policy"]
    assert port.info() == ref.info()
    assert port.info()["grown_admitted"] > len(port._grown) > 0
    assert port.prepositions > 0
    assert port._grown == ref._grown
    assert port.grower.next_id == ref.grower.next_id
    assert sorted(port.inner.dumts.states) == sorted(ref.inner.dumts.states)


def test_grower_holds_the_manager_table_as_one_storage(data):
    policy = tf.ForecastPolicy(make_inner("port", data))
    assert policy.grower.data is policy.inner.manager.data
    backend = te.InMemoryBackend(policy.inner.manager.data)
    eng = te.LayoutEngine(policy, backend, delta=DELTA)
    assert policy.grower.data is backend.data
    clone = pickle.loads(pickle.dumps(eng))
    assert clone.policy.grower.data is clone.policy.inner.manager.data
    assert clone.policy.grower.data is clone.backend.data


def test_forecast_reexports_resolve_in_either_import_order():
    src = str(Path(__file__).resolve().parents[1] / "src")
    for first in ("repro_torch.forecast", "repro_torch.engine"):
        code = (f"import {first}\n"
                "from repro_torch.engine import ForecastPolicy, ForecastConfig\n"
                "from repro_torch.engine.policies import ForecastPolicy as P\n"
                "import repro_torch.forecast as f, sys\n"
                "assert ForecastPolicy is f.ForecastPolicy is P\n"
                "assert ForecastConfig is f.ForecastConfig\n"
                "assert not any(m == 'repro' or m.startswith(('repro.', 'jax'))"
                " for m in sys.modules)\n")
        subprocess.run([sys.executable, "-c", code], check=True,
                       env={"PYTHONPATH": src, "PATH": ""})
