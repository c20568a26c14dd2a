"""The port's training substrate: ``tests/test_substrate.py``'s cases on the
port, then the port against ``repro`` on the same numpy-seeded inputs.

The port's train step updates its state in place (as ``repro``'s launcher
donates it), so every test starts from a deep copy of the fixture's state.

Cross-package tolerances, in float32 at qwen3-1.7b's smoke config: loss
within ``1e-5`` relative; every gradient within ``1e-4 * max |g|`` of its
tensor (the same sums in another order, through both packages' blocked
attention and chunked loss); after AdamW steps, the loss within ``1e-5``
relative, the gradient norm ``1e-4`` and each parameter ``2e-6`` absolute.
The step comparisons use ``eps = 1e-3``: at AdamW's first steps an entry's
update is about ``lr * sign(g)``, so a gradient within rounding of 0 would
flip by ``2 lr`` on either side; ``eps`` makes the update continuous there.
``schedule`` is held within ``1e-7`` relative (float32 ``cos`` of two
libraries); ``ef_int8_roundtrip``, the pipeline's batches and
``PipelineStats`` must be equal bit for bit.  Checkpoints cross packages
bit for bit, for a dense and an MoE state: each package restores the
other's, and the port's leaf files are byte for byte ``repro``'s.
"""
import copy
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.data import pipeline as jpipe
from repro.launch import train as jlaunch
from repro.models import build_model as jbuild_model
from repro.train import checkpoint as jcheckpoint
from repro.train import compression as jcompression
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core import build_default_layout, make_templates
from repro_torch.data import (OreoDataPipeline, PartitionStore, mixture_recipe,
                              synth_corpus)
from repro_torch.launch import train as launch
from repro_torch.models import build_model
from repro_torch.train import (FaultTolerantTrainer, OptimizerConfig,
                               TrainOptions, build_train_step, checkpoint,
                               compression, init_train_state)
from repro_torch.train.elastic import Prefetcher
from repro_torch.train.optimizer import adamw_update, global_norm, schedule

CPU = torch.device("cpu")
ARCH = "qwen3-1.7b"


def batch_fn(i, vocab, shape=(4, 32)):
    r = np.random.default_rng(i)              # deterministic in step
    toks = r.integers(0, vocab, shape, dtype=np.int32)
    return {"tokens": toks, "targets": np.roll(toks, -1, 1)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The smoke model's ops are tiny: one intra-op thread keeps them from
    spinning against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_setup():
    """The substrate fixture on the port: the smoke config in bf16, one
    train state; ``fresh()`` gives a deep copy of it."""
    cfg = get_arch(ARCH, smoke=True)
    model = build_model(cfg, device="cpu")
    opt_cfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=5, total_steps=100)
    step = build_train_step(model, opt_cfg, TrainOptions(microbatches=1))
    state = init_train_state(model, torch.Generator().manual_seed(0),
                             opt_cfg)
    return (cfg, model, step, lambda: copy.deepcopy(state),
            lambda i: batch_fn(i, cfg.vocab))


def leaves(state):
    return [t for _, t in checkpoint._leaves(state)]


# ---------------------------------------------------------------------------
# tests/test_substrate.py on the port
# ---------------------------------------------------------------------------

def test_loss_decreases(tiny_setup):
    cfg, model, step, fresh, batch = tiny_setup
    state, losses = fresh(), []
    b = batch(0)                                  # overfit one batch
    for _ in range(25):
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.1


def test_schedule_warmup_cosine():
    cfg = OptimizerConfig(peak_lr=1e-3, min_lr=1e-4, warmup_steps=10,
                          total_steps=100)
    assert float(schedule(0, cfg)) == pytest.approx(0.0)
    assert float(schedule(10, cfg)) == pytest.approx(1e-3)
    assert float(schedule(100, cfg)) == pytest.approx(1e-4)


def test_microbatch_accumulation_matches_full_batch(tiny_setup):
    """grad-accum over 4 microbatches == single 4x batch step."""
    cfg, model, _, fresh, batch = tiny_setup
    opt_cfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=5, total_steps=100)
    s1 = build_train_step(model, opt_cfg, TrainOptions(microbatches=1))
    s4 = build_train_step(model, opt_cfg, TrainOptions(microbatches=4))
    b = {k: np.concatenate([batch(i)[k] for i in range(4)])
         for k in ("tokens", "targets")}
    st1, m1 = s1(fresh(), b)
    st4, m4 = s4(fresh(), b)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=2e-2)
    d1 = leaves(st1["params"])[3].float().detach().numpy()
    d4 = leaves(st4["params"])[3].float().detach().numpy()
    np.testing.assert_allclose(d1, d4, atol=5e-3)


def test_checkpoint_roundtrip(tiny_setup, tmp_path):
    state = tiny_setup[3]()
    checkpoint.save(state, str(tmp_path), step=7)
    assert checkpoint.latest_step(str(tmp_path)) == 7
    restored = checkpoint.restore(str(tmp_path), 7, state)
    for a, b in zip(leaves(state), leaves(restored)):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)
    assert all(p.requires_grad for p in restored["params"].parameters())
    with open(tmp_path / "step_7" / "manifest.json") as f:
        manifest = json.load(f)
    assert sorted(manifest) == ["dtypes", "num_leaves", "shapes", "step",
                                "treedef"]
    assert "bfloat16" in manifest["dtypes"]
    assert np.load(tmp_path / "step_7" / "leaf_0.npy").dtype in (
        np.uint16, np.float32, np.int32)


def test_checkpoint_keep_last(tiny_setup, tmp_path):
    state = tiny_setup[3]()
    for s in (1, 2, 3, 4, 5):
        checkpoint.save(state, str(tmp_path), step=s, keep_last=2)
    assert checkpoint.all_steps(str(tmp_path)) == [4, 5]


def test_fault_tolerant_resume_bit_exact(tiny_setup, tmp_path):
    """A mid-run failure + restore replays to the same final state."""
    cfg, model, step, fresh, batch = tiny_setup
    clean = FaultTolerantTrainer(step, fresh(), batch,
                                 ckpt_dir=str(tmp_path / "a"), ckpt_every=5)
    final_clean = clean.run(20)
    armed = {"on": True}

    def fault_hook(s):
        if s == 13 and armed["on"]:
            armed["on"] = False
            raise RuntimeError("injected node failure")

    faulty = FaultTolerantTrainer(step, fresh(), batch,
                                  ckpt_dir=str(tmp_path / "b"), ckpt_every=5,
                                  fault_hook=fault_hook)
    final_faulty = faulty.run(20)
    assert (faulty.restarts, clean.restarts) == (1, 0)
    for a, b in zip(leaves(final_clean), leaves(final_faulty)):
        assert torch.equal(a, b)


def test_gradient_compression_error_feedback():
    """EF int8 roundtrip: per-step error bounded; residual carries it."""
    rng = np.random.default_rng(0)
    grads = {"w": torch.as_tensor(rng.normal(0, 0.1, (64, 64)),
                                  dtype=torch.float32)}
    residual = compression.init_residual(grads)
    total_in, total_out = np.zeros((64, 64)), np.zeros((64, 64))
    for _ in range(20):
        g = {"w": torch.as_tensor(rng.normal(0, 0.1, (64, 64)),
                                  dtype=torch.float32)}
        deq, residual = compression.ef_int8_roundtrip(g, residual)
        total_in += g["w"].numpy()
        total_out += deq["w"].numpy()
    gap = np.abs(total_in - total_out)
    assert gap.max() <= np.abs(residual["w"].numpy()).max() + 1e-5


def test_global_norm():
    t = {"a": torch.ones((3,)), "b": torch.full((4,), 2.0)}
    assert float(global_norm(t)) == pytest.approx(np.sqrt(3 + 16))


@pytest.fixture(scope="module")
def pipelines():
    """test_substrate's pipeline run on both packages: (port pipeline, its
    batches and the stats after 100 batches; repro's the same)."""
    def run(synth, recipe, pipe_cls, **kw):
        meta, tokens = synth(n_docs=20_000, doc_len=32, vocab=100, seed=0)
        pipe = pipe_cls(meta, tokens, recipe(meta, total_steps=1500, seed=1,
                                             segment_length=(300, 500)),
                        batch_size=4, seq_len=32, alpha=40.0, **kw)
        batches, first_100 = [], []
        for i, b in enumerate(pipe):
            batches.append(b)
            if i < 100:
                first_100.append(pipe.stats.scan_fraction_sum)
            if i >= 1400:
                break
        return pipe, batches, first_100
    return (run(synth_corpus, mixture_recipe, OreoDataPipeline, device="cpu"),
            run(jpipe.synth_corpus, jpipe.mixture_recipe,
                jpipe.OreoDataPipeline))


def test_oreo_pipeline_yields_batches_and_improves_scan(pipelines):
    pipe, batches, first_100 = pipelines[0]
    assert all(b["tokens"].shape == (4, 32) and b["targets"].shape == (4, 32)
               for b in batches)
    assert pipe.stats.queries >= 1400
    assert pipe.meta.device == CPU and pipe.meta.dtype == torch.float64
    early = first_100[-1] / 100
    assert pipe.stats.mean_scan_fraction <= early * 1.2


def test_partition_store_scan_correctness(tmp_path):
    rng = np.random.default_rng(0)
    data = rng.uniform(0, 100, (5000, 6))
    store = PartitionStore(str(tmp_path / "tbl"), device="cpu")
    table = torch.as_tensor(data)
    store.write(table, build_default_layout(0, table, 8))
    t = make_templates(1, 6, rng)[0]
    q = t.sample(rng, data.min(0), data.max(0))
    rows, stats = store.scan(q)
    mask = ((data >= q.lo[None]) & (data <= q.hi[None])).all(axis=1)
    assert len(rows) == mask.sum()
    assert stats.partitions_read <= stats.partitions_total
    assert stats.rows_read >= len(rows)


def test_prefetcher_preserves_order():
    items = list(range(50))
    assert list(Prefetcher(iter(items), depth=3)) == items


# ---------------------------------------------------------------------------
# The port against repro
# ---------------------------------------------------------------------------

def test_schedule_equals_the_reference():
    cfg = OptimizerConfig(peak_lr=3e-4, min_lr=3e-5, warmup_steps=20,
                          total_steps=300)
    jcfg = jopt.OptimizerConfig(peak_lr=3e-4, min_lr=3e-5, warmup_steps=20,
                                total_steps=300)
    steps = np.array([0, 1, 7, 19, 20, 21, 100, 159, 299, 300, 500],
                     dtype=np.int32)
    got = schedule(torch.as_tensor(steps), cfg).numpy()
    want = np.asarray(jopt.schedule(jnp.asarray(steps), jcfg))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)


def test_ef_int8_roundtrip_equals_the_reference_bitwise():
    rng = np.random.default_rng(3)
    shapes = {"a": (33, 17), "b": (40,), "c": (5, 6, 7)}
    g = {k: rng.normal(0, 0.05, s).astype(np.float32)
         for k, s in shapes.items()}
    g["b"][:] = np.round(g["b"] * 100) / 100     # ties at half a step
    r = {k: rng.normal(0, 1e-3, s).astype(np.float32)
         for k, s in shapes.items()}
    got, res = compression.ef_int8_roundtrip(
        {k: torch.as_tensor(v) for k, v in g.items()},
        {k: torch.as_tensor(v) for k, v in r.items()})
    want, wres = jcompression.ef_int8_roundtrip(
        {k: jnp.asarray(v) for k, v in g.items()},
        {k: jnp.asarray(v) for k, v in r.items()})
    for k in shapes:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(res[k].numpy(), np.asarray(wres[k]))


def f32_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float32)
                        if a.dtype != np.int32 else np.asarray(a), tree)


def flat(module_or_named):
    """name -> float32 numpy for the port; the reference's tree is mapped
    into the same names through convert.transformer_params."""
    items = (module_or_named.named_parameters()
             if hasattr(module_or_named, "named_parameters")
             else module_or_named.items())
    return {n: t.detach().float().numpy() for n, t in items}


def port_names(tree, cfg):
    return flat(convert.transformer_params(
        jax.tree.map(np.asarray, tree), cfg, device="cpu"))


def assert_grads_close(got, want):
    """Every tensor within 1e-4 x its max |g|; returns the worst ratio."""
    worst = 0.0
    assert sorted(got) == sorted(want)
    for n in want:
        scale = float(np.abs(want[n]).max())
        err = float(np.abs(got[n] - want[n]).max())
        assert err <= 1e-4 * scale or err == 0.0, (n, err, scale)
        worst = max(worst, err / scale if scale else 0.0)
    return worst


@pytest.fixture(scope="module")
def reference():
    """repro's smoke model, float32 params from its own init, and the port's
    copy of them."""
    jcfg, cfg = jget_arch(ARCH, smoke=True), get_arch(ARCH, smoke=True)
    jm = jbuild_model(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init_params(jax.random.PRNGKey(0)))
    m = build_model(cfg, device="cpu")
    return jcfg, cfg, jm, jp, m


def test_loss_and_grads_equal_the_reference_in_float32(reference):
    jcfg, cfg, jm, jp, m = reference
    b = batch_fn(11, cfg.vocab, (3, 40))
    b["targets"][0, -5:] = -1                     # ignored positions
    loss, grads = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    params = convert.train_state({"params": jax.tree.map(np.asarray, jp),
                                  "opt": {"m": jax.tree.map(np.asarray, jp),
                                          "v": jax.tree.map(np.asarray, jp),
                                          "step": np.int32(0)}},
                                 cfg, device="cpu")["params"]
    got = m.loss_fn(params, b)
    assert abs(float(got.detach()) - float(loss)) <= 1e-5 * abs(float(loss))
    names, ps = zip(*params.named_parameters())
    g = torch.autograd.grad(got, ps)
    worst = assert_grads_close(
        {n: t.numpy() for n, t in zip(names, g)}, port_names(grads, cfg))
    assert worst < 1e-4


@pytest.mark.parametrize("micro", [1, 4])
def test_train_step_equals_the_reference(reference, micro):
    jcfg, cfg, jm, jp, m = reference
    kw = dict(peak_lr=1e-3, warmup_steps=5, total_steps=100, eps=1e-3)
    jstate = {"params": jp, "opt": jopt.init_opt_state(jp, jopt.OptimizerConfig(
        **kw))}
    state = convert.train_state(jax.tree.map(np.asarray, jstate), cfg,
                                device="cpu")
    b = {k: np.concatenate([batch_fn(i, cfg.vocab)[k] for i in range(4)])
         for k in ("tokens", "targets")}
    jstep = jax.jit(jloop.build_train_step(
        jm, jopt.OptimizerConfig(**kw), jloop.TrainOptions(microbatches=micro)))
    jnew, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
    step = build_train_step(m, OptimizerConfig(**kw),
                            TrainOptions(microbatches=micro))
    new, met = step(state, b)
    for key in ("loss", "grad_norm", "lr"):
        assert float(met[key]) == pytest.approx(float(jmet[key]),
                                                rel=1e-5 if key != "grad_norm"
                                                else 1e-4)
    want = port_names(jnew["params"], cfg)
    for n, a in flat(new["params"]).items():
        np.testing.assert_allclose(a, want[n], atol=2e-6, rtol=0, err_msg=n)
    assert int(new["opt"]["step"]) == int(jnew["opt"]["step"]) == 1


def test_carried_train_state_continues_as_the_reference(reference):
    """repro trains 2 steps; its state (params, moments, step, and the EF
    residual) carried across continues 3 steps as repro's does."""
    jcfg, cfg, jm, jp, m = reference
    kw = dict(peak_lr=1e-3, warmup_steps=2, total_steps=20, eps=1e-3)
    jcfg_opt = jopt.OptimizerConfig(**kw)
    jstep = jax.jit(jloop.build_train_step(jm, jcfg_opt))
    jstate = {"params": jp, "opt": jopt.init_opt_state(jp, jcfg_opt)}
    batches = [batch_fn(20 + i, cfg.vocab) for i in range(5)]
    for b in batches[:2]:
        jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
    residual = jax.tree.map(lambda a: jnp.full(a.shape, 0.5, jnp.float32), jp)
    tree = jax.tree.map(np.asarray, dict(jstate, ef_residual=residual))
    state = convert.train_state(tree, cfg, device="cpu")
    assert int(state["opt"]["step"]) == 2
    assert state["opt"]["step"].dtype == torch.int32
    for part in ("m", "v", "ef_residual"):
        src = port_names(tree["opt"][part] if part != "ef_residual"
                         else tree[part], cfg)
        got = state["opt"][part] if part != "ef_residual" else state[part]
        for n, t in got.items():
            np.testing.assert_array_equal(t.numpy(), src[n])
    del state["ef_residual"]
    step = build_train_step(m, OptimizerConfig(**kw))
    for b in batches[2:]:
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, met = step(state, b)
        assert float(met["loss"]) == pytest.approx(float(jmet["loss"]),
                                                   rel=1e-5)
        assert float(met["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=1e-4)
    want = port_names(jstate["params"], cfg)
    for n, a in flat(state["params"]).items():
        np.testing.assert_allclose(a, want[n], atol=2e-6, rtol=0, err_msg=n)
    for part in ("m", "v"):
        want = port_names(jstate["opt"][part], cfg)
        for n, a in flat(state["opt"][part]).items():
            np.testing.assert_allclose(a, want[n], atol=1e-6, rtol=1e-4,
                                       err_msg=f"{part} {n}")


def test_adamw_update_equals_the_reference(reference):
    """One update from moments mid-run, given the same gradients."""
    jcfg, cfg, jm, jp, m = reference
    rng = np.random.default_rng(9)
    tree = jax.tree.map(np.asarray, jp)
    grads = jax.tree.map(lambda a: rng.normal(0, 0.1, a.shape).astype(
        np.float32), tree)
    mom = jax.tree.map(lambda a: rng.normal(0, 0.01, a.shape).astype(
        np.float32), tree)
    vel = jax.tree.map(lambda a: rng.uniform(0, 1e-3, a.shape).astype(
        np.float32), tree)
    cfg_opt = OptimizerConfig(clip_norm=0.5)
    jnew, jst, jmet = jax.jit(jopt.adamw_update, static_argnums=3)(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, grads),
        {"m": jax.tree.map(jnp.asarray, mom),
         "v": jax.tree.map(jnp.asarray, vel), "step": jnp.int32(41)},
        jopt.OptimizerConfig(clip_norm=0.5))
    state = convert.train_state({"params": tree, "opt": {
        "m": mom, "v": vel, "step": np.int32(41)}}, cfg, device="cpu")
    params, st, met = adamw_update(state["params"], {
        n: torch.as_tensor(a) for n, a in port_names(grads, cfg).items()},
        state["opt"], cfg_opt)
    # jit: XLA reassociates the schedule's float32 arithmetic (a few ulp).
    assert float(met["lr"]) == pytest.approx(float(jmet["lr"]), rel=1e-6)
    assert float(met["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]),
                                                    rel=1e-6)
    assert int(st["step"]) == 42
    for got, want in ((flat(params), port_names(jnew, cfg)),
                      (flat(st["m"]), port_names(jst["m"], cfg)),
                      (flat(st["v"]), port_names(jst["v"], cfg))):
        for n in want:
            np.testing.assert_allclose(got[n], want[n], rtol=1e-6,
                                       atol=1e-9, err_msg=n)


def test_weight_decay_reaches_what_the_reference_decays(reference):
    """Zero gradients from nonzero weights: the update is the decay alone.
    The reference decays leaves of two or more dimensions, the per-layer
    norm scales among them (stacked on the layers' axis), not the final
    norm; the port the same tensors by the same amount."""
    jcfg, cfg, jm, jp, m = reference
    rng = np.random.default_rng(12)
    tree = jax.tree.map(lambda a: rng.normal(0, 0.1, a.shape).astype(
        np.float32), jax.tree.map(np.asarray, jp))
    zeros = jax.tree.map(np.zeros_like, tree)
    opt_cfg = OptimizerConfig(warmup_steps=0)
    jnew, _, _ = jax.jit(jopt.adamw_update, static_argnums=3)(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, zeros),
        {"m": jax.tree.map(jnp.asarray, zeros),
         "v": jax.tree.map(jnp.asarray, zeros), "step": jnp.int32(0)},
        jopt.OptimizerConfig(warmup_steps=0))
    state = convert.train_state({"params": tree, "opt": {
        "m": zeros, "v": zeros, "step": np.int32(0)}}, cfg, device="cpu")
    before = {n: a.copy() for n, a in flat(state["params"]).items()}
    params, _, _ = adamw_update(state["params"], {
        n: torch.zeros_like(t) for n, t in state["opt"]["m"].items()},
        state["opt"], opt_cfg)
    got, want = flat(params), port_names(jnew, cfg)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-7, atol=0,
                                   err_msg=n)
    assert not np.array_equal(got["layers.0.ln1"], before["layers.0.ln1"])
    assert not np.array_equal(got["layers.1.attn.q_norm"],
                              before["layers.1.attn.q_norm"])
    assert np.array_equal(got["final_norm"], before["final_norm"])


CROSSING = [ARCH, "moonshot-v1-16b-a3b"]     # a dense and an MoE state


@pytest.fixture(scope="module")
def reference_state():
    """arch -> repro's train state at that smoke config with the EF
    residual, every leaf redrawn from a numpy seed (so a misplaced leaf or
    layer shows) and step 7, as numpy arrays."""
    states = {}

    def state_of(arch):
        if arch not in states:
            jm = jbuild_model(jget_arch(arch, smoke=True))
            shapes = jax.eval_shape(
                lambda key: jloop.init_train_state(
                    jm, key, jopt.OptimizerConfig(),
                    jloop.TrainOptions(compress_grads=True)),
                jax.random.PRNGKey(0))
            rng = np.random.default_rng(8)

            def redraw(a):
                if a.dtype == np.int32:
                    return np.asarray(7, dtype=np.int32)
                return rng.standard_normal(a.shape, dtype=np.float32).astype(
                    a.dtype)
            states[arch] = jax.tree.map(redraw, shapes)
        return states[arch]
    return state_of


def without_ef(tree, ef):
    return tree if ef else {k: v for k, v in tree.items()
                            if k != "ef_residual"}


def bits(a):
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}")


@pytest.mark.parametrize("arch", CROSSING)
@pytest.mark.parametrize("ef", [False, True], ids=["plain", "ef_residual"])
def test_checkpoint_saved_by_the_reference_restores_in_the_port(
        reference_state, ef, arch, tmp_path):
    """repro's checkpoint restored into a zeroed port state equals
    convert.train_state of the saved state, bit for bit, with the same
    dtypes, devices and requires_grad."""
    tree = without_ef(reference_state(arch), ef)
    jcheckpoint.save(tree, str(tmp_path), step=3)
    cfg = get_arch(arch, smoke=True)
    like = convert.train_state(jax.tree.map(np.zeros_like, tree), cfg,
                               device="cpu")
    got = checkpoint.restore(str(tmp_path), 3, like)
    want = convert.train_state(tree, cfg, device="cpu")
    pairs = list(zip(checkpoint._leaves(want), checkpoint._leaves(got)))
    assert len(pairs) == len(checkpoint._leaves(like))
    for (na, a), (nb, b) in pairs:
        assert na == nb and a.dtype == b.dtype and a.device == b.device
        assert a.requires_grad == b.requires_grad
        assert torch.equal(a.detach(), b.detach()), na
    assert ("ef_residual" in got) == ef


@pytest.mark.parametrize("arch", CROSSING)
@pytest.mark.parametrize("ef", [False, True], ids=["plain", "ef_residual"])
def test_checkpoint_saved_by_the_port_restores_in_the_reference(
        reference_state, ef, arch, tmp_path):
    """The port's checkpoint of convert.train_state(tree) has repro's
    leaves byte for byte and manifest fields, and repro's restore gives
    the tree back bit for bit."""
    tree = without_ef(reference_state(arch), ef)
    cfg = get_arch(arch, smoke=True)
    checkpoint.save(convert.train_state(tree, cfg, device="cpu"),
                    str(tmp_path / "port"), step=3)
    jcheckpoint.save(tree, str(tmp_path / "ref"), step=3)
    port, ref = tmp_path / "port" / "step_3", tmp_path / "ref" / "step_3"
    with open(port / "manifest.json") as f:
        manifest = json.load(f)
    with open(ref / "manifest.json") as f:
        want = json.load(f)
    for key in ("step", "num_leaves", "dtypes", "shapes"):
        assert manifest[key] == want[key], key
    paths = ["/".join(map(str, (k.key for k in path)))
             for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert manifest["treedef"] == paths
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    for i in range(want["num_leaves"]):
        assert (port / f"leaf_{i}.npy").read_bytes() == \
            (ref / f"leaf_{i}.npy").read_bytes(), paths[i]
    got = jcheckpoint.restore(str(tmp_path / "port"), 3,
                              jax.tree.map(np.zeros_like, tree))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(bits(a), bits(b))


def test_checkpoint_in_the_earlier_per_layer_format_is_refused(
        tiny_setup, tmp_path):
    """A checkpoint written one leaf a layer, in _leaves' order, as the port
    wrote them before it took repro's format, raises ValueError."""
    state = tiny_setup[3]()
    step_dir = tmp_path / "step_1"
    step_dir.mkdir()
    named = checkpoint._leaves(state)
    for i, (_, t) in enumerate(named):
        t = t.detach()
        arr = (t.view(torch.int16).numpy().view(np.uint16)
               if t.dtype == torch.bfloat16 else t.numpy())
        np.save(step_dir / f"leaf_{i}.npy", arr)
    with open(step_dir / "manifest.json", "w") as f:
        json.dump({"step": 1, "num_leaves": len(named),
                   "treedef": [n for n, _ in named],
                   "dtypes": [str(t.dtype).split(".")[1] for _, t in named],
                   "shapes": [list(t.shape) for _, t in named]}, f)
    with pytest.raises(ValueError, match="per-layer"):
        checkpoint.restore(str(tmp_path), 1, state)


def test_pipeline_equals_the_reference_bitwise(pipelines):
    (pipe, batches, first), (jpipe_, jbatches, jfirst) = pipelines
    assert len(batches) == len(jbatches)
    for a, b in zip(batches, jbatches):
        for k in ("tokens", "targets"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert first == jfirst
    assert dataclasses.asdict(pipe.stats) == dataclasses.asdict(jpipe_.stats)
    assert pipe.stats.reorgs > 0


def test_launch_train_pipeline_equals_the_reference(tmp_path, monkeypatch):
    args = ["--arch", ARCH, "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "16", "--corpus-docs", "1000", "--log-every", "1"]
    monkeypatch.setattr(sys, "argv", ["train"] + args + [
        "--ckpt-dir", str(tmp_path / "jax")])
    jlaunch.main()
    with open(tmp_path / "jax" / "train_summary.json") as f:
        want = json.load(f)
    out = launch.main(args + ["--ckpt-dir", str(tmp_path / "port"),
                              "--device", "cpu"])
    with open(tmp_path / "port" / "train_summary.json") as f:
        assert json.load(f) == out
    assert out["pipeline"] == want["pipeline"]
    assert out["device"] == "cpu"
    assert np.isfinite([out["first_loss"], out["last_loss"]]).all()
    assert checkpoint.latest_step(str(tmp_path / "port")) == 3
    assert os.path.exists(tmp_path / "port" / "step_3" / "manifest.json")
