"""The port's RWKV-6 (SSM family) against ``repro``'s on the same inputs.

rwkv6-3b's smoke config in float32, weights from a numpy seed given to
``repro`` as they are and to the port through ``convert.model_params``,
tokens from a numpy seed.  The WKV chunk is 16 in both packages for the
whole module (``SEQ_MODE``, set here, not in ``repro``'s files), so the
40-position prompt crosses two chunk boundaries and ends in a ragged tail.

Tolerances, as ``tests/test_torch_families.py``'s: logits within ``1e-4 *
max |logit|``, the loss ``1e-5`` relative, every gradient ``1e-4 * max
|g|`` of its tensor, greedy tokens equal; the chunked recurrence against
the exact scan ``2e-4`` (``tests/test_models.py``'s); after an AdamW step
every parameter ``2e-6`` absolute (``eps = 1e-3``, as
``tests/test_torch_train.py`` explains); a decay-only update ``1e-7``
relative; checkpoints byte for byte.

``test_torch_hybrid.py`` reuses this module's helpers for the hybrid.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import build_model as jbuild_model
from repro.models import rwkv6 as JR
from repro.train import checkpoint as jcheckpoint
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.launch import train as launch
from repro_torch.models import build_model, rwkv6, transformer
from repro_torch.train import (OptimizerConfig, adamw_update,
                               build_train_step, checkpoint, init_opt_state)

ARCH = "rwkv6-3b"
FULL_PARAMS = 2_642_741_760          # the reference's rough count
B, T, STEPS, CHUNK = 2, 40, 8, 16


@pytest.fixture(autouse=True, scope="module")
def chunk_16():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(JR.SEQ_MODE, "chunk", CHUNK)
        mp.setitem(rwkv6.SEQ_MODE, "chunk", CHUNK)
        yield


def close(got, want, rel):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= rel * scale or err == 0.0, (err, scale)


def normal(rng, *shape, scale=1.0, loc=0.0):
    return (rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
            + np.float32(loc))


def dense(rng, n, d_in, d_out):
    return normal(rng, n, d_in, d_out, scale=d_in ** -0.5)


def rwkv_tree(cfg, seed):
    """A float32 tree in the reference's layout from a numpy seed, every
    leaf nonzero: lerps in (0, 1), decays w0 in (-3, -1) (so e^{-c} grows
    over a chunk), norms normal * 0.1."""
    rng = np.random.default_rng(seed)
    n, d, ff = cfg.n_layers, cfg.d_model, cfg.d_ff
    lo = JR.DDLERP_DIM, JR.DECAY_LORA_DIM
    layers = {
        "ln1": normal(rng, n, d, scale=0.1),
        "ln2": normal(rng, n, d, scale=0.1),
        "mu_x": rng.uniform(0, 1, (n, d)).astype(np.float32),
        "mu": rng.uniform(0, 1, (n, 5, d)).astype(np.float32),
        "ddlerp_a": normal(rng, n, d, lo[0], scale=0.1),
        "ddlerp_b": normal(rng, n, 5, lo[0], d, scale=0.1),
        "w0": rng.uniform(-3, -1, (n, d)).astype(np.float32),
        "w_lora_a": normal(rng, n, d, lo[1], scale=0.1),
        "w_lora_b": normal(rng, n, lo[1], d, scale=0.1),
        "u": normal(rng, n, d, scale=0.5),
        **{k: dense(rng, n, d, d) for k in ("wr", "wk", "wv", "wg", "wo")},
        "gn": normal(rng, n, d, scale=0.1),
        "cm_mu_k": rng.uniform(0, 1, (n, d)).astype(np.float32),
        "cm_mu_r": rng.uniform(0, 1, (n, d)).astype(np.float32),
        "cm_wk": dense(rng, n, d, ff), "cm_wv": dense(rng, n, ff, d),
        "cm_wr": dense(rng, n, d, d)}
    return {"embed": normal(rng, cfg.vocab, d, scale=0.02), "layers": layers,
            "final_norm": normal(rng, d, scale=0.1),
            "head": normal(rng, d, cfg.vocab, scale=d ** -0.5)}


def named(tree, cfg):
    """The reference's tree under the port's parameter names, as numpy."""
    return {n: t.numpy() for n, t in convert.model_params(
        jax.tree.map(np.asarray, tree), cfg, device="cpu").named_parameters()}


def reference_run(cfg, tree, seed):
    """repro's smoke model in float32 on tree: the forward, loss and
    gradients and a prefill (one jit), then greedy decode (one jit of the
    step); the same through the port.  Returns both sides' outputs."""
    jm = jbuild_model(jget_arch(cfg.name, smoke=True))
    jp = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, T), dtype=np.int32)
    targets = rng.integers(0, cfg.vocab, (B, T), dtype=np.int32)
    targets[0, -3:] = -1

    @jax.jit
    def run(params, toks, targets):
        logits = jm.forward(params, {"tokens": toks})
        loss, grads = jax.value_and_grad(jm.loss_fn)(
            params, {"tokens": toks, "targets": targets})
        plog, cache = jm.prefill(params, {"tokens": toks},
                                 max_len=T + STEPS)
        return logits, loss, grads, plog, cache
    logits, loss, grads, plog, cache = run(jp, toks, targets)
    decode = jax.jit(jm.decode_step)
    tok = jnp.argmax(plog[:, -1], -1)[:, None]
    greedy, step_logits, caches = [], [plog], []
    for _ in range(STEPS):
        greedy.append(np.asarray(tok))
        caches.append(jax.tree.map(np.asarray, cache))
        lg, cache = decode(jp, {"tokens": tok}, cache)
        step_logits.append(lg)
        tok = jnp.argmax(lg[:, -1], -1)[:, None]
    return dict(cfg=cfg, tree=tree, m=build_model(cfg, device="cpu"),
                p=convert.model_params(tree, cfg, device="cpu"),
                toks=toks, targets=targets, logits=logits, loss=float(loss),
                grads=named(grads, cfg), greedy=np.concatenate(greedy, 1),
                step_logits=step_logits, caches=caches)


def port_cache(tree):
    """A reference decode cache (numpy) as the port's: tensors (bf16
    included) and an int index."""
    if isinstance(tree, dict):
        return {k: port_cache(v) for k, v in tree.items()}
    a = np.array(tree)
    if a.ndim == 0:
        return int(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.fixture(scope="module")
def case():
    cfg = get_arch(ARCH, smoke=True)
    return reference_run(cfg, rwkv_tree(cfg, 2), 3)


# ---------------------------------------------------------------------------
# Checks shared with test_torch_hybrid.py
# ---------------------------------------------------------------------------

def check_forward(case):
    with torch.no_grad():
        got = case["m"].forward(case["p"], {"tokens": case["toks"]})
    assert got.dtype == torch.float32 and got.shape == (B, T,
                                                        case["cfg"].vocab)
    close(got, case["logits"], 1e-4)


def check_loss_and_gradients(case):
    params = transformer.trainable(case["p"])
    try:
        loss = case["m"].loss_fn(params, {"tokens": case["toks"],
                                          "targets": case["targets"]})
        names, leaves = zip(*params.named_parameters())
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for t in params.parameters():
            t.requires_grad_(False)
    assert abs(float(loss.detach()) - case["loss"]) <= 1e-5 * abs(
        case["loss"])
    assert sorted(names) == sorted(case["grads"])
    for n, g in zip(names, grads):
        close(g, case["grads"][n], 1e-4)


def check_greedy_decode(case, chain=True):
    """Greedy decode from the port's prefill: tokens equal to repro's, and
    each step's logits within 1e-4 x max |logit| of repro's, both from
    the port's own cache (``chain``) and from repro's cache of that
    step."""
    m, p = case["m"], case["p"]
    with torch.inference_mode():
        logits, cache = m.prefill(p, {"tokens": case["toks"]},
                                  max_len=T + STEPS)
        close(logits, case["step_logits"][0], 1e-4)
        tok = logits[:, -1].argmax(-1)[:, None]
        greedy = []
        for i in range(STEPS):
            greedy.append(tok)
            same_state, _ = m.decode_step(
                p, {"tokens": case["greedy"][:, i:i + 1]},
                port_cache(case["caches"][i]))
            close(same_state, case["step_logits"][i + 1], 1e-4)
            logits, cache = m.decode_step(p, {"tokens": tok}, cache)
            if chain:
                close(logits, case["step_logits"][i + 1], 1e-4)
            tok = logits[:, -1].argmax(-1)[:, None]
    np.testing.assert_array_equal(torch.cat(greedy, 1).numpy(),
                                  case["greedy"])
    assert cache["index"] == T + STEPS
    return cache


def check_decode_continues_the_forward(case, rel=1e-4):
    """prefill(T - 1) then one decode step gives forward(T)'s last logits
    within ``rel`` x max |logit|."""
    m, p, toks = case["m"], case["p"], case["toks"]
    with torch.inference_mode():
        full = m.forward(p, {"tokens": toks})
        _, cache = m.prefill(p, {"tokens": toks[:, :-1]}, max_len=T)
        step, _ = m.decode_step(p, {"tokens": toks[:, -1:]}, cache)
    close(step[:, 0], full[:, -1], rel)


def check_configs(name, smoke):
    got, want = get_arch(name, smoke=smoke), jget_arch(name, smoke=smoke)
    for field in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab", "d_head", "act", "qk_norm",
                  "rope_mode", "rope_base", "attn_every",
                  "rwkv_head_dim", "tie_embeddings", "source"):
        assert getattr(got, field) == getattr(want, field), field
    assert dataclasses.astuple(got.ssm) == dataclasses.astuple(want.ssm)
    assert got.head_dim == want.head_dim
    assert got.sub_quadratic and want.sub_quadratic
    assert got.attention_free == want.attention_free
    assert got.num_params() == want.num_params() == got.num_active_params()


def check_adamw_step(case, kw=None):
    """One train step of the port against repro's from the same state:
    loss, gradient norm and every parameter."""
    cfg, tree = case["cfg"], case["tree"]
    kw = kw or dict(peak_lr=1e-3, warmup_steps=0, total_steps=10, eps=1e-3)
    jp = jax.tree.map(jnp.asarray, tree)
    jstate = {"params": jp,
              "opt": jopt.init_opt_state(jp, jopt.OptimizerConfig(**kw))}
    jstep = jax.jit(jloop.build_train_step(
        jbuild_model(jget_arch(cfg.name, smoke=True)),
        jopt.OptimizerConfig(**kw)))
    batch = {"tokens": case["toks"], "targets": case["targets"]}
    jnew, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    params = transformer.trainable(convert.model_params(tree, cfg,
                                                        device="cpu"))
    state = {"params": params,
             "opt": init_opt_state(params, OptimizerConfig(**kw))}
    new, met = build_train_step(case["m"], OptimizerConfig(**kw))(state,
                                                                   batch)
    assert float(met["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-5)
    assert float(met["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]),
                                                    rel=1e-4)
    want = named(jnew["params"], cfg)
    for n, a in new["params"].named_parameters():
        np.testing.assert_allclose(a.detach().numpy(), want[n], atol=2e-6,
                                   rtol=0, err_msg=n)


def check_weight_decay(case, decayed, kept):
    """Zero gradients from nonzero weights: the update is the decay alone,
    equal to repro's; the tensors named in ``decayed`` move, those in
    ``kept`` do not."""
    cfg, tree = case["cfg"], case["tree"]
    zeros = jax.tree.map(np.zeros_like, tree)
    jnew, _, _ = jax.jit(jopt.adamw_update, static_argnums=3)(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, zeros),
        {"m": jax.tree.map(jnp.asarray, zeros),
         "v": jax.tree.map(jnp.asarray, zeros), "step": jnp.int32(0)},
        jopt.OptimizerConfig(warmup_steps=0))
    state = convert.train_state({"params": tree, "opt": {
        "m": zeros, "v": zeros, "step": np.int32(0)}}, cfg, device="cpu")
    before = {n: t.detach().numpy().copy()
              for n, t in state["params"].named_parameters()}
    params, _, _ = adamw_update(state["params"], {
        n: torch.zeros_like(t) for n, t in state["opt"]["m"].items()},
        state["opt"], OptimizerConfig(warmup_steps=0))
    got = {n: t.detach().numpy() for n, t in params.named_parameters()}
    want = named(jnew, cfg)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-7, atol=0,
                                   err_msg=n)
    for n in decayed:
        assert not np.array_equal(got[n], before[n]), n
    for n in kept:
        assert np.array_equal(got[n], before[n]), n


def reference_state(cfg, ef: bool = True):
    """repro's train state at the smoke config (with the EF residual),
    every leaf redrawn from a numpy seed, step 7, as numpy arrays."""
    jm = jbuild_model(jget_arch(cfg.name, smoke=True))
    shapes = jax.eval_shape(
        lambda key: jloop.init_train_state(
            jm, key, jopt.OptimizerConfig(),
            jloop.TrainOptions(compress_grads=ef)),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(8)

    def redraw(a):
        if a.dtype == np.int32:
            return np.asarray(7, dtype=np.int32)
        return rng.standard_normal(a.shape, dtype=np.float32).astype(a.dtype)
    return jax.tree.map(redraw, shapes)


def bits(a):
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}")


def check_reference_checkpoint_restores(cfg, tmp_path):
    """repro's checkpoint restored into a zeroed port state equals
    convert.train_state of the saved state bit for bit."""
    tree = reference_state(cfg)
    jcheckpoint.save(tree, str(tmp_path), step=3)
    like = convert.train_state(jax.tree.map(np.zeros_like, tree), cfg,
                               device="cpu")
    got = checkpoint.restore(str(tmp_path), 3, like)
    want = convert.train_state(tree, cfg, device="cpu")
    pairs = list(zip(checkpoint._leaves(want), checkpoint._leaves(got)))
    assert len(pairs) == len(checkpoint._leaves(like))
    for (na, a), (nb, b) in pairs:
        assert na == nb and a.dtype == b.dtype
        assert a.requires_grad == b.requires_grad
        assert torch.equal(a.detach(), b.detach()), na


def check_port_checkpoint_is_the_references(cfg, tmp_path):
    """The port's checkpoint of convert.train_state(tree) has repro's
    manifest and leaf files byte for byte, and repro restores it."""
    tree = reference_state(cfg)
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
        np.testing.assert_array_equal(bits(a), bits(b))


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_the_reference(smoke):
    check_configs(ARCH, smoke)


def test_full_width_parameter_count():
    """num_params() is the reference's rough count; the tensors of one
    full-width layer hold 86,049,280, the model 3,089,123,840."""
    cfg = get_arch(ARCH)
    assert cfg.num_params() == FULL_PARAMS
    layer = rwkv6.init_layer(torch.Generator().manual_seed(0), cfg)
    per_layer = sum(t.numel() for t in layer.parameters())
    assert per_layer == 86_049_280
    d = cfg.d_model
    assert 2 * cfg.vocab * d + d + cfg.n_layers * per_layer == 3_089_123_840


def test_init_params_shapes_dtypes_and_seed():
    """The port's init: the reference's shapes and dtypes, one draw per
    seed."""
    cfg = get_arch(ARCH, smoke=True)
    m = build_model(cfg, device="cpu")
    p = m.init_params(torch.Generator().manual_seed(7))
    q = m.init_params(torch.Generator().manual_seed(7))
    jtree = jax.eval_shape(jbuild_model(jget_arch(ARCH, smoke=True))
                           .init_params, jax.random.PRNGKey(0))
    for n, t in p.named_parameters():
        path, layer = convert.ref_path(n)
        leaf = jtree
        for key in path:
            leaf = leaf[key]
        assert tuple(t.shape) == leaf.shape[1 if layer is not None else 0:]
        assert str(t.dtype).split(".")[1] == str(leaf.dtype), n
    for a, b in zip(p.parameters(), q.parameters()):
        assert torch.equal(a, b)
    assert float(p.layers[0].w0[0]) == -6.0


@pytest.mark.parametrize("side", ["repro", "port"])
def test_wkv_chunked_equals_the_scan(side):
    """tests/test_models.py's case in each package: (2, 50, 3, 8) at chunk
    16, output and final state within 2e-4; then the port's chunked form
    against repro's."""
    rng = np.random.default_rng(3)
    r, k, v = (normal(rng, 2, 50, 3, 8) for _ in range(3))
    w = np.exp(-np.exp(normal(rng, 2, 50, 3, 8, scale=0.3, loc=-2.0)))
    u = normal(rng, 3, 8)
    args = (r, k, v, w, u)
    if side == "repro":
        scan = JR._wkv_scan(*map(jnp.asarray, args), 8)
        chunked = JR._wkv_chunked(*map(jnp.asarray, args), 8, chunk=16)
    else:
        targs = tuple(map(torch.as_tensor, args))
        scan = rwkv6._wkv_scan(*targs, 8)
        chunked = rwkv6._wkv_chunked(*targs, 8, chunk=16)
        ref = JR._wkv_chunked(*map(jnp.asarray, args), 8, chunk=16)
        for a, b in zip(chunked, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                       atol=2e-5)
    for a, b in zip(chunked, scan):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-4,
                                   atol=2e-4)


def test_forward_equals_the_reference(case):
    check_forward(case)


def test_loss_and_every_gradient_equal_the_reference(case):
    check_loss_and_gradients(case)


def test_prefill_and_greedy_decode_equal_the_reference(case):
    cache = check_greedy_decode(case)
    d, dh = case["cfg"].d_model, case["cfg"].rwkv_head_dim
    assert cache["wkv"].shape == (2, B, d // dh, dh, dh)
    assert cache["wkv"].dtype == torch.float32
    assert cache["tm_shift"].shape == cache["cm_shift"].shape == (2, B, d)


def test_decode_continues_the_forward(case):
    check_decode_continues_the_forward(case)


def test_scan_mode_equals_the_chunked_forward(case):
    """SEQ_MODE "scan" (the exact recurrence) gives the chunked forward's
    logits."""
    with torch.no_grad():
        chunked = case["m"].forward(case["p"], {"tokens": case["toks"]})
        rwkv6.set_seq_mode("scan")
        try:
            scan = case["m"].forward(case["p"], {"tokens": case["toks"]})
        finally:
            rwkv6.set_seq_mode("chunked", CHUNK)
    close(scan, chunked, 1e-4)


def test_adamw_step_equals_the_reference(case):
    check_adamw_step(case)


def test_weight_decay_reaches_the_stacked_vectors(case):
    """repro decays every stacked leaf of two or more dimensions: each
    layer's vectors (norms, lerps, w0, u, gn) with the layers' axis; not
    the final norm."""
    check_weight_decay(
        case, decayed=["layers.0.ln1", "layers.1.mu_x", "layers.0.w0",
                       "layers.1.u", "layers.0.gn", "layers.1.cm_mu_r"],
        kept=["final_norm"])


def test_checkpoint_saved_by_the_reference_restores_in_the_port(tmp_path):
    check_reference_checkpoint_restores(get_arch(ARCH, smoke=True),
                                        tmp_path)


def test_checkpoint_saved_by_the_port_is_the_references(tmp_path):
    check_port_checkpoint_is_the_references(get_arch(ARCH, smoke=True),
                                            tmp_path)


def test_launch_train_runs_the_smoke_config(tmp_path):
    out = launch.main(["--arch", ARCH, "--smoke", "--steps", "3",
                       "--batch", "2", "--seq", "16", "--corpus-docs", "1000",
                       "--ckpt-every", "2", "--ckpt-dir", str(tmp_path),
                       "--device", "cpu"])
    assert out["device"] == "cpu"
    assert np.isfinite([out["first_loss"], out["last_loss"]]).all()
    assert (tmp_path / "step_3" / "manifest.json").exists()
