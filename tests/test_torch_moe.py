"""The port's MoE family against ``repro``'s on the same inputs.

The layer: ``moe_route``'s expert choices, sort order and kept masks equal
the reference's dispatch token for token (both paths: per row, and the
flat decode group), with exact ties and heavy capacity drops, at capacity
factors 1.25 and 4.0; ``moe_apply``, ``_moe_flat`` and ``moe_aux_loss``
on the same numpy-seeded weights;
``set_moe_capacity_factor``.  The models: phi3.5-moe's and moonshot's
smoke configs, weights from a numpy seed given to ``repro`` as they are
and to the port through ``convert.transformer_params``.

Tolerances: float32 layer outputs within ``1e-5 * max |out|`` (the
skewed inputs give outputs near 10); as ``tests/test_torch_models.py``'s,
float32 logits within ``1e-4 * max |logit|``; the loss
within ``1e-5`` relative and every gradient within ``1e-4 * max |g|`` of
its tensor; greedy tokens, expert indices and kept masks equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import build_model as jbuild_model
from repro.models import layers as JL
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.models import build_model, layers as L, transformer

MOE = ["moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b"]
FULL = {"moonshot-v1-16b-a3b": (28_057_995_264, 3_974_301_696),
        "phi3.5-moe-42b-a6.6b": (41_872_527_360, 6_640_373_760)}
STEPS = 8


def close(got, want, rel):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= rel * scale or err == 0.0, (err, scale)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_the_reference(name, smoke):
    got, want = get_arch(name, smoke=smoke), jget_arch(name, smoke=smoke)
    for field in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab", "d_head", "act",
                  "embed_input", "prefix_len", "source"):
        assert getattr(got, field) == getattr(want, field), field
    assert dataclasses.asdict(got.moe) == dataclasses.asdict(want.moe)
    assert got.num_params() == want.num_params()
    assert got.num_active_params() == want.num_active_params()


@pytest.mark.parametrize("name", MOE)
def test_full_width_parameter_counts(name):
    cfg = get_arch(name)
    assert (cfg.num_params(), cfg.num_active_params()) == FULL[name]


def numpy_tree(cfg, seed):
    """A float32 parameter tree in the reference's layout from a numpy
    seed (repro's init draws the same shapes and scales, slower): embed
    normal * 0.02, dense and expert weights normal * d_in ** -0.5, the
    router and every expert weight at d_model ** -0.5, norm scales
    normal * 0.1."""
    rng = np.random.default_rng(seed)
    n, d, dh = cfg.n_layers, cfg.d_model, cfg.head_dim
    e, fe = cfg.moe.num_experts, cfg.moe.d_expert

    def normal(*shape, scale):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(
            scale)
    return {"embed": normal(cfg.vocab, d, scale=0.02),
            "layers": {
                "attn": {"wq": normal(n, d, cfg.n_heads * dh, scale=d ** -.5),
                         "wk": normal(n, d, cfg.n_kv_heads * dh,
                                      scale=d ** -.5),
                         "wv": normal(n, d, cfg.n_kv_heads * dh,
                                      scale=d ** -.5),
                         "wo": normal(n, cfg.n_heads * dh, d,
                                      scale=(cfg.n_heads * dh) ** -.5)},
                "moe": {"router": normal(n, d, e, scale=d ** -.5),
                        "w_gate": normal(n, e, d, fe, scale=d ** -.5),
                        "w_up": normal(n, e, d, fe, scale=d ** -.5),
                        "w_down": normal(n, e, fe, d, scale=d ** -.5)},
                "ln1": normal(n, d, scale=0.1),
                "ln2": normal(n, d, scale=0.1)},
            "final_norm": normal(d, scale=0.1),
            "head": normal(d, cfg.vocab, scale=d ** -.5)}


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_weights():
    """Layer 0's MoE of each smoke config in float32, drawn from a numpy
    seed at the scales of the reference's ``init_moe``: (cfg, the
    weights as numpy arrays, the port's MoE)."""
    out = {}
    for i, name in enumerate(MOE):
        cfg = get_arch(name, smoke=True)
        jp = {k: v[0] for k, v in numpy_tree(cfg, 10 + i)["layers"][
            "moe"].items()}
        out[name] = (cfg, jp, L.MoE(*(torch.tensor(jp[k]) for k in (
            "router", "w_gate", "w_up", "w_down"))))
    return out


def layer_input(cfg, router, shape, kind, seed):
    """x of ``shape``: ``random``; ``ties`` (every other token 0, so all
    its router logits tie); ``skewed`` (a shared direction that the first
    top-k experts' router columns favour: heavy capacity drops)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "ties":
        x.reshape(-1, shape[-1])[::2] = 0.0
    if kind == "skewed":
        u = router[:, :cfg.moe.top_k].sum(-1)
        x += 3.0 * u / np.linalg.norm(u) * np.sqrt(shape[-1])
    return x


def mixed_input(cfg, router, path):
    """``rows``: three rows (3, 32, d), random, ties and skewed; ``flat``:
    24 decode tokens (24, 1, d), the first 12 skewed, then random ones
    with every other token 0."""
    d = cfg.d_model
    if path == "rows":
        return np.concatenate([layer_input(cfg, router, (1, 32, d), kind, i)
                               for i, kind in enumerate(
                                   ("random", "ties", "skewed"))])
    return np.concatenate([layer_input(cfg, router, (12, 1, d), kind, i)
                           for i, kind in enumerate(("skewed", "ties"))])


@functools.partial(jax.jit, static_argnums=(2, 3))
def reference_route(router, x, k, capacity):
    """The reference's routing steps (repro/models/layers.py, moe_apply's
    per-row path) over groups x (G, T, d): expert indices, the stable
    sort order and the kept mask, in sorted order."""
    G, T, _ = x.shape
    E = router.shape[1]
    probs = jax.nn.softmax(x @ router, axis=-1)
    _, expert_idx = jax.lax.top_k(probs, k)
    flat = expert_idx.reshape(G, T * k)
    sort_idx = jnp.argsort(flat, axis=-1)
    sorted_expert = jnp.take_along_axis(flat, sort_idx, -1)
    starts = jax.vmap(lambda row: jnp.searchsorted(row, jnp.arange(E)))(
        sorted_expert)
    pos = jnp.arange(T * k)[None] - jnp.take_along_axis(starts, sorted_expert,
                                                        -1)
    return expert_idx, sort_idx, pos < capacity


jmoe_apply = jax.jit(JL.moe_apply, static_argnums=(2, 3))
jmoe_flat = jax.jit(JL._moe_flat, static_argnums=(2, 3))


@pytest.mark.parametrize("cf", [1.25, 4.0])
@pytest.mark.parametrize("path", ["rows", "flat"])
@pytest.mark.parametrize("name", MOE)
def test_routing_and_outputs_equal_the_reference(moe_weights, name, path,
                                                 cf):
    """Expert indices, sort order and kept masks equal token for token, with
    exact ties and heavy capacity drops; outputs within float32
    rounding."""
    cfg, jp, mp = moe_weights[name]
    k = cfg.moe.top_k
    x = mixed_input(cfg, jp["router"], path)
    groups = x if path == "rows" else x[:, 0][None]
    C = L.capacity(groups.shape[1], cfg, cf)
    assert C == max(int(groups.shape[1] * k / cfg.moe.num_experts * cf
                        + 0.999), 1)
    r = L.moe_route(torch.tensor(groups) @ mp.router, k, C)
    idx, order, keep = map(np.asarray, reference_route(
        jnp.asarray(jp["router"]), jnp.asarray(groups), k, C))
    np.testing.assert_array_equal(r["expert_idx"].numpy(), idx)
    np.testing.assert_array_equal(r["sort_idx"].numpy(), order)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    ties = idx[1, ::2] if path == "rows" else idx[0, 12::2]
    assert (ties == np.arange(k)).all()       # the lower index first
    skewed = keep[2] if path == "rows" else keep[0]
    assert skewed.all() == (cf == 4.0)
    jparams = {n: jnp.asarray(v) for n, v in jp.items()}
    with torch.no_grad():
        if path == "rows":
            got = L.moe_apply(mp, torch.tensor(x), cfg, capacity_factor=cf)
            want = jmoe_apply(jparams, jnp.asarray(x), cfg, cf)
        else:
            got = L._moe_flat(mp, torch.tensor(x[:, 0]), cfg, cf)
            want = jmoe_flat(jparams, jnp.asarray(x[:, 0]), cfg, cf)
            whole = L.moe_apply(mp, torch.tensor(x), cfg, capacity_factor=cf)
            assert torch.equal(whole[:, 0], got)
    close(got, want, 1e-5)


def test_combine_sums_in_sorted_order_and_repeats_bitwise(moe_weights):
    """A token's output is its gated expert outputs added in sorted
    position order from zero; a second call gives the same bits."""
    cfg, jp, mp = moe_weights[MOE[0]]
    x = torch.tensor(layer_input(cfg, jp["router"], (2, 32, cfg.d_model),
                                 "skewed", 3))
    with torch.no_grad():
        got = L.moe_apply(mp, x, cfg)
        assert torch.equal(got, L.moe_apply(mp, x, cfg))
        C = L.capacity(32, cfg, L.MOE_OPTIONS["capacity_factor"])
        r = L.moe_route(x @ mp.router, cfg.moe.top_k, C)
        want = torch.zeros_like(x)
        for g in range(2):
            for i in range(32 * cfg.moe.top_k):
                e = int(r["sorted_expert"][g, i])
                t = int(r["sorted_token"][g, i])
                xt = x[g, t]
                h = (torch.nn.functional.silu(xt @ mp.w_gate[e])
                     * (xt @ mp.w_up[e])) @ mp.w_down[e]
                want[g, t] = want[g, t] + h * (
                    r["sorted_gate"][g, i] * r["keep"][g, i])
    # The expert products ran on one token here, on C slots there.
    close(got, want.numpy(), 1e-6)


@pytest.mark.parametrize("name", MOE)
def test_aux_loss_equals_the_reference(moe_weights, name):
    cfg, jp, mp = moe_weights[name]
    x = layer_input(cfg, jp["router"], (2, 32, cfg.d_model), "random", 5)
    got = L.moe_aux_loss(mp, torch.tensor(x), cfg)
    want = jax.jit(JL.moe_aux_loss, static_argnums=2)(
        {k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x), cfg)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


def test_set_moe_capacity_factor_sets_the_default(moe_weights):
    cfg, jp, mp = moe_weights[MOE[0]]
    x = layer_input(cfg, jp["router"], (2, 32, cfg.d_model), "skewed", 6)
    assert L.MOE_OPTIONS == JL.MOE_OPTIONS == {"capacity_factor": 1.25}
    try:
        L.set_moe_capacity_factor(0.5)
        JL.set_moe_capacity_factor(0.5)
        assert L.MOE_OPTIONS == JL.MOE_OPTIONS == {"capacity_factor": 0.5}
        with torch.no_grad():
            got = L.moe_apply(mp, torch.tensor(x), cfg)
            assert torch.equal(got, L.moe_apply(mp, torch.tensor(x), cfg,
                                                capacity_factor=0.5))
            assert not torch.equal(got, L.moe_apply(mp, torch.tensor(x), cfg,
                                                    capacity_factor=1.25))
    finally:
        L.set_moe_capacity_factor(1.25)
        JL.set_moe_capacity_factor(1.25)
    want = jmoe_apply({k: jnp.asarray(v) for k, v in jp.items()},
                      jnp.asarray(x), cfg, 0.5)
    close(got, want, 1e-5)


def test_init_moe_shapes_dtypes_and_scales():
    cfg = get_arch("moonshot-v1-16b-a3b", smoke=True)
    m = build_model(cfg, device="cpu")
    p = m.init_params(torch.Generator().manual_seed(3))
    jtree = jax.eval_shape(jbuild_model(jget_arch(cfg.name, smoke=True))
                           .init_params, jax.random.PRNGKey(0))
    moe = p.layers[1].moe
    assert p.layers[1].mlp is None
    for k in ("router", "w_gate", "w_up", "w_down"):
        assert tuple(getattr(moe, k).shape) == \
            jtree["layers"]["moe"][k].shape[1:]
        assert getattr(moe, k).dtype == (torch.float32 if k == "router"
                                         else torch.bfloat16)
    # w_down too is drawn at d_model ** -0.5, as the reference draws it.
    for k in ("w_gate", "w_down"):
        assert abs(float(getattr(moe, k).float().std())
                   - cfg.d_model ** -0.5) < 0.01
    assert sum(t.numel() for t in p.parameters()) == cfg.num_params()


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------

def split_grads(tree, cfg):
    return {n: t.numpy() for n, t in convert.transformer_params(
        jax.tree.map(np.asarray, tree), cfg, device="cpu").named_parameters()}


@pytest.fixture(scope="module", params=MOE)
def model_case(request):
    """One smoke model in float32 on both sides, its weights from a numpy
    seed, and repro's outputs: the forward, loss and gradients, prefill
    (one compile together) and greedy decode (one of decode_step)."""
    name = request.param
    jcfg, cfg = jget_arch(name, smoke=True), get_arch(name, smoke=True)
    jm = jbuild_model(jcfg)
    tree = numpy_tree(cfg, 1)
    jp = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (2, 24), dtype=np.int32)
    targets = np.roll(toks, -1, 1)
    targets[:, -1] = -1

    @jax.jit
    def run(params, toks, targets):
        logits = jm.forward(params, {"tokens": toks})
        loss, grads = jax.value_and_grad(jm.loss_fn)(
            params, {"tokens": toks, "targets": targets})
        plog, cache = jm.prefill(params, {"tokens": toks},
                                 max_len=24 + STEPS)
        return logits, loss, grads, plog, cache
    logits, loss, grads, plog, cache = run(jp, toks, targets)
    decode = jax.jit(jm.decode_step)
    tok = jnp.argmax(plog[:, -1], -1)[:, None]
    greedy, step_logits = [], [plog]
    for _ in range(STEPS):
        greedy.append(np.asarray(tok))
        lg, cache = decode(jp, {"tokens": tok}, cache)
        step_logits.append(lg)
        tok = jnp.argmax(lg[:, -1], -1)[:, None]
    m = build_model(cfg, device="cpu")
    p = convert.transformer_params(tree, cfg, device="cpu")
    return dict(cfg=cfg, m=m, p=p, toks=toks, targets=targets,
                logits=logits, loss=float(loss),
                grads=split_grads(grads, cfg),
                greedy=np.concatenate(greedy, 1),
                step_logits=step_logits)


def test_forward_equals_the_reference(model_case):
    c = model_case
    with torch.no_grad():
        close(c["m"].forward(c["p"], {"tokens": c["toks"]}), c["logits"],
              1e-4)


def test_loss_and_every_gradient_equal_the_reference(model_case):
    c = model_case
    params = transformer.trainable(c["p"])
    try:
        loss = c["m"].loss_fn(params, {"tokens": c["toks"],
                                       "targets": c["targets"]})
        names, leaves = zip(*params.named_parameters())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t in params.parameters():
            t.requires_grad_(False)
    assert abs(float(loss.detach()) - c["loss"]) <= 1e-5 * abs(c["loss"])
    assert sorted(names) == sorted(c["grads"])
    assert any(n.endswith("moe.router") for n in names)
    for n, g in zip(names, grads):
        close(g, c["grads"][n], 1e-4)


def test_prefill_and_greedy_decode_equal_the_reference(model_case):
    c = model_case
    m, p = c["m"], c["p"]
    with torch.inference_mode():
        logits, cache = m.prefill(p, {"tokens": c["toks"]},
                                  max_len=24 + STEPS)
        close(logits, c["step_logits"][0], 1e-4)
        tok = logits[:, -1].argmax(-1)[:, None]
        greedy = []
        for i in range(STEPS):
            greedy.append(tok)
            logits, cache = m.decode_step(p, {"tokens": tok}, cache)
            close(logits, c["step_logits"][i + 1], 1e-4)
            tok = logits[:, -1].argmax(-1)[:, None]
    np.testing.assert_array_equal(torch.cat(greedy, 1).numpy(), c["greedy"])
    assert cache["index"] == 24 + STEPS
