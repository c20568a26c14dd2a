"""The port's dense transformer against ``repro``'s on the same weights.

Layers (``rms_norm``, ``rope``, ``mlp_apply``) take the same numpy-seeded
inputs on both sides.  Whole models take the weights of ``repro``'s own
``init_params`` through ``convert.transformer_params``.

Tolerances: float32 layers ``atol 1e-5``, float32 logits within
``1e-4 * max |logit|`` (matmuls and sums in another order); bfloat16
logits ``atol 0.1``, about twice ``repro``'s own bfloat16-against-float32
gap at the smoke size (0.054 at max |logit| 4.45 for qwen3's smoke
config).  Greedy tokens must be equal in float32.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import list_archs as jlist_archs
from repro.models import build_model as jbuild_model
from repro.models import layers as JL
from repro.serve import greedy_generate as jgreedy
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.kernels import _backend
from repro_torch.models import build_model, layers as L, transformer
from repro_torch.serve import greedy_generate

DENSE = ["qwen3-1.7b", "chatglm3-6b", "minitron-4b", "nemotron-4-340b"]


def close_logits(got, want, rel=1e-4):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def models(name, dtype, seed=0):
    """(repro bundle, repro params, port bundle, port params) for a smoke
    config; float32 casts the params on both sides."""
    jcfg, cfg = jget_arch(name, smoke=True), get_arch(name, smoke=True)
    jm = jbuild_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tree = jax.tree.map(np.asarray, jp)
    m = build_model(cfg, device="cpu")
    p = convert.transformer_params(
        tree, cfg, device="cpu",
        dtype=torch.float32 if dtype == "float32" else None)
    return jm, jp, m, p


def tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    got = L.rms_norm(torch.tensor(x).to(tdt), torch.tensor(scale))
    want = JL.rms_norm(jnp.asarray(x, dtype=getattr(jnp, dtype)),
                       jnp.asarray(scale))
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("positions", ["prefill", "decode"])
@pytest.mark.parametrize("mode", ["full", "half", "none"])
def test_rope_matches(mode, positions):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    if positions == "prefill":
        pos = np.arange(7)
    else:
        x = x[:, :1]
        pos = np.array([[11], [11]])
    got = L.rope(torch.tensor(x), torch.tensor(pos), 10000.0, mode)
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "sq_relu", "gelu"])
def test_mlp_apply_matches(act):
    cfg = types.SimpleNamespace(d_model=32, d_ff=48, act=act)
    rng = np.random.default_rng(2)
    names = (["w_gate", "w_up", "w_down"] if act in L.GATED
             else ["w_in", "w_out"])
    shapes = {"w_gate": (32, 48), "w_up": (32, 48), "w_down": (48, 32),
              "w_in": (32, 48), "w_out": (48, 32)}
    w = {n: (rng.standard_normal(shapes[n]) / 6).astype(np.float32)
         for n in names}
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    got = L.mlp_apply(L.MLP(**{n: torch.tensor(a) for n, a in w.items()}),
                      torch.tensor(x), cfg)
    want = JL.mlp_apply({n: jnp.asarray(a) for n, a in w.items()},
                        jnp.asarray(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------

def test_qwen3_smoke_float32_matches_through_decode():
    jm, jp, m, p = models("qwen3-1.7b", "float32")
    prompt = tokens(m.cfg.vocab, (2, 12))
    with torch.inference_mode():
        close_logits(m.forward(p, {"tokens": prompt}),
                     jm.forward(jp, {"tokens": jnp.asarray(prompt)}))
        logits, cache = m.prefill(p, {"tokens": prompt}, max_len=24)
    jlogits, jcache = jm.prefill(jp, {"tokens": jnp.asarray(prompt)},
                                 max_len=24)
    close_logits(logits, jlogits)
    assert cache["index"] == int(jcache["index"]) == 12
    for key in ("k", "v"):
        assert tuple(cache[key].shape) == jcache[key].shape
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), atol=1e-5,
                                   rtol=0)
    steps = tokens(m.cfg.vocab, (8, 2, 1), seed=3)
    for tok in steps:
        with torch.inference_mode():
            logits, cache = m.decode_step(p, {"tokens": tok}, cache)
        jlogits, jcache = jm.decode_step(jp, {"tokens": jnp.asarray(tok)},
                                         jcache)
        close_logits(logits, jlogits)
    assert cache["index"] == int(jcache["index"]) == 20
    got = greedy_generate(m, p, prompt, steps=8).numpy()
    want = np.asarray(jgreedy(jm, jp, jnp.asarray(prompt), steps=8))
    np.testing.assert_array_equal(got, want)


def test_qwen3_smoke_bfloat16_within_bf16_rounding():
    jm, jp, m, p = models("qwen3-1.7b", "bfloat16")
    assert p.embed.dtype == torch.bfloat16
    assert p.final_norm.dtype == torch.float32
    prompt = tokens(m.cfg.vocab, (2, 12))
    with torch.inference_mode():
        got = m.forward(p, {"tokens": prompt})
        logits, cache = m.prefill(p, {"tokens": prompt}, max_len=16)
        dlogits, _ = m.decode_step(p, {"tokens": prompt[:, :1]}, cache)
    assert got.dtype == torch.bfloat16
    want = jm.forward(jp, {"tokens": jnp.asarray(prompt)})
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, max_len=16)
    jd, _ = jm.decode_step(jp, {"tokens": jnp.asarray(prompt[:, :1])}, jc)
    for a, b in ((got, want), (logits, jl), (dlogits, jd)):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b.astype(jnp.float32)),
                                   atol=0.1, rtol=0)


@pytest.mark.parametrize("name", DENSE[1:])
def test_other_dense_smoke_configs_forward(name):
    jm, jp, m, p = models(name, "float32", seed=4)
    prompt = tokens(m.cfg.vocab, (2, 10), seed=5)
    with torch.inference_mode():
        got = m.forward(p, {"tokens": prompt})
    close_logits(got, jm.forward(jp, {"tokens": jnp.asarray(prompt)}))


@pytest.mark.parametrize("name", DENSE)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_the_reference(name, smoke):
    got, want = get_arch(name, smoke=smoke), jget_arch(name, smoke=smoke)
    for field in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab", "d_head", "act", "qk_norm",
                  "rope_mode", "rope_base", "prefix_len", "tie_embeddings",
                  "source"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.head_dim == want.head_dim
    assert got.num_params() == want.num_params()


def test_qwen3_full_width_parameter_count():
    assert get_arch("qwen3-1.7b").num_params() == 2_031_732_736


def test_init_params_shapes_dtypes_and_seed():
    cfg = get_arch("qwen3-1.7b", smoke=True)
    m = build_model(cfg, device="cpu")
    p = m.init_params(torch.Generator().manual_seed(7))
    q = m.init_params(torch.Generator().manual_seed(7))
    jtree = jbuild_model(jget_arch("qwen3-1.7b", smoke=True)).init_params(
        jax.random.PRNGKey(0))
    assert tuple(p.embed.shape) == jtree["embed"].shape
    assert tuple(p.head.shape) == jtree["head"].shape
    assert tuple(p.layers[0].attn.wq.shape) == jtree["layers"]["attn"][
        "wq"].shape[1:]
    assert p.embed.dtype == p.layers[1].mlp.w_down.dtype == torch.bfloat16
    assert p.layers[0].attn.q_norm.dtype == torch.float32
    assert not p.layers[0].ln1.any() and not p.final_norm.any()
    total = sum(t.numel() for t in p.parameters())
    # num_params() leaves out the qk-norm scales, as the reference's does.
    assert total == cfg.num_params() + cfg.n_layers * 2 * cfg.head_dim
    for a, b in zip(p.parameters(), q.parameters()):
        assert torch.equal(a, b)
    assert abs(float(p.embed.float().std()) - 0.02) < 0.002
    assert abs(float(p.layers[0].mlp.w_up.float().std())
               - cfg.d_model ** -0.5) < 0.02


def test_cache_spec_matches_prefill():
    cfg = get_arch("chatglm3-6b", smoke=True)
    m = build_model(cfg, device="cpu")
    p = m.init_params(torch.Generator().manual_seed(0))
    spec = m.cache_spec(3, 20)
    _, cache = m.prefill(p, {"tokens": tokens(cfg.vocab, (3, 6))},
                         max_len=20)
    assert tuple(cache["k"].shape) == spec["k"][0]
    assert cache["k"].dtype == spec["k"][1]


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(get_arch("qwen3-1.7b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.transformer_params({}, get_arch("qwen3-1.7b", smoke=True))
    assert _backend.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("name", jlist_archs())
def test_every_reference_arch_builds_in_the_port(name):
    """Every architecture of repro is registered in the port: its smoke
    model builds on the CPU and runs one prefill."""
    cfg = get_arch(name, smoke=True)
    m = build_model(cfg, device="cpu")
    p = m.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {}
    if cfg.embed_input:
        n = cfg.prefix_len if cfg.family == "vlm" else 12
        batch["embeds"] = rng.standard_normal((2, n, cfg.d_model),
                                              dtype=np.float32)
    if cfg.family != "audio":
        batch["tokens"] = tokens(cfg.vocab, (2, 12))
    with torch.inference_mode():
        logits, cache = m.prefill(p, batch, max_len=20)
    assert logits.shape == (2, 1, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    assert cache["index"] == (cfg.prefix_len if cfg.family == "vlm"
                              else 0) + 12
    if cfg.family in transformer.FAMILIES:
        return
    with pytest.raises(ValueError, match="not a transformer"):
        transformer.check_family(cfg)


def test_decode_past_the_cache_raises_and_loss_is_for_training():
    cfg = get_arch("qwen3-1.7b", smoke=True)
    m = build_model(cfg, device="cpu")
    p = m.init_params(torch.Generator().manual_seed(0))
    _, cache = m.prefill(p, {"tokens": tokens(cfg.vocab, (1, 4))},
                         max_len=4)
    with pytest.raises(IndexError):
        m.decode_step(p, {"tokens": np.zeros((1, 1), np.int64)}, cache)
    # The training loss: repro's chunked CE on the same float32 weights.
    jm, jp, m, p = models("qwen3-1.7b", "float32")
    toks = tokens(cfg.vocab, (2, 24))
    targets = np.roll(toks, -1, 1)
    targets[:, -1] = -1
    want = float(jm.loss_fn(jp, {"tokens": jnp.asarray(toks),
                                 "targets": jnp.asarray(targets)}))
    got = m.loss_fn(p, {"tokens": toks, "targets": targets})
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= 1e-5 * abs(want)
