"""The port's VLM and audio families against ``repro``'s on the same inputs.

paligemma-3b's smoke config (patch embeddings as a bidirectional prefix,
then text tokens) and musicgen-large's (frame embeddings in, codes out),
weights from a numpy seed given to ``repro`` as they are and to the port
through ``convert.transformer_params``: the forward, the loss and every
gradient, prefill and greedy decode in float32; the VLM's attention
against ``repro.models.layers.flash_attention`` (the jnp version) with the
prefix across blocks; musicgen through ``repro``'s own entry points in
bf16; ``launch/train.py``'s stub embeddings and a train step on them.

``repro``'s layer scan cannot carry musicgen's bf16 frame stream into
float32 layers (the carry's dtype changes after the first layer), so the
float32 audio reference runs ``repro``'s own ``_embed_input``,
``_layer_apply``, ``rms_norm`` and ``chunked_lm_loss`` layer by layer, as
its scan body does; in bf16 its entry points run as they are.

Tolerances, as ``tests/test_torch_models.py``'s and
``tests/test_torch_train.py``'s: float32 logits within ``1e-4 * max
|logit|``, the loss ``1e-5`` relative, every gradient ``1e-4 * max |g|``
of its tensor, greedy tokens (codes) equal; bfloat16 logits ``atol 0.1``;
attention ``atol 1e-5`` in float32 (``tests/test_torch_attention.py``);
after a train step the parameters ``2e-6`` absolute.  One exception,
from the reference's dtypes: musicgen's layer-0 norm scale, whose
cotangent both sides round to bf16 (``grad_tolerance``): its gradient
within ``1e-2 * max |g|``, after a step within a tenth of the step size.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import build_model as jbuild_model
from repro.models import layers as JL
from repro.models import losses as jlosses
from repro.models import transformer as jT
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.launch import train as launch
from repro_torch.models import build_model, layers as L, transformer
from repro_torch.train import OptimizerConfig, build_train_step, init_opt_state

FAMILIES = ["paligemma-3b", "musicgen-large"]
FULL = {"paligemma-3b": 3_035_441_152, "musicgen-large": 2_424_506_368}
B, T, STEPS = 2, 24, 8


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

@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_the_reference(name, smoke):
    got, want = get_arch(name, smoke=smoke), jget_arch(name, smoke=smoke)
    for field in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab", "d_head", "act", "qk_norm",
                  "rope_mode", "embed_input", "prefix_len", "source"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.head_dim == want.head_dim
    assert got.num_params() == want.num_params() == got.num_active_params()


@pytest.mark.parametrize("name", FAMILIES)
def test_full_width_parameter_counts(name):
    assert get_arch(name).num_params() == FULL[name]


# ---------------------------------------------------------------------------
# Whole models in float32
# ---------------------------------------------------------------------------

def numpy_tree(cfg, seed):
    """A float32 parameter tree in the reference's layout from a numpy
    seed: embed normal * 0.02, dense normal * d_in ** -0.5, norm scales
    normal * 0.1."""
    rng = np.random.default_rng(seed)
    n, d, dh, ff = cfg.n_layers, cfg.d_model, cfg.head_dim, cfg.d_ff

    def normal(*shape, scale):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(
            scale)

    def dense(d_in, d_out):
        return normal(n, d_in, d_out, scale=d_in ** -0.5)
    mlp = ({"w_gate": dense(d, ff), "w_up": dense(d, ff),
            "w_down": dense(ff, d)} if cfg.act in L.GATED
           else {"w_in": dense(d, ff), "w_out": dense(ff, d)})
    return {"embed": normal(cfg.vocab, d, scale=0.02),
            "layers": {"attn": {"wq": dense(d, cfg.n_heads * dh),
                                "wk": dense(d, cfg.n_kv_heads * dh),
                                "wv": dense(d, cfg.n_kv_heads * dh),
                                "wo": dense(cfg.n_heads * dh, d)},
                       "mlp": mlp, "ln1": normal(n, d, scale=0.1),
                       "ln2": normal(n, d, scale=0.1)},
            "final_norm": normal(d, scale=0.1),
            "head": normal(d, cfg.vocab, scale=d ** -0.5)}


def inputs(cfg, seed):
    """A batch (embeds and, for the VLM, text tokens after the prefix;
    targets -1 over the prefix), and each decode step's input for the
    audio family (seeded frame embeddings)."""
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    targets = rng.integers(0, cfg.vocab, (B, T), dtype=np.int32)
    if cfg.family == "vlm":
        batch = {"embeds": rng.standard_normal((B, cfg.prefix_len, d),
                                               dtype=np.float32),
                 "tokens": rng.integers(0, cfg.vocab, (B, T - cfg.prefix_len),
                                        dtype=np.int32)}
        targets[:, :cfg.prefix_len] = -1
    else:
        batch = {"embeds": rng.standard_normal((B, T, d), dtype=np.float32)}
    frames = rng.standard_normal((STEPS, B, 1, d), dtype=np.float32)
    return batch, targets, frames


def layer_by_layer(cfg):
    """repro's transformer for float32 audio: its scan body (_layer_apply)
    walked layer by layer, with its own embedding, norm, head and loss."""
    def layer(params, i):
        return jax.tree.map(lambda a: a[i], params["layers"])

    def stream(params, batch):
        x = jT._embed_input(params, cfg, batch)
        positions = jnp.arange(x.shape[1])
        kvs = []
        for i in range(cfg.n_layers):
            x, kv = jT._layer_apply(layer(params, i), x, cfg, positions, 0)
            kvs.append(kv)
        return JL.rms_norm(x, params["final_norm"]), kvs

    def prefill(params, batch, max_len):
        h, kvs = stream(params, batch)
        pad = ((0, 0), (0, 0), (0, max_len - h.shape[1]), (0, 0), (0, 0))
        cache = {n: jnp.pad(jnp.stack([kv[n] for kv in kvs]), pad)
                 for n in ("k", "v")}
        cache["index"] = jnp.asarray(h.shape[1], jnp.int32)
        return h[:, -1:] @ params["head"], cache

    def decode_step(params, batch, cache):
        x = batch["embeds"].astype(JL.DEFAULT_DTYPE)
        idx = cache["index"]
        positions = idx[None, None] + jnp.zeros((x.shape[0], 1), jnp.int32)
        ks, vs = [], []
        for i in range(cfg.n_layers):
            x, c = jT._layer_apply(layer(params, i), x, cfg, positions, 0,
                                   cache={"k": cache["k"][i],
                                          "v": cache["v"][i], "index": idx})
            ks.append(c["k"])
            vs.append(c["v"])
        logits = JL.rms_norm(x, params["final_norm"]) @ params["head"]
        return logits, {"k": jnp.stack(ks), "v": jnp.stack(vs),
                        "index": idx + 1}

    return types.SimpleNamespace(
        forward=lambda p, b: stream(p, b)[0] @ p["head"],
        loss_fn=lambda p, b: jlosses.chunked_lm_loss(
            stream(p, b)[0], p["head"], b["targets"]),
        prefill=prefill, decode_step=decode_step)


def grad_tolerance(cfg, name):
    """1e-4 x max |g|, but 1e-2 for the audio family's first norm scale:
    the frame stream is bf16 until the first residual, so the cotangent of
    layer 0's normed input is rounded to bf16 on both sides, and a value
    within float32 rounding of the reference's can round to the
    neighbouring bf16 value (2 ** -8 relative)."""
    first_norm = cfg.family == "audio" and name == "layers.0.ln1"
    return 1e-2 if first_norm else 1e-4


def reference_model(cfg):
    jcfg = jget_arch(cfg.name, smoke=True)
    return (layer_by_layer(jcfg) if cfg.family == "audio"
            else jbuild_model(jcfg))


def decode_input(cfg, tok, frames, i):
    return ({"embeds": frames[i]} if cfg.family == "audio"
            else {"tokens": tok})


@pytest.fixture(scope="module", params=FAMILIES)
def case(request):
    """One smoke model in float32 on both sides and repro's outputs: the
    forward, loss and gradients, prefill (one compile together) and
    greedy decode (one of the decode step)."""
    cfg = get_arch(request.param, smoke=True)
    jm = reference_model(cfg)
    tree = numpy_tree(cfg, 2)
    jp = jax.tree.map(jnp.asarray, tree)
    batch, targets, frames = inputs(cfg, 3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def run(params, batch, targets):
        logits = jm.forward(params, batch)
        loss, grads = jax.value_and_grad(jm.loss_fn)(
            params, dict(batch, targets=targets))
        plog, cache = jm.prefill(params, batch, max_len=T + STEPS)
        return logits, loss, grads, plog, cache
    logits, loss, grads, plog, cache = run(jp, jbatch, jnp.asarray(targets))
    decode = jax.jit(jm.decode_step)
    tok = jnp.argmax(plog[:, -1], -1)[:, None]
    greedy, step_logits = [], [plog]
    for i in range(STEPS):
        greedy.append(np.asarray(tok))
        lg, cache = decode(jp, {k: jnp.asarray(v) for k, v in decode_input(
            cfg, tok, frames, i).items()}, cache)
        step_logits.append(lg)
        tok = jnp.argmax(lg[:, -1], -1)[:, None]
    names = convert.transformer_params(
        jax.tree.map(np.asarray, grads), cfg, device="cpu").named_parameters()
    return dict(cfg=cfg, m=build_model(cfg, device="cpu"),
                p=convert.transformer_params(tree, cfg, device="cpu"),
                batch=batch, targets=targets, frames=frames, logits=logits,
                loss=float(loss), grads={n: t.numpy() for n, t in names},
                greedy=np.concatenate(greedy, 1), step_logits=step_logits)


def test_forward_equals_the_reference(case):
    with torch.no_grad():
        got = case["m"].forward(case["p"], case["batch"])
    assert got.dtype == torch.float32 and got.shape == (B, T,
                                                        case["cfg"].vocab)
    close(got, case["logits"], 1e-4)


def test_loss_and_every_gradient_equal_the_reference(case):
    params = transformer.trainable(case["p"])
    try:
        loss = case["m"].loss_fn(params, dict(case["batch"],
                                              targets=case["targets"]))
        names, leaves = zip(*params.named_parameters())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t in params.parameters():
            t.requires_grad_(False)
    assert abs(float(loss.detach()) - case["loss"]) <= 1e-5 * abs(
        case["loss"])
    assert sorted(names) == sorted(case["grads"])
    for n, t, g in zip(names, leaves, grads):
        # musicgen reads no token embedding: the reference's gradient is 0.
        close(torch.zeros_like(t) if g is None else g, case["grads"][n],
              grad_tolerance(case["cfg"], n))


def test_prefill_and_greedy_decode_equal_the_reference(case):
    cfg, m, p = case["cfg"], case["m"], case["p"]
    with torch.inference_mode():
        logits, cache = m.prefill(p, case["batch"], max_len=T + STEPS)
        assert cache["k"].shape == (cfg.n_layers, B, T + STEPS,
                                    cfg.n_kv_heads, cfg.head_dim)
        close(logits, case["step_logits"][0], 1e-4)
        tok = logits[:, -1].argmax(-1)[:, None]
        greedy = []
        for i in range(STEPS):
            greedy.append(tok)
            logits, cache = m.decode_step(
                p, decode_input(cfg, tok, case["frames"], i), cache)
            close(logits, case["step_logits"][i + 1], 1e-4)
            tok = logits[:, -1].argmax(-1)[:, None]
    np.testing.assert_array_equal(torch.cat(greedy, 1).numpy(),
                                  case["greedy"])
    assert cache["index"] == T + STEPS


@pytest.mark.parametrize("prefix_len", [8, 12])
def test_vlm_attention_equals_the_jnp_reference_across_blocks(prefix_len):
    """paligemma's smoke attention (4 heads over 1, dh 16) at 8 x 8 blocks,
    the prefix one block or past one: output and gradients against
    repro.models.layers.flash_attention (not the Pallas kernel, whose
    block skip ignores the prefix)."""
    rng = np.random.default_rng(prefix_len)
    q, k, v, dout = (rng.standard_normal((B, 32, h, 16), dtype=np.float32)
                     for h in (4, 1, 1, 4))
    saved = (JL.get_attn_blocking(), L.get_attn_blocking())
    JL.set_attn_blocking(8, 8)
    L.set_attn_blocking(8, 8)
    try:
        want, vjp = jax.vjp(lambda *a: JL.flash_attention(
            *a, prefix_len=prefix_len), *map(jnp.asarray, (q, k, v)))
        wgrads = vjp(jnp.asarray(dout))
        leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        got = L.flash_attention(*leaves, prefix_len=prefix_len)
        grads = torch.autograd.grad(got, leaves, torch.tensor(dout))
    finally:
        JL.set_attn_blocking(saved[0].q_block, saved[0].kv_block,
                             saved[0].skip_masked_blocks)
        L.set_attn_blocking(saved[1].q_block, saved[1].kv_block)
    for a, b in zip((got, *grads), (want, *wgrads)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-5, rtol=0)


def test_audio_in_bf16_through_the_reference_entry_points():
    """musicgen's smoke model with bf16 weights (norms float32), as repro
    builds it: forward, prefill and a decode step within bf16 rounding."""
    cfg = get_arch("musicgen-large", smoke=True)
    tree = numpy_tree(cfg, 4)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    for part, key in (("layers", "ln1"), ("layers", "ln2"), (None, "")):
        src, dst = ((tree[part], jp[part]) if part else (tree, jp))
        key = key or "final_norm"
        dst[key] = jnp.asarray(src[key])
    jm = jbuild_model(jget_arch(cfg.name, smoke=True))
    batch, _, frames = inputs(cfg, 5)
    jbatch = {"embeds": jnp.asarray(batch["embeds"])}

    @jax.jit
    def run(params, batch, frame):
        logits = jm.forward(params, batch)
        plog, cache = jm.prefill(params, batch, max_len=T + 1)
        dlog, _ = jm.decode_step(params, {"embeds": frame}, cache)
        return logits, plog, dlog
    want = run(jp, jbatch, jnp.asarray(frames[0]))
    m = build_model(cfg, device="cpu")
    p = convert.transformer_params(jax.tree.map(np.asarray, jp), cfg,
                                   device="cpu")
    assert p.embed.dtype == torch.bfloat16
    assert p.final_norm.dtype == p.layers[0].ln1.dtype == torch.float32
    with torch.inference_mode():
        logits = m.forward(p, batch)
        plog, cache = m.prefill(p, batch, max_len=T + 1)
        dlog, _ = m.decode_step(p, {"embeds": frames[0]}, cache)
    assert logits.dtype == cache["k"].dtype == torch.bfloat16
    for a, b in zip((logits, plog, dlog), want):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b.astype(jnp.float32)),
                                   atol=0.1, rtol=0)


# ---------------------------------------------------------------------------
# launch/train.py's stub frontend
# ---------------------------------------------------------------------------

def test_stub_embeddings_are_seeded_by_the_step():
    a = launch.stub_embeds((2, 16), 64, 3, torch.device("cpu"))
    assert a.shape == (2, 16, 64) and a.dtype == torch.bfloat16
    assert torch.equal(a, launch.stub_embeds((2, 16), 64, 3,
                                             torch.device("cpu")))
    assert not torch.equal(a, launch.stub_embeds((2, 16), 64, 4,
                                                 torch.device("cpu")))
    assert abs(float(a.float().std()) - 1.0) < 0.1


def test_train_step_on_stub_embeddings_equals_the_reference():
    """One AdamW step of musicgen's smoke model in float32 on the stub
    frontend's embeddings for step 0: loss, gradient norm and every
    parameter against repro's train step (its loss taken layer by
    layer, see the module's docstring)."""
    cfg = get_arch("musicgen-large", smoke=True)
    tree = numpy_tree(cfg, 6)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (B, T),
                                             dtype=np.int32)
    embeds = launch.stub_embeds(toks.shape, cfg.d_model, 0,
                                torch.device("cpu"))
    batch = {"embeds": embeds, "targets": np.roll(toks, -1, 1)}
    kw = dict(peak_lr=1e-3, warmup_steps=0, total_steps=10, eps=1e-3)
    jp = jax.tree.map(jnp.asarray, tree)
    jstate = {"params": jp,
              "opt": jopt.init_opt_state(jp, jopt.OptimizerConfig(**kw))}
    jstep = jax.jit(jloop.build_train_step(
        reference_model(cfg), jopt.OptimizerConfig(**kw)))
    jnew, jmet = jstep(jstate, {"embeds": jnp.asarray(
        embeds.float().numpy()), "targets": jnp.asarray(batch["targets"])})
    m = build_model(cfg, device="cpu")
    params = transformer.trainable(convert.transformer_params(tree, cfg,
                                                              device="cpu"))
    state = {"params": params,
             "opt": init_opt_state(params, OptimizerConfig(**kw))}
    new, met = build_train_step(m, OptimizerConfig(**kw))(state, batch)
    assert float(met["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-5)
    assert float(met["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]),
                                                    rel=1e-4)
    want = convert.transformer_params(jax.tree.map(np.asarray,
                                                   jnew["params"]),
                                      cfg, device="cpu")
    for (n, a), (_, b) in zip(new["params"].named_parameters(),
                              want.named_parameters()):
        # The first step moves an entry at most lr; layer 0's ln1 by a
        # gradient within bf16 rounding of the reference's.
        atol = 2e-6 if grad_tolerance(cfg, n) < 1e-3 else 0.1 * kw["peak_lr"]
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), atol=atol,
                                   rtol=0, err_msg=n)


def test_launch_train_runs_the_audio_stub_frontend(tmp_path):
    out = launch.main(["--arch", "musicgen-large", "--smoke", "--steps", "3",
                       "--batch", "2", "--seq", "16", "--corpus-docs", "1000",
                       "--ckpt-every", "2", "--ckpt-dir", str(tmp_path),
                       "--device", "cpu"])
    assert out["device"] == "cpu"
    assert np.isfinite([out["first_loss"], out["last_loss"]]).all()
    assert (tmp_path / "step_3" / "manifest.json").exists()


def test_vlm_batches_need_text_tokens():
    """The VLM takes patch embeddings and text tokens; launch/train.py's
    stub drops the tokens, as the reference's does, and the model
    raises."""
    cfg = get_arch("paligemma-3b", smoke=True)
    m = build_model(cfg, device="cpu")
    p = m.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(KeyError, match="tokens"):
        m.forward(p, {"embeds": launch.stub_embeds(
            (1, 16), cfg.d_model, 0, torch.device("cpu"))})
