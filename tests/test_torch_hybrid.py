"""The port's Zamba2 hybrid (Mamba-2 layers and one shared attention
block) against ``repro``'s on the same inputs.

zamba2-2.7b's smoke config (4 Mamba-2 layers in 2 groups, so the shared
block runs twice with two KV caches) in float32, weights from a numpy seed
given to ``repro`` as they are and to the port through
``convert.model_params``.  The SSD chunk is 16 in both packages for the
whole module (``mamba2.CHUNK``, set here, not in ``repro``'s files), so the
40-position prompt crosses two chunk boundaries and ends in a ragged tail.
Tolerances are ``tests/test_torch_ssm.py``'s, whose checks this module
runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import build_model as jbuild_model
from repro.models import mamba2 as JM
from repro_torch.configs import get_arch
from repro_torch.launch import train as launch
from repro_torch.models import hybrid, mamba2, transformer
from test_torch_ssm import (B, STEPS, T, check_adamw_step, check_configs,
                            check_decode_continues_the_forward,
                            check_forward, check_greedy_decode,
                            check_loss_and_gradients,
                            check_port_checkpoint_is_the_references,
                            check_reference_checkpoint_restores,
                            check_weight_decay, close, dense, normal,
                            reference_run)

ARCH = "zamba2-2.7b"
FULL_PARAMS = 2_410_037_760          # the reference's rough count
CHUNK = 16


@pytest.fixture(autouse=True, scope="module")
def chunk_16():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JM, "CHUNK", CHUNK)
        mp.setattr(mamba2, "CHUNK", CHUNK)
        yield


def hybrid_tree(cfg, seed):
    """A float32 tree in the reference's layout from a numpy seed, every
    leaf nonzero: decays A_log and dt_bias normal * 0.5, D about 1, conv
    normal * 0.3, norms normal * 0.1."""
    rng = np.random.default_rng(seed)
    n, d = cfg.n_layers, cfg.d_model
    d_in, H, ds, cw = mamba2.dims(cfg)
    ch = d_in + 2 * ds
    dh, ff = cfg.head_dim, cfg.d_ff

    def one(d_in, d_out):
        return dense(rng, 1, d_in, d_out)[0]
    return {
        "embed": normal(rng, cfg.vocab, d, scale=0.02),
        "mamba": {"ln": normal(rng, n, d, scale=0.1),
                  "in_proj": dense(rng, n, d, 2 * d_in + 2 * ds + H),
                  "conv_w": normal(rng, n, cw, ch, scale=0.3),
                  "conv_b": normal(rng, n, ch, scale=0.1),
                  "A_log": normal(rng, n, H, scale=0.5),
                  "D": normal(rng, n, H, scale=0.1, loc=1.0),
                  "dt_bias": normal(rng, n, H, scale=0.5),
                  "gn": normal(rng, n, d_in, scale=0.1),
                  "out_proj": dense(rng, n, d_in, d)},
        "shared_attn": {"attn": {"wq": one(d, cfg.n_heads * dh),
                                 "wk": one(d, cfg.n_kv_heads * dh),
                                 "wv": one(d, cfg.n_kv_heads * dh),
                                 "wo": one(cfg.n_heads * dh, d)},
                        "ln1": normal(rng, d, scale=0.1),
                        "ln2": normal(rng, d, scale=0.1),
                        "mlp": {"w_in": one(d, ff), "w_out": one(ff, d)}},
        "final_norm": normal(rng, d, scale=0.1),
        "head": normal(rng, d, cfg.vocab, scale=d ** -0.5)}


@pytest.fixture(scope="module")
def case():
    cfg = get_arch(ARCH, smoke=True)
    return reference_run(cfg, hybrid_tree(cfg, 4), 5)


@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_the_reference(smoke):
    check_configs(ARCH, smoke)


def test_full_width_parameter_count():
    """num_params() is the reference's rough count; the tensors of one
    full-width Mamba-2 layer hold 39,888,240, the shared block 78,648,320
    and the model 2,396,455,840."""
    cfg = get_arch(ARCH)
    assert cfg.num_params() == FULL_PARAMS
    gen = torch.Generator().manual_seed(0)
    layer = sum(t.numel() for t in mamba2.init_layer(gen, cfg).parameters())
    shared = sum(t.numel() for t in transformer.init_layer(
        gen, cfg).parameters())
    assert (layer, shared) == (39_888_240, 78_648_320)
    d = cfg.d_model
    assert (2 * cfg.vocab * d + d + cfg.n_layers * layer + shared
            == 2_396_455_840)


def test_forward_equals_the_reference(case):
    check_forward(case)


def test_loss_and_every_gradient_equal_the_reference(case):
    check_loss_and_gradients(case)


def test_prefill_and_greedy_decode_equal_the_reference(case):
    """Tokens equal; each step's logits within 1e-4 x max of repro's from
    repro's cache of that step.  Along the port's own cache they drift
    further: both packages round the conv state to bf16 after every step
    (``repro``'s cast), and a float32 value within rounding of the
    reference's can round to the neighbouring bf16 value, 2 ** -8 away
    (3 of this prompt's 3,840 conv elements after the prefill)."""
    cache = check_greedy_decode(case, chain=False)
    cfg = case["cfg"]
    G = hybrid.n_groups(cfg)
    assert G == 2
    assert cache["k"].shape == cache["v"].shape == (
        G, B, T + STEPS, cfg.n_kv_heads, cfg.head_dim)
    d_in, H, ds, cw = mamba2.dims(cfg)
    assert cache["mamba"]["conv"].shape == (cfg.n_layers, B, cw - 1,
                                            d_in + 2 * ds)
    assert cache["mamba"]["conv"].dtype == torch.bfloat16
    assert cache["mamba"]["h"].shape == (cfg.n_layers, B, H,
                                         cfg.ssm.head_dim, ds)
    spec = case["m"].cache_spec(B, T + STEPS)
    assert spec["k"][0] == tuple(cache["k"].shape)
    assert spec["mamba"]["h"] == (tuple(cache["mamba"]["h"].shape),
                                  torch.float32)


def test_decode_continues_the_forward(case):
    """Within 1e-2 x max: the decode step reads the conv state rounded to
    bf16 (``repro``'s cast), the forward its float32 inputs.  ``repro``'s
    own gap on these inputs is 2.1e-3 x max, the port's the same."""
    check_decode_continues_the_forward(case, rel=1e-2)


def test_ssd_chunked_equals_the_reference_and_the_recurrence():
    """_ssd_chunked at chunk 16 over 40 positions against repro's, and
    against the recurrent steps from a zero state."""
    rng = np.random.default_rng(6)
    xh = normal(rng, 2, 40, 3, 8)
    Bc, Cc = normal(rng, 2, 40, 5), normal(rng, 2, 40, 5)
    dt = np.log1p(np.exp(normal(rng, 2, 40, 3))).astype(np.float32)
    a = -np.exp(normal(rng, 3, scale=0.5))
    h0 = np.zeros((2, 3, 8, 5), np.float32)
    args = (xh, Bc, Cc, dt, a, h0)
    want = JM._ssd_chunked(*map(jnp.asarray, args))
    got = mamba2._ssd_chunked(*map(torch.as_tensor, args))
    steps = mamba2._ssd_scan(*map(torch.as_tensor, args))
    for x, y, z in zip(got, want, steps):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(x.numpy(), z.numpy(), rtol=2e-4,
                                   atol=2e-4)


def test_causal_conv_promotes_a_bf16_input_to_float32():
    """The bf16 conv input against the float32 conv_w gives float32, equal
    to repro's; a carried state continues the sequence."""
    rng = np.random.default_rng(7)
    x = normal(rng, 2, 9, 6).astype(jnp.bfloat16)
    w, b = normal(rng, 4, 6), normal(rng, 6)
    want = JM._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    xt = torch.as_tensor(x.view(np.int16)).view(torch.bfloat16)
    got = mamba2._causal_conv(xt, torch.as_tensor(w), torch.as_tensor(b))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    tail = mamba2._causal_conv(xt[:, 5:], torch.as_tensor(w),
                               torch.as_tensor(b), prev=xt[:, 2:5])
    close(tail, got[:, 5:], 1e-6)


def test_adamw_step_equals_the_reference(case):
    check_adamw_step(case)


def test_weight_decay_reaches_the_stacked_vectors_not_the_shared_norms(
        case):
    """repro decays the stacked Mamba-2 vectors (each has the layers' axis)
    and the shared block's matrices, but not the shared block's norm
    scales, one vector each, nor the final norm."""
    check_weight_decay(
        case, decayed=["mamba.0.ln", "mamba.1.conv_b", "mamba.2.A_log",
                       "mamba.3.D", "mamba.0.dt_bias", "mamba.1.gn",
                       "shared_attn.attn.wq", "shared_attn.mlp.w_in"],
        kept=["shared_attn.ln1", "shared_attn.ln2", "final_norm"])


def test_checkpoint_saved_by_the_reference_restores_in_the_port(tmp_path):
    check_reference_checkpoint_restores(get_arch(ARCH, smoke=True),
                                        tmp_path)


def test_checkpoint_saved_by_the_port_is_the_references(tmp_path):
    check_port_checkpoint_is_the_references(get_arch(ARCH, smoke=True),
                                            tmp_path)


def test_shared_block_keeps_one_cache_per_application(case):
    """The shared weights run twice a token, each application writing its
    own KV cache: after a decode step the two caches differ at the new
    position, and each equals repro's."""
    m, p = case["m"], case["p"]
    with torch.inference_mode():
        _, cache = m.prefill(p, {"tokens": case["toks"]}, max_len=T + 1)
        _, cache = m.decode_step(p, {"tokens": case["toks"][:, :1]}, cache)
    jm = jbuild_model(jget_arch(ARCH, smoke=True))
    jp = jax.tree.map(jnp.asarray, case["tree"])
    _, jcache = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t},
                                                max_len=T + 1))(
        jp, case["toks"])
    _, jcache = jax.jit(jm.decode_step)(
        jp, {"tokens": jnp.asarray(case["toks"][:, :1])}, jcache)
    assert not torch.equal(cache["k"][0, :, T], cache["k"][1, :, T])
    for name in ("k", "v"):
        close(cache[name], jcache[name], 1e-4)
    close(cache["mamba"]["h"], jcache["mamba"]["h"], 1e-4)


def test_launch_train_runs_the_smoke_config(tmp_path):
    out = launch.main(["--arch", ARCH, "--smoke", "--steps", "3",
                       "--batch", "2", "--seq", "16", "--corpus-docs", "1000",
                       "--ckpt-every", "2", "--ckpt-dir", str(tmp_path),
                       "--device", "cpu"])
    assert out["device"] == "cpu"
    assert np.isfinite([out["first_loss"], out["last_loss"]]).all()
    assert (tmp_path / "step_3" / "manifest.json").exists()
