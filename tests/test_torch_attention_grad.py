"""The gradient of the port's flash attention against ``repro``'s.

The plain backward (``ref.flash_attention_bwd``, the oracle the backward
kernel is held to on the card and what the wrapper runs on CPU tensors) is
held against ``torch.autograd.grad`` of the plain forward and against
``jax.vjp`` of ``repro.models.layers.flash_attention`` on the same
numpy-seeded inputs and cotangent, at 16 x 16 blocks in both packages so
the cases cross block edges: causal, ``prefix_len`` inside and past one
block, ``kv_valid_len`` 0, ``q_offset``, non-causal with ``kv_valid_len``,
GQA groups of 1, 2 and 4, and ragged T, in float32 and bfloat16 (against
``repro`` in bfloat16 at one case).  ``repro``'s gradients are computed in
one jitted function for every case: one compile instead of one per case.
The ``repro_torch::flash_attention`` operator's autograd formula on CPU
tensors must give the plain gradients and count no launch.  The backward's route (tensor cores or scalar) is chosen from
its eight operands' dtype, head dim, strides and base addresses, as the
forward's is; on CPU tensors the wrapper counts nothing on either route.

Tolerances, each against the largest |gradient| of its tensor: float32
``1e-5`` (the same sums in another order); bfloat16 ``2e-2`` (``repro``'s
bf16 cast of P before P·V rounds its cotangent to bf16, which the plain
backward, working in float32 as the kernel does, does not).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ref
from repro_torch.models import layers as L

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}

CASES = [  # (id, B, T, S, Hq, Hkv, dh, kwargs)
    ("causal", 2, 40, 40, 4, 2, 16, {}),
    ("prefix inside a block", 1, 40, 40, 2, 1, 16, {"prefix_len": 10}),
    ("prefix past a block", 1, 48, 48, 4, 2, 16, {"prefix_len": 27}),
    ("kv_valid_len 0", 1, 32, 32, 2, 2, 16, {"kv_valid_len": 0}),
    ("q_offset", 1, 20, 52, 4, 1, 16, {"q_offset": 32}),
    ("non-causal kv_valid", 1, 24, 40, 4, 4, 8,
     {"causal": False, "kv_valid_len": 29}),
    ("ragged gqa 4", 2, 37, 37, 8, 2, 32, {}),
]

BF16_AGAINST_JAX = ("prefix past a block",)


@pytest.fixture
def blocks16():
    saved = (JL.get_attn_blocking(), L.get_attn_blocking())
    JL.set_attn_blocking(16, 16)
    L.set_attn_blocking(16, 16)
    yield
    JL.set_attn_blocking(saved[0].q_block, saved[0].kv_block,
                         saved[0].skip_masked_blocks)
    L.set_attn_blocking(saved[1].q_block, saved[1].kv_block)


def operands(seed, b, t, s, hq, hkv, dh):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, t, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh),
             (b, t, hq, dh))]


def case_operands(case):
    return operands(len(case[0]), *case[1:7])


@pytest.fixture(scope="module")
def jax_grads():
    """``repro``'s (dq, dk, dv) by (case id, dtype), at 16 x 16 blocks."""
    saved = JL.get_attn_blocking()
    JL.set_attn_blocking(16, 16)
    runs = [(c, dt) for c in CASES for dt in DTYPES
            if dt == "float32" or c[0] in BF16_AGAINST_JAX]

    def all_vjps(arrays):
        out = []
        for (case, _), (q, k, v, do) in zip(runs, arrays):
            kw = case[7]
            _, vjp = jax.vjp(
                lambda a, b, c: JL.flash_attention(a, b, c, **kw), q, k, v)
            out.append(vjp(do))
        return out
    arrays = [[jnp.asarray(a, dtype=DTYPES[dt][1])
               for a in case_operands(case)] for case, dt in runs]
    try:
        grads = jax.jit(all_vjps)(arrays)
    finally:
        JL.set_attn_blocking(saved.q_block, saved.kv_block,
                             saved.skip_masked_blocks)
    return {(case[0], dt): [np.asarray(g.astype(jnp.float32)) for g in gs]
            for (case, dt), gs in zip(runs, grads)}


def close(got, want, dtype, what):
    got = got.float().numpy()
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() if got.size else 0.0
    scale = np.abs(want).max() if want.size else 0.0
    assert err <= TOL[dtype] * scale or err == 0.0, (what, err, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_backward_matches_autograd_and_jax(blocks16, jax_grads, case,
                                                 dtype):
    kw = case[7]
    tdt = DTYPES[dtype][0]
    arrays = case_operands(case)
    q, k, v, dout = [torch.tensor(a).to(tdt) for a in arrays]
    out = ref.flash_attention(q, k, v, **kw)
    grads = ref.flash_attention_bwd(q, k, v, out, dout, **kw)
    for g, x in zip(grads, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape

    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention(*leaves, **kw), leaves,
                               dout)
    for name, g, w in zip("qkv", grads, want):
        close(g, w.float().numpy(), dtype, f"d{name} vs autograd")
    if kw.get("kv_valid_len") == 0:
        assert not any(bool(g.float().abs().max()) for g in grads)

    if dtype == "bfloat16" and case[0] not in BF16_AGAINST_JAX:
        return
    for name, g, w in zip("qkv", grads, jax_grads[case[0], dtype]):
        close(g, w, dtype, f"d{name} vs jax")


def test_function_on_cpu_gives_the_plain_gradients_and_counts_nothing(
        blocks16):
    arrays = operands(5, 2, 37, 37, 4, 2, 16)
    q, k, v, dout = [torch.tensor(a) for a in arrays]
    kw = {"prefix_len": 20, "q_offset": 0}
    fwd, bwd = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = L.flash_attention(*leaves, **kw)
    assert out.grad_fn is not None and "repro_torch_flash_attention" in type(
        out.grad_fn).__name__
    got = torch.autograd.grad(out, leaves, dout)
    want = ref.flash_attention_bwd(q, k, v, out.detach(), dout, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # Without grad the call is the serving one: no autograd node.
    with torch.no_grad():
        assert L.flash_attention(*leaves, **kw).grad_fn is None
    assert fa.flash_attention(q, k, v, **kw).grad_fn is None
    assert (fa.flash_attention.launches, fa.flash_attention_bwd.launches) \
        == (fwd, bwd)


def strided(b, n, h, dh, dtype, pad=0, offset=0, batch_stride=None):
    """A (b, n, h, dh) view of a tensor with ``pad`` more heads, starting
    ``offset`` elements into its storage; ``batch_stride`` 0 broadcasts one
    batch row, as an expanded cotangent does."""
    rows = 1 if batch_stride == 0 else b
    base = torch.zeros(rows * n * (h + pad) * dh + offset, dtype=dtype)
    x = base[offset:].view(rows, n, h + pad, dh)[:, :, :h]
    return x.expand(b, n, h, dh) if batch_stride == 0 else x


# (dtype, dh, strided() kwargs by operand, "all" for q, k, v, out and
# dout, route); dq, dk and dv are new tensors, as the wrapper makes them.
BWD_ROUTE_CASES = {
    "bf16 dh 16": (torch.bfloat16, 16, {}, "tensor_core"),
    "bf16 dh 24": (torch.bfloat16, 24, {}, "scalar"),
    "bf16 dh 128": (torch.bfloat16, 128, {}, "tensor_core"),
    "bf16 dh 256": (torch.bfloat16, 256, {}, "tensor_core"),
    "bf16 dh 272": (torch.bfloat16, 272, {}, "scalar"),
    "f32 dh 128": (torch.float32, 128, {}, "scalar"),
    "bf16 head-strided dh 80": (torch.bfloat16, 80, {"all": {"pad": 3}},
                                "tensor_core"),
    "bf16 head-strided dh 192": (torch.bfloat16, 192, {"all": {"pad": 2}},
                                 "tensor_core"),
    "bf16 q 2 bytes off": (torch.bfloat16, 128, {"q": {"offset": 1}},
                           "scalar"),
    "bf16 out 16 bytes off": (torch.bfloat16, 128, {"out": {"offset": 8}},
                              "tensor_core"),
    "bf16 dout 2 bytes off": (torch.bfloat16, 128, {"dout": {"offset": 1}},
                              "scalar"),
    "bf16 dout 2 bytes off, dh 64": (torch.bfloat16, 64,
                                     {"dout": {"offset": 1}}, "scalar"),
    "bf16 dout broadcast over the batch": (
        torch.bfloat16, 128, {"dout": {"batch_stride": 0}}, "scalar"),
}


@pytest.mark.parametrize("case", sorted(BWD_ROUTE_CASES))
def test_backward_route_is_chosen_from_the_operands(case):
    """The backward's route, chosen from dtype, dh, and the strides and
    base addresses of all eight operands (the gradients too) as the
    wrapper chooses it before a launch; on these CPU tensors the wrapper
    runs the plain backward and counts no launch."""
    dtype, dh, kw, want = BWD_ROUTE_CASES[case]

    def make(name, h):
        return strided(2, 9, h, dh, dtype, **kw.get(name, kw.get("all", {})))
    q, k, v, out, dout = (make(n, h) for n, h in (
        ("q", 4), ("k", 2), ("v", 2), ("out", 4), ("dout", 4)))
    grads = (torch.empty(q.shape, dtype=dtype),
             torch.empty(k.shape, dtype=dtype),
             torch.empty(k.shape, dtype=dtype))
    strides, ptrs = fa._layout((q, k, v, out, dout, *grads))
    assert fa._route(dtype, dh, strides.tolist(), ptrs) == want
    before = (fa.flash_attention_bwd.launches,
              dict(fa.flash_attention_bwd.launches_by_route))
    got = fa.flash_attention_bwd(q, k, v, out, dout)
    assert [g.shape for g in got] == [x.shape for x in (q, k, v)]
    assert (fa.flash_attention_bwd.launches,
            dict(fa.flash_attention_bwd.launches_by_route)) == before
