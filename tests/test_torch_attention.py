"""The port's flash attention against ``repro``'s on the same inputs.

The plain version (what the wrapper runs on CPU tensors) is held against
``repro.models.layers.flash_attention`` over causal and non-causal masks,
GQA groups, ragged lengths, ``q_offset`` and ``kv_valid_len`` (0
included), at the default blocking and at 32 x 32 blocks; against
``repro``'s exact ``ref.attention`` and the Pallas kernel in interpret
mode while the prefix stays inside one block; and, past one block, against
the exact softmax where the Pallas kernel's block skip is wrong.  The
wrapper's choice between the kernel's two routes is checked from the
operands alone (``_route``), as the wrapper makes it before a launch.

Tolerances: float32 ``atol 1e-5`` (sums in another order); bfloat16
``atol = rtol = 2e-2`` (both sides round the probabilities to bfloat16
before P·V, and the outputs to bfloat16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jfa
from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention import ref as jref
from repro.models import layers as JL
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models import layers as L

F32 = {"atol": 1e-5, "rtol": 0.0}
BF16 = {"atol": 2e-2, "rtol": 2e-2}
DTYPES = {"float32": (torch.float32, jnp.float32, F32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, BF16)}


@pytest.fixture(params=["default", "32x32"])
def blocking(request):
    """Both packages' blocking, restored after the test."""
    saved = (JL.get_attn_blocking(), L.get_attn_blocking())
    if request.param == "32x32":
        JL.set_attn_blocking(32, 32)
        L.set_attn_blocking(32, 32)
    yield request.param
    JL.set_attn_blocking(saved[0].q_block, saved[0].kv_block,
                         saved[0].skip_masked_blocks)
    L.set_attn_blocking(saved[1].q_block, saved[1].kv_block)


def qkv(seed, b, t, s, hq, hkv, dh):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, hq, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    return q, k, v


def both(arrays, dtype):
    tdt, jdt, _ = DTYPES[dtype]
    return ([torch.tensor(a).to(tdt) for a in arrays],
            [jnp.asarray(a, dtype=jdt) for a in arrays])


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# (B, T, S, Hq, Hkv, dh, kwargs)
CASES = {
    "causal g1": (2, 40, 40, 2, 2, 16, {}),
    "causal g2 ragged": (1, 37, 37, 4, 2, 16, {}),
    "causal g4 wide head": (1, 70, 70, 4, 1, 32, {}),
    "noncausal kv_valid": (2, 20, 45, 4, 2, 16,
                           {"causal": False, "kv_valid_len": 23}),
    "noncausal full": (1, 33, 50, 2, 1, 16, {"causal": False}),
    "q_offset": (2, 16, 40, 4, 2, 16, {"q_offset": 24}),
    "q_offset kv_valid": (1, 8, 64, 2, 2, 16,
                          {"q_offset": 50, "kv_valid_len": 40}),
    "kv_valid 0": (2, 24, 24, 2, 1, 16, {"kv_valid_len": 0}),
    "prefix": (1, 48, 48, 2, 2, 16, {"prefix_len": 20}),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_model_layer(blocking, case, dtype):
    b, t, s, hq, hkv, dh, kw = CASES[case]
    (tq, tk, tv), (jq, jk, jv) = both(qkv(1, b, t, s, hq, hkv, dh), dtype)
    got = L.flash_attention(tq, tk, tv, **kw)
    want = JL.flash_attention(jq, jk, jv, **kw)
    assert got.dtype == tq.dtype and got.shape == (b, t, hq, dh)
    np.testing.assert_allclose(as_f32(got), as_f32(want), **DTYPES[dtype][2])
    if kw.get("kv_valid_len") == 0:
        assert not got.float().abs().max()


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    q, k, v = (torch.tensor(a) for a in qkv(2, 2, 30, 30, 4, 2, 16))
    before = fa.flash_attention.launches
    by_route = dict(fa.flash_attention.launches_by_route)
    got = fa.flash_attention(q, k, v, kv_valid_len=torch.tensor(17))
    want = ref.flash_attention(q, k, v, kv_valid_len=17)
    assert torch.equal(got, want)
    assert fa.flash_attention.launches == before
    assert fa.flash_attention.launches_by_route == by_route
    assert L.flash_attention is fa.flash_attention


@pytest.mark.parametrize("prefix_len", [0, 32])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_within_one_block_matches_exact_and_pallas(prefix_len, dtype):
    """(BH, T, dh) = (4, 128, 32): the exact softmax on both sides, the
    Pallas kernel in interpret mode at 64-row blocks, the blocked plain
    version and the GQA entry all agree while the prefix fits one block."""
    tol = DTYPES[dtype][2]
    (tq, tk, tv), (jq, jk, jv) = both(qkv(3, 1, 128, 128, 4, 4, 32), dtype)
    flat = [x[0].transpose(0, 1).contiguous() for x in (tq, tk, tv)]
    jflat = [x[0].transpose(1, 0, 2) for x in (jq, jk, jv)]
    exact = ref.attention(*flat, causal=True, prefix_len=prefix_len)
    np.testing.assert_allclose(
        as_f32(exact),
        as_f32(jref.attention(*jflat, causal=True, prefix_len=prefix_len)),
        **tol)
    pallas = jfa.flash_attention_pallas(*jflat, causal=True,
                                        prefix_len=prefix_len, bq=64, bk=64,
                                        interpret=True)
    np.testing.assert_allclose(as_f32(exact), as_f32(pallas), **tol)
    blocked = L.flash_attention(tq, tk, tv, prefix_len=prefix_len)
    np.testing.assert_allclose(as_f32(blocked[0].transpose(0, 1)),
                               as_f32(exact), **tol)
    np.testing.assert_allclose(
        as_f32(ops.attention(tq, tk, tv, prefix_len=prefix_len)),
        as_f32(jops.attention(jq, jk, jv, prefix_len=prefix_len,
                              use_kernel=False)), **tol)


def test_gqa_entry_matches_reference_ops():
    (tq, tk, tv), (jq, jk, jv) = both(qkv(4, 2, 50, 50, 8, 2, 16), "float32")
    np.testing.assert_allclose(
        as_f32(ops.attention(tq, tk, tv)),
        as_f32(jops.attention(jq, jk, jv, use_kernel=False)), **F32)


def test_prefix_past_one_block_matches_exact_where_pallas_does_not():
    """prefix_len 96 at T = S = 128 with 64-row blocks: the Pallas kernel's
    causal block skip ignores the prefix and drops keys 64..95 for the
    first query block (a fault of the reference kernel); the port's plain
    version equals the exact softmax."""
    (tq, tk, tv), (jq, jk, jv) = both(qkv(5, 1, 128, 128, 2, 2, 32),
                                      "float32")
    saved = L.get_attn_blocking()
    L.set_attn_blocking(64, 64)
    try:
        got = L.flash_attention(tq, tk, tv, prefix_len=96)
    finally:
        L.set_attn_blocking(saved.q_block, saved.kv_block)
    jflat = [x[0].transpose(1, 0, 2) for x in (jq, jk, jv)]
    exact = as_f32(jref.attention(*jflat, causal=True, prefix_len=96))
    pallas = as_f32(jfa.flash_attention_pallas(
        *jflat, causal=True, prefix_len=96, bq=64, bk=64, interpret=True))
    got = as_f32(got[0].transpose(0, 1))
    np.testing.assert_allclose(got, exact, **F32)
    assert np.abs(pallas - exact).max() > 0.1


@pytest.mark.parametrize("bad", ["rank", "heads", "dtype", "batch", "kv",
                                 "int"])
def test_wrapper_refuses_operands(bad):
    q = torch.zeros((1, 4, 4, 16))
    k = v = torch.zeros((1, 4, 2, 16))
    if bad == "rank":
        q = q[0]
    elif bad == "heads":
        k = v = torch.zeros((1, 4, 3, 16))
    elif bad == "dtype":
        k = k.double()
    elif bad == "batch":
        k = v = torch.zeros((2, 4, 2, 16))
    elif bad == "kv":
        v = torch.zeros((1, 5, 2, 16))
    else:
        q, k, v = (x.long() for x in (q, k, v))
    with pytest.raises((TypeError, ValueError)):
        fa.flash_attention(q, k, v)


def strided(b, n, h, dh, dtype, pad=0, offset=0):
    """A (b, n, h, dh) view of a tensor with ``pad`` more heads, starting
    ``offset`` elements into its storage."""
    base = torch.zeros(b * n * (h + pad) * dh + offset, dtype=dtype)
    return base[offset:].view(b, n, h + pad, dh)[:, :, :h]


# (dtype, dh, kwargs of strided() for q, k and v, route)
ROUTE_CASES = {
    "bf16 dh 16": (torch.bfloat16, 16, {}, "tensor_core"),
    "bf16 dh 24": (torch.bfloat16, 24, {}, "scalar"),
    "bf16 dh 128": (torch.bfloat16, 128, {}, "tensor_core"),
    "bf16 dh 256": (torch.bfloat16, 256, {}, "tensor_core"),
    "bf16 dh 272": (torch.bfloat16, 272, {}, "scalar"),
    "f32 dh 128": (torch.float32, 128, {}, "scalar"),
    "f32 dh 16": (torch.float32, 16, {}, "scalar"),
    "bf16 base 2 bytes off": (torch.bfloat16, 128, {"offset": 1}, "scalar"),
    "bf16 base 16 bytes off": (torch.bfloat16, 128, {"offset": 8},
                               "tensor_core"),
    "bf16 head-strided dh 80 (card tests)": (torch.bfloat16, 80, {"pad": 3},
                                             "tensor_core"),
    "bf16 head-strided dh 192 (chip_smoke)": (torch.bfloat16, 192,
                                              {"pad": 2}, "tensor_core"),
    "bf16 dh 16, 5 heads of padding": (torch.bfloat16, 16, {"pad": 5},
                                       "tensor_core"),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_route_is_chosen_from_the_operands(case):
    """The wrapper's choice, made from dtype, dh, strides and base
    addresses alone, as it makes it before a launch."""
    dtype, dh, kw, want = ROUTE_CASES[case]
    q = strided(2, 9, 4, dh, dtype, **kw)
    k, v = (strided(2, 9, 2, dh, dtype, **kw) for _ in range(2))
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = [*fa._strides(q), *fa._strides(k), *fa._strides(v),
               *fa._strides(out)]
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    assert fa._route(q.dtype, dh, strides, ptrs) == want


@pytest.mark.parametrize("strides,want", [
    ((0, 128, 16, 1), "scalar"),       # a broadcast batch
    ((4, 128, 16, 1), "scalar"),       # a batch stride of 4 elements
    ((24, 128, 16, 1), "tensor_core"),
])
def test_route_refuses_strides_tma_cannot_take(strides, want):
    """Strides must be positive multiples of 8 elements (16 bytes) along
    every dimension the kernel steps through; a dimension of extent 1 is
    never stepped through, so its stride does not count."""
    base = torch.zeros(4096, dtype=torch.bfloat16)
    x = base.as_strided((2, 8, 8, 16), strides)
    one = base.as_strided((1, 8, 8, 16), strides)
    ptr = base.data_ptr()
    assert fa._route(x.dtype, 16, fa._strides(x) * 4, (ptr,) * 4) == want
    assert fa._route(one.dtype, 16, fa._strides(one) * 4,
                     (ptr,) * 4) == "tensor_core"
