"""Causal (+ prefix-LM) flash attention: the CUDA kernel
``csrc/flash_attention.cu`` and its backward ``csrc/flash_attention_bwd.cu``.

The Hopper counterpart of the TPU kernel ``flash_attention_pallas``,
computing the function of ``repro.models.layers.flash_attention``: online
softmax attention with native GQA over the reference's ``(B, T, H, dh)``
layout, ragged T and S, ``q_offset``, a scalar ``kv_valid_len`` and a
bidirectional ``prefix_len``; rows with no visible key give 0.

:func:`flash_attention` launches the kernel on CUDA tensors and runs the
plain version (:mod:`.ref`) on CPU tensors; there is no fallback from one
to the other.  The kernel has two routes, chosen before the launch from
the operands alone (:func:`_route`): ``tensor_core`` (wgmma and TMA) for
bfloat16 operands it can take, ``scalar`` for float32 and every other
bfloat16 input.  A launch error raises; nothing retries the other route.

:func:`flash_attention_bwd` launches the backward kernel (the gradient of
the same function, which the TPU kernel never had) on CUDA tensors and runs
the plain backward on CPU tensors.  It has the same two routes, chosen the
same way from its eight operands.

Both kernels are PyTorch operators (``torch.ops.repro_torch.flash_attention``
and ``torch.ops.repro_torch.flash_attention_bwd``, registered with
:func:`torch.library.custom_op`), so the dispatcher sees every call: a
dispatch mode counts them (:mod:`repro_torch.launch.op_cost`), fake or meta
tensors reach only their shape functions (which launch nothing), each has a
FLOP formula in :mod:`torch.utils.flop_counter`'s registry (4 dh forward
and 10 dh backward per visible (query, key) pair), and the forward's
autograd formula is the backward operator.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _backend

from . import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"scalar": 0, "tensor_core": 1}
_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
             + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 10
                 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
_INT_MAX = 2 ** 31 - 1


def _lib():
    lib = _backend.load("flash_attention")
    if lib.flash_attention.argtypes is None:
        lib.flash_attention.argtypes = _ARGTYPES
        lib.flash_attention.restype = ctypes.c_int
        lib.flash_attention_max_head_dim.argtypes = []
        lib.flash_attention_max_head_dim.restype = ctypes.c_int
    return lib


def _bwd_lib():
    lib = _backend.load("flash_attention_bwd")
    if lib.flash_attention_bwd.argtypes is None:
        lib.flash_attention_bwd.argtypes = _BWD_ARGTYPES
        lib.flash_attention_bwd.restype = ctypes.c_int
        lib.flash_attention_bwd_max_head_dim.argtypes = []
        lib.flash_attention_bwd_max_head_dim.restype = ctypes.c_int
    return lib


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"flash_attention: {name} must be a tensor")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D, got "
                             f"shape {tuple(t.shape)}")
        if not t.dtype.is_floating_point:
            raise TypeError(f"flash_attention: {name} must be floating "
                            f"point, got {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q "
                             f"on {q.device}")
    b, _, hq, dh = q.shape
    if k.shape != v.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} differ")
    if k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k {tuple(k.shape)}")
    if k.shape[2] == 0 or hq % k.shape[2]:
        raise ValueError(f"flash_attention: {hq} query heads are not a "
                         f"multiple of {k.shape[2]} kv heads")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")


def _check_operands(fn: str, operands, max_dh: int, q_offset: int,
                    prefix_len: int) -> None:
    """Raises on CUDA operands the kernels do not take: a dtype other than
    float32 or bfloat16, a head dim that is not contiguous or exceeds
    ``max_dh``, sizes past int32 positions.  ``operands`` are (name,
    tensor) pairs, q first, then k."""
    q, k = operands[0][1], operands[1][1]
    if q.dtype not in _DTYPES:
        raise TypeError(f"{fn}: the kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    b, t, hq, dh = q.shape
    for name, x in operands:
        if dh > 1 and x.numel() and x.stride(3) != 1:
            raise ValueError(f"{fn}: {name} needs a unit stride along dh, "
                             f"got strides {x.stride()}")
    if dh > max_dh:
        raise ValueError(f"{fn}: head dim {dh} exceeds the {max_dh} the "
                         f"kernel takes")
    if max(t, k.shape[1], b, hq, abs(q_offset), abs(prefix_len)) > \
            _INT_MAX // 2:
        raise ValueError(f"{fn}: sizes exceed the kernel's int32 positions")


def _route(dtype: torch.dtype, dh: int, strides, ptrs) -> str:
    """The route for operands of ``dtype`` and head dim ``dh`` with the
    given element strides (batch, token and head of every operand) and
    base addresses: ``tensor_core`` takes bfloat16 with ``dh`` a multiple
    of 16 up to 256, 16-byte aligned bases and strides that are positive
    multiples of 8 elements (TMA's 16 bytes); everything else is
    ``scalar``."""
    ok = (dtype == torch.bfloat16 and dh % 16 == 0 and 16 <= dh <= 256
          and all(p % 16 == 0 for p in ptrs)
          and all(st > 0 and st % 8 == 0 for st in strides))
    return "tensor_core" if ok else "scalar"


def _strides(x: torch.Tensor) -> list:
    """(batch, token, head) element strides of ``x``.  The kernel never
    steps along a dimension of extent 1, nor reads an empty tensor, so
    such a stride that TMA would refuse is given as 8."""
    if x.numel() == 0:
        return [8, 8, 8]
    return [st if n > 1 or (st > 0 and st % 8 == 0) else 8
            for n, st in zip(x.shape[:3], x.stride()[:3])]


def _layout(operands) -> tuple:
    """The operands' (batch, token, head) element strides, one after the
    other as the kernels take them, and their base addresses."""
    strides = np.array([st for x in operands for st in _strides(x)],
                       dtype=np.int64)
    return strides, tuple(x.data_ptr() for x in operands)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, prefix_len: int = 0,
                    kv_valid_len: Optional[int] = None,
                    q_offset: int = 0,
                    route: Optional[str] = None) -> torch.Tensor:
    """q: (B, T, Hq, dh); k, v: (B, S, Hkv, dh) -> (B, T, Hq, dh).

    Query ``t`` (at position ``q_offset + t``) attends key ``s`` when
    ``s < kv_valid_len`` (``S`` when None) and, if ``causal``, when
    ``s <= q_offset + t`` or ``s < prefix_len``.  Scores, the running
    max and denominator and the accumulator are float32; the
    probabilities are rounded to the input dtype before P·V and the output
    is in the input dtype.  On the card: float32 or bfloat16 operands with
    a unit stride along ``dh``, ``dh`` at most 256; ``kv_valid_len`` is an
    int (a tensor is read back to the host) and is clamped to ``[0, S]``.
    ``route`` (``tensor_core`` or ``scalar``) overrides :func:`_route`'s
    choice; a route that cannot take the operands raises and launches
    nothing.  The call goes through the operator
    ``torch.ops.repro_torch.flash_attention``, whose gradient is
    :func:`flash_attention_bwd`'s operator.
    """
    _check(q, k, v)
    if kv_valid_len is not None:
        kv_valid_len = int(kv_valid_len)
    return _flash_op(q, k, v, bool(causal), int(prefix_len), kv_valid_len,
                     int(q_offset), route)


def _forward(q, k, v, causal, prefix_len, kv_valid_len, q_offset, route):
    """The forward launch (or, on CPU tensors, the plain version)."""
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal,
                                   prefix_len=prefix_len,
                                   kv_valid_len=kv_valid_len,
                                   q_offset=q_offset)
    lib = _lib()
    _check_operands("flash_attention", (("q", q), ("k", k), ("v", v)),
                    lib.flash_attention_max_head_dim(), q_offset, prefix_len)
    b, t, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    kv_valid = s if kv_valid_len is None else min(max(kv_valid_len, 0), s)
    out = torch.empty((b, t, hq, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides, ptrs = _layout((q, k, v, out))
    if route is None:
        route = _route(q.dtype, dh, strides.tolist(), ptrs)
    if route not in ROUTES:
        raise ValueError(f"flash_attention: route {route!r} is not one of "
                         f"{sorted(ROUTES)}")
    with torch.cuda.device(q.device):
        err = lib.flash_attention(
            ROUTES[route], _DTYPES[q.dtype], *ptrs,
            strides.ctypes.data, b, t, s, hq, hkv, dh,
            int(bool(causal)), int(prefix_len), kv_valid, int(q_offset),
            float(np.float32(dh ** -0.5)),
            _backend.stream_handle(q.device))
    _backend.check_launch(f"flash_attention ({route} route)", err)
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    return out


#: Kernel launches since the last reset, in all and by route (CPU calls do
#: not count).
flash_attention.launches = 0
flash_attention.launches_by_route = {route: 0 for route in ROUTES}


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        causal: bool = True, prefix_len: int = 0,
                        kv_valid_len: Optional[int] = None,
                        q_offset: int = 0, route: Optional[str] = None):
    """Gradients ``(dq, dk, dv)`` of :func:`flash_attention` at ``q, k, v``
    given its output ``out`` and the output's cotangent ``dout`` (both
    ``(B, T, Hq, dh)``), in the input dtype.

    On the card one call launches ``csrc/flash_attention_bwd.cu`` (its dq
    and dkdv kernels): float32 or bfloat16 operands with a unit stride
    along ``dh``, ``dh`` at most 256; every launch gives the same bits.
    :func:`_route` picks the route from the operands, the gradients' too;
    ``route`` forces one, and a route that cannot take the operands raises
    and launches nothing.  On CPU tensors it runs
    :func:`.ref.flash_attention_bwd`.
    """
    _check(q, k, v)
    for name, t in (("out", out), ("dout", dout)):
        if not isinstance(t, torch.Tensor) or t.shape != q.shape:
            raise ValueError(f"flash_attention_bwd: {name} must have q's "
                             f"shape {tuple(q.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"flash_attention_bwd: {name} is {t.dtype} on "
                            f"{t.device}, q is {q.dtype} on {q.device}")
    if kv_valid_len is not None:
        kv_valid_len = int(kv_valid_len)
    return _flash_bwd_op(q, k, v, out, dout, bool(causal), int(prefix_len),
                         kv_valid_len, int(q_offset), route)


def _backward(q, k, v, out, dout, causal, prefix_len, kv_valid_len,
              q_offset, route):
    """The backward launch (or, on CPU tensors, the plain backward)."""
    if q.device.type == "cpu":
        return ref.flash_attention_bwd(q, k, v, out, dout, causal=causal,
                                       prefix_len=prefix_len,
                                       kv_valid_len=kv_valid_len,
                                       q_offset=q_offset)
    lib = _bwd_lib()
    _check_operands("flash_attention_bwd",
                    (("q", q), ("k", k), ("v", v), ("out", out),
                     ("dout", dout)),
                    lib.flash_attention_bwd_max_head_dim(), q_offset,
                    prefix_len)
    b, t, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    kv_valid = s if kv_valid_len is None else min(max(kv_valid_len, 0), s)
    dq = torch.empty((b, t, hq, dh), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s, hkv, dh), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    strides, ptrs = _layout((q, k, v, out, dout, dq, dk, dv))
    if route is None:
        route = _route(q.dtype, dh, strides.tolist(), ptrs)
    if route not in ROUTES:
        raise ValueError(f"flash_attention_bwd: route {route!r} is not one "
                         f"of {sorted(ROUTES)}")
    # Scratch for the rows' statistics: 3 x B x Hq x T (rounded up to 64
    # rows) floats holds either route's.
    stats = torch.empty(3 * b * hq * -(-t // 64) * 64, dtype=torch.float32,
                        device=q.device)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bwd(
            ROUTES[route], _DTYPES[q.dtype], *ptrs, stats.data_ptr(),
            strides.ctypes.data, b, t, s, hq, hkv, dh, int(bool(causal)),
            int(prefix_len), kv_valid, int(q_offset),
            float(np.float32(dh ** -0.5)), _backend.stream_handle(q.device))
    _backend.check_launch(f"flash_attention_bwd ({route} route)", err)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_route[route] += 1
    return dq, dk, dv


#: Backward launches since the last reset, in all and by route (CPU calls
#: do not count).
flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_route = {route: 0 for route in ROUTES}


# ---------------------------------------------------------------------------
# The kernels as PyTorch operators
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, prefix_len: int, kv_valid_len: Optional[int],
              q_offset: int, route: Optional[str]) -> torch.Tensor:
    return _forward(q, k, v, causal, prefix_len, kv_valid_len, q_offset,
                    route)


@_flash_op.register_fake
def _flash_fake(q, k, v, causal, prefix_len, kv_valid_len, q_offset,
                route):
    return q.new_empty(q.shape)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, dout: torch.Tensor, causal: bool,
                  prefix_len: int, kv_valid_len: Optional[int],
                  q_offset: int, route: Optional[str]
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _backward(q, k, v, out, dout, causal, prefix_len, kv_valid_len,
                     q_offset, route)


@_flash_bwd_op.register_fake
def _flash_bwd_fake(q, k, v, out, dout, causal, prefix_len, kv_valid_len,
                    q_offset, route):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(k.shape)


def _setup_context(ctx, inputs, output) -> None:
    q, k, v, causal, prefix_len, kv_valid_len, q_offset, _ = inputs
    ctx.save_for_backward(q, k, v, output)
    ctx.mask = (causal, prefix_len, kv_valid_len, q_offset)


def _flash_grad(ctx, dout):
    q, k, v, out = ctx.saved_tensors
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    dq, dk, dv = _flash_bwd_op(q, k, v, out, dout, *ctx.mask, None)
    return dq, dk, dv, None, None, None, None, None


_flash_op.register_autograd(_flash_grad, setup_context=_setup_context)


def visible_pairs(t: int, s: int, causal: bool, prefix_len: int,
                  kv_valid_len: Optional[int], q_offset: int) -> int:
    """(query, key) pairs the mask lets through for one (batch, head): the
    count behind both kernels' operation bounds."""
    limit = s if kv_valid_len is None else min(max(int(kv_valid_len), 0), s)
    if not causal:
        return t * limit
    pos = np.arange(q_offset, q_offset + t, dtype=np.int64)
    return int(np.clip(np.maximum(pos + 1, prefix_len), 0, limit).sum())


def _pair_flops(per_pair: int, q_shape, k_shape, causal, prefix_len,
                kv_valid_len, q_offset) -> int:
    b, t, hq, dh = q_shape
    return per_pair * dh * b * hq * visible_pairs(
        t, k_shape[1], causal, prefix_len, kv_valid_len, q_offset)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, causal, prefix_len, kv_valid_len,
                 q_offset, route, out_shape=None, **kwargs) -> int:
    """4 dh per visible (query, key) pair: Q K^T and P V."""
    return _pair_flops(4, q_shape, k_shape, causal, prefix_len, kv_valid_len,
                       q_offset)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _flash_bwd_flops(q_shape, k_shape, v_shape, o_shape, dout_shape,
                     causal, prefix_len, kv_valid_len, q_offset, route,
                     out_shape=None, **kwargs) -> int:
    """10 dh per visible (query, key) pair: Q K^T, dO V^T, dV, dQ, dK."""
    return _pair_flops(10, q_shape, k_shape, causal, prefix_len,
                       kv_valid_len, q_offset)
