"""Causal (+ prefix-LM) flash attention: the CUDA kernel
``csrc/flash_attention.cu``.

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
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _backend

from . import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"scalar": 0, "tensor_core": 1}
_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
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


def _route(dtype: torch.dtype, dh: int, strides, ptrs) -> str:
    """The route for operands of ``dtype`` and head dim ``dh`` with the
    given element strides (batch, token and head of q, k, v and out) and
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
    nothing.
    """
    _check(q, k, v)
    if kv_valid_len is not None:
        kv_valid_len = int(kv_valid_len)
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal,
                                   prefix_len=prefix_len,
                                   kv_valid_len=kv_valid_len,
                                   q_offset=q_offset)
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: the kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    b, t, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    for name, x in (("q", q), ("k", k), ("v", v)):
        if dh > 1 and x.numel() and x.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} needs a unit stride "
                             f"along dh, got strides {x.stride()}")
    lib = _lib()
    if dh > lib.flash_attention_max_head_dim():
        raise ValueError(f"flash_attention: head dim {dh} exceeds the "
                         f"{lib.flash_attention_max_head_dim()} the kernel "
                         f"takes")
    if max(t, s, b, hq, abs(q_offset), abs(prefix_len)) > _INT_MAX // 2:
        raise ValueError("flash_attention: sizes exceed the kernel's int32 "
                         "positions")
    kv_valid = s if kv_valid_len is None else min(max(kv_valid_len, 0), s)
    out = torch.empty((b, t, hq, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = np.array([*_strides(q), *_strides(k), *_strides(v),
                        *_strides(out)], dtype=np.int64)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
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
