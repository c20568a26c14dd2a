"""The fleet's decision plane in one pass: the CUDA kernel
``csrc/decision_fused.cu``.

The Hopper counterpart of the TPU kernel ``fused_decision_pallas``.  For a
block of B query frames (one query per tenant per frame) and the packed
``(T, S, P, C)`` fleet plane it emits, reading each zone-map row once:

* ``scan`` (B, T, S, P) bool, the frame scan matrix;
* ``cost`` (B, T, S) float64, ``(sum_p scan * rows) * inv_totals``;
* ``freq`` (T, S, P) float64, the share of a (W, C) window scanning each
  partition.

The kernel compares in float64, so ``scan`` and ``freq`` are exact on every
input; ``cost`` sums over P in one fixed order, so it is deterministic.
It shares its shared-memory tile with the fleet scan
(``csrc/fleet_tile.cuh``): a thread takes four slots of a frame (one slot
below four frames); ``path=1`` (one) or ``path=2`` (four) forces either,
for measurement, and both take every shape.
:func:`fused_decision` runs the kernel on CUDA tensors and the plain
version (:mod:`.ref`) on CPU tensors; there is no fallback from one to the
other.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _backend

from . import ref

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3
             + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
             + [ctypes.c_void_p])
_INT_MAX = 2 ** 31 - 1
#: ``path`` values: 0 lets the kernel choose, the others force the slots
#: a thread takes.
PATHS = {0: "choose", 1: "one slot a thread", 2: "four slots a thread"}


def _lib():
    lib = _backend.load("decision_fused")
    if lib.decision_fused.argtypes is None:
        lib.decision_fused.argtypes = _ARGTYPES
        lib.decision_fused.restype = ctypes.c_int
        lib.decision_fused_max_columns.argtypes = []
        lib.decision_fused_max_columns.restype = ctypes.c_int
    return lib


def _check(ops: dict, device: torch.device) -> None:
    for name, (t, dim) in ops.items():
        if t is None:
            continue
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"fused_decision: {name} must be a tensor")
        if t.dtype != torch.float64:
            raise TypeError(f"fused_decision: {name} must be float64, "
                            f"got {t.dtype}")
        if t.dim() != dim:
            raise ValueError(f"fused_decision: {name} must be {dim}-D, got "
                             f"shape {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"fused_decision: {name} is on {t.device}, "
                             f"q_lo on {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_decision: unsupported device {device}")


def _shapes(q_lo, q_hi, p_min, p_max, rows, inv_totals, w_lo, w_hi) -> None:
    if q_lo.shape != q_hi.shape or p_min.shape != p_max.shape:
        raise ValueError("fused_decision: lo/hi (and min/max) shapes differ")
    b, t, c = q_lo.shape
    pt, s, p, pc = p_min.shape
    if (t, c) != (pt, pc):
        raise ValueError(f"fused_decision: frames {tuple(q_lo.shape)} do "
                         f"not match the plane {tuple(p_min.shape)}")
    if (rows is None) != (inv_totals is None):
        raise ValueError("fused_decision: cost needs rows and inv_totals")
    if rows is not None and (tuple(rows.shape) != (t, s, p)
                             or tuple(inv_totals.shape) != (t, s)):
        raise ValueError(f"fused_decision: rows {tuple(rows.shape)} / "
                         f"inv_totals {tuple(inv_totals.shape)} do not "
                         f"match the plane {tuple(p_min.shape)}")
    if (w_lo is None) != (w_hi is None):
        raise ValueError("fused_decision: freq needs w_lo and w_hi")
    if w_lo is not None and (w_lo.shape != w_hi.shape
                             or w_lo.shape[1] != c):
        raise ValueError(f"fused_decision: window {tuple(w_lo.shape)} does "
                         f"not match {c} columns")


def fused_decision(q_lo: torch.Tensor, q_hi: torch.Tensor,
                   p_min: torch.Tensor, p_max: torch.Tensor,
                   rows: Optional[torch.Tensor] = None,
                   inv_totals: Optional[torch.Tensor] = None,
                   w_lo: Optional[torch.Tensor] = None,
                   w_hi: Optional[torch.Tensor] = None, *,
                   emit_scan: bool = True, path: int = 0,
                   ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor],
                              Optional[torch.Tensor]]:
    """(B, T, C) frames x (T, S, P, C) plane -> (scan, cost, freq).

    ``cost`` needs ``rows`` (T, S, P) and ``inv_totals`` (T, S); ``freq``
    needs the (W, C) window bounds ``w_lo``/``w_hi``.  An element of the
    triple comes back ``None`` when its inputs were not given or, for
    ``scan``, when ``emit_scan=False``; asking for nothing raises.

    float64 operands on one device.  Frames, rows, totals and window must
    be contiguous; the plane operands need dense columns and share their
    tenant, state and partition strides (a view is read in place).
    ``path`` is the kernel's thread layout (:data:`PATHS`; 0 = its own
    choice); the plain version ignores it.
    """
    if path not in PATHS:
        raise ValueError(f"fused_decision: path must be one of "
                         f"{sorted(PATHS)}, got {path!r}")
    emit_cost, emit_freq = rows is not None, w_lo is not None
    if not (emit_scan or emit_cost or emit_freq):
        raise ValueError("fused_decision: nothing to emit")
    device = q_lo.device if isinstance(q_lo, torch.Tensor) else None
    _check({"q_lo": (q_lo, 3), "q_hi": (q_hi, 3), "p_min": (p_min, 4),
            "p_max": (p_max, 4), "rows": (rows, 3),
            "inv_totals": (inv_totals, 2), "w_lo": (w_lo, 2),
            "w_hi": (w_hi, 2)}, device)
    _shapes(q_lo, q_hi, p_min, p_max, rows, inv_totals, w_lo, w_hi)
    if device.type == "cpu":
        scan, cost, freq = ref.fused_decision(q_lo, q_hi, p_min, p_max, rows,
                                              inv_totals, w_lo, w_hi)
        return (scan if emit_scan else None), cost, freq
    for name, t in (("q_lo", q_lo), ("q_hi", q_hi), ("rows", rows),
                    ("inv_totals", inv_totals), ("w_lo", w_lo),
                    ("w_hi", w_hi)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"fused_decision: {name} must be contiguous")
    b, t, c = q_lo.shape
    _, s, p, _ = p_min.shape
    if c > 1 and (p_min.stride(3) != 1 or p_max.stride(3) != 1):
        raise ValueError(f"fused_decision: the plane must have unit column "
                         f"stride, got strides {p_min.stride()}")
    if p_min.stride()[:3] != p_max.stride()[:3]:
        raise ValueError("fused_decision: p_min and p_max strides differ")
    w = 0 if w_lo is None else w_lo.shape[0]
    if max(b, t, s, p, w) > _INT_MAX:
        raise ValueError("fused_decision: dimension exceeds int32")
    lib = _lib()
    if c > lib.decision_fused_max_columns():
        raise ValueError(f"fused_decision: {c} columns exceed the "
                         f"{lib.decision_fused_max_columns()} whose bounds "
                         f"fit one tile of shared memory")
    kw = dict(device=device)
    scan = (torch.empty((b, t, s, p), dtype=torch.bool, **kw)
            if emit_scan else None)
    cost = (torch.empty((b, t, s), dtype=torch.float64, **kw)
            if emit_cost else None)
    freq = (torch.empty((t, s, p), dtype=torch.float64, **kw)
            if emit_freq else None)
    if t * s == 0 or not ((b and (emit_scan or emit_cost)) or emit_freq):
        return scan, cost, freq

    def ptr(x):
        return None if x is None else x.data_ptr()
    with torch.cuda.device(device):
        err = lib.decision_fused(
            q_lo.data_ptr(), q_hi.data_ptr(), p_min.data_ptr(),
            p_max.data_ptr(), p_min.stride(0), p_min.stride(1),
            p_min.stride(2), ptr(rows), ptr(inv_totals), ptr(w_lo),
            ptr(w_hi), ptr(scan), ptr(cost), ptr(freq), b, t, s, p, c, w,
            path, _backend.stream_handle(device))
    _backend.check_launch("decision_fused", err)
    fused_decision.launches += 1
    return scan, cost, freq


#: Kernel launches since the last reset (CPU calls do not count).
fused_decision.launches = 0
