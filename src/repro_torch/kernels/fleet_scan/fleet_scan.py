"""Fused multi-tenant fleet scan: the CUDA kernel ``csrc/fleet_scan.cu``.

The Hopper counterpart of the TPU kernel ``scan_fleet_pallas``: every
tenant's query against that tenant's packed ``(N, C)`` plane of
state-partition slots, for all tenants in one launch.  The kernel compares
in float64, so it is exact on every input and the scan bits equal the
numpy reference's.  It is the fused decision kernel's shared-memory tile
(``csrc/fleet_tile.cuh``) for one frame: one slot a thread unless
``path=2`` forces four (``path=1`` forces one; both take every shape).

:func:`scan_fleet` runs the kernel on CUDA tensors and the plain version
(:mod:`.ref`) on CPU tensors; there is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _backend

from . import ref

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]
_INT_MAX = 2 ** 31 - 1
#: ``path`` values: 0 lets the kernel choose, the others force the slots
#: a thread takes.
PATHS = {0: "choose", 1: "one slot a thread", 2: "four slots a thread"}


def _kernel():
    fn = _backend.load("fleet_scan").fleet_scan
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(q_lo, q_hi, p_min, p_max) -> None:
    ops = {"q_lo": (q_lo, 2), "q_hi": (q_hi, 2), "p_min": (p_min, 3),
           "p_max": (p_max, 3)}
    for name, (t, dim) in ops.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"scan_fleet: {name} must be a tensor")
        if t.dtype != torch.float64:
            raise TypeError(f"scan_fleet: {name} must be float64, "
                            f"got {t.dtype}")
        if t.dim() != dim:
            raise ValueError(f"scan_fleet: {name} must be {dim}-D, got "
                             f"shape {tuple(t.shape)}")
        if t.device != q_lo.device:
            raise ValueError(f"scan_fleet: {name} is on {t.device}, q_lo "
                             f"on {q_lo.device}")
    if q_lo.shape != q_hi.shape or p_min.shape != p_max.shape:
        raise ValueError("scan_fleet: lo/hi (and min/max) shapes differ")
    (t, c), (pt, _, pc) = q_lo.shape, p_min.shape
    if (t, c) != (pt, pc):
        raise ValueError(f"scan_fleet: queries {tuple(q_lo.shape)} do not "
                         f"match the plane {tuple(p_min.shape)}")
    if q_lo.device.type not in ("cpu", "cuda"):
        raise ValueError(f"scan_fleet: unsupported device {q_lo.device}")


def scan_fleet(q_lo: torch.Tensor, q_hi: torch.Tensor, p_min: torch.Tensor,
               p_max: torch.Tensor, path: int = 0) -> torch.Tensor:
    """(T, C) per-tenant bounds x (T, N, C) plane -> (T, N) bool.

    float64 operands on one device.  Query bounds must be contiguous; the
    plane operands need dense columns and share their tenant and slot
    strides (a ``(T, S * P, C)`` view of the fleet plane is read in place).
    ``path`` is the kernel's thread layout (:data:`PATHS`; 0 = its own
    choice); the plain version ignores it.
    """
    if path not in PATHS:
        raise ValueError(f"scan_fleet: path must be one of {sorted(PATHS)}, "
                         f"got {path!r}")
    _check(q_lo, q_hi, p_min, p_max)
    if q_lo.device.type == "cpu":
        return ref.scan_fleet(q_lo, q_hi, p_min, p_max)
    if not (q_lo.is_contiguous() and q_hi.is_contiguous()):
        raise ValueError("scan_fleet: query bounds must be contiguous")
    t, n, c = p_min.shape
    if c > 1 and (p_min.stride(2) != 1 or p_max.stride(2) != 1):
        raise ValueError(f"scan_fleet: the plane must have unit column "
                         f"stride, got strides {p_min.stride()}")
    if p_min.stride()[:2] != p_max.stride()[:2]:
        raise ValueError("scan_fleet: p_min and p_max strides differ")
    if c > _INT_MAX:
        raise ValueError("scan_fleet: column count exceeds int32")
    out = torch.empty((t, n), dtype=torch.bool, device=q_lo.device)
    if t == 0 or n == 0:
        return out
    with torch.cuda.device(q_lo.device):
        err = _kernel()(q_lo.data_ptr(), q_hi.data_ptr(), p_min.data_ptr(),
                        p_max.data_ptr(), p_min.stride(0), p_min.stride(1),
                        out.data_ptr(), t, n, c, path,
                        _backend.stream_handle(q_lo.device))
    _backend.check_launch("fleet_scan", err)
    scan_fleet.launches += 1
    return out


#: Kernel launches since the last reset (CPU calls do not count).
scan_fleet.launches = 0
