"""Partition-pruning scan matrix: the CUDA kernel ``csrc/pruning.cu``.

The Hopper counterpart of the TPU kernel ``scan_matrix_pallas``.  Every
cost the decision loop evaluates — block and per-query estimates over all
candidate states, cost vectors over the R-TBS sample, serving — reduces to
this (Q, P) interval-overlap matrix over C columns.  The kernel compares in
float64, so it is exact on every input and the scan bits equal the numpy
reference's.

The kernel has two tiles and picks one from the operands (``path=0``,
:func:`chosen_path`): one query row per block, a warp's lanes across the
columns, for small scans (a per-query estimate, serve, admission's cost
vectors); a shared-memory tile of 32 partitions walking 32 queries at a
time for larger ones (the decision loop's block estimates).  ``path=1``
(row) or ``path=2`` (tile) forces one, for measurement; both take every
shape.

:func:`scan_matrix` runs the kernel on CUDA tensors and the plain version
(:mod:`.ref`) on CPU tensors; there is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _backend

from . import ref

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]
_INT_MAX = 2 ** 31 - 1
#: ``path`` values: 0 lets the kernel choose, the others force a tile.
PATHS = {0: "choose", 1: "row", 2: "tile"}


def _kernel():
    lib = _backend.load("pruning")
    fn = lib.pruning_scan_matrix
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        choose = lib.pruning_choose_path
        choose.argtypes = [ctypes.c_int] * 3
        choose.restype = ctypes.c_int
    return fn


def chosen_path(q: int, p: int, c: int) -> int:
    """The tile ``path=0`` takes for a (Q, P, C) scan on the card."""
    _kernel()
    return _backend.load("pruning").pruning_choose_path(q, p, c)


def _row_stride(name: str, t: torch.Tensor) -> int:
    """Stride between rows of a (rows, C) operand whose columns are dense."""
    rows, c = t.shape
    if (c > 1 and t.stride(1) != 1) or (rows > 1 and t.stride(0) < c):
        raise ValueError(f"scan_matrix: {name} must have unit column stride "
                         f"and row stride >= C, got strides {t.stride()}")
    return c if rows <= 1 or c == 0 else t.stride(0)


def _check(q_lo, q_hi, p_min, p_max) -> None:
    ops = {"q_lo": q_lo, "q_hi": q_hi, "p_min": p_min, "p_max": p_max}
    for name, t in ops.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"scan_matrix: {name} must be a tensor")
        if t.dtype != torch.float64:
            raise TypeError(f"scan_matrix: {name} must be float64, "
                            f"got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"scan_matrix: {name} must be 2-D, got shape "
                             f"{tuple(t.shape)}")
        if t.device != q_lo.device:
            raise ValueError(f"scan_matrix: {name} is on {t.device}, q_lo "
                             f"on {q_lo.device}")
    if q_lo.shape != q_hi.shape or p_min.shape != p_max.shape:
        raise ValueError("scan_matrix: lo/hi (and min/max) shapes differ")
    if q_lo.shape[1] != p_min.shape[1]:
        raise ValueError(f"scan_matrix: {q_lo.shape[1]} query columns vs "
                         f"{p_min.shape[1]} partition columns")
    if q_lo.device.type not in ("cpu", "cuda"):
        raise ValueError(f"scan_matrix: unsupported device {q_lo.device}")


def scan_matrix(q_lo: torch.Tensor, q_hi: torch.Tensor, p_min: torch.Tensor,
                p_max: torch.Tensor, path: int = 0) -> torch.Tensor:
    """(Q, C) query bounds x (P, C) zone maps -> (Q, P) bool scan matrix.

    float64 operands on one device.  Each pair (lo/hi, min/max) needs dense
    columns and shares one row stride, so a block of rows sliced from a
    larger bounds tensor, or a view of a larger plane, is read in place.
    ``path`` is the kernel's tile (:data:`PATHS`; 0 = its own choice).
    """
    _check(q_lo, q_hi, p_min, p_max)
    if path not in PATHS:
        raise ValueError(f"scan_matrix: path must be one of {sorted(PATHS)}, "
                         f"got {path!r}")
    if q_lo.device.type == "cpu":
        return ref.scan_matrix(q_lo, q_hi, p_min, p_max)
    q_stride = _row_stride("q_lo", q_lo)
    if _row_stride("q_hi", q_hi) != q_stride:
        raise ValueError("scan_matrix: q_lo and q_hi row strides differ")
    p_stride = _row_stride("p_min", p_min)
    if _row_stride("p_max", p_max) != p_stride:
        raise ValueError("scan_matrix: p_min and p_max row strides differ")
    (q, c), p = q_lo.shape, p_min.shape[0]
    if max(q, p, c) > _INT_MAX:
        raise ValueError("scan_matrix: dimension exceeds int32")
    out = torch.empty((q, p), dtype=torch.bool, device=q_lo.device)
    if q == 0 or p == 0:
        return out
    with torch.cuda.device(q_lo.device):
        err = _kernel()(q_lo.data_ptr(), q_hi.data_ptr(), q_stride,
                        p_min.data_ptr(), p_max.data_ptr(), p_stride,
                        out.data_ptr(), q, p, c, path,
                        _backend.stream_handle(q_lo.device))
    _backend.check_launch("pruning_scan_matrix", err)
    scan_matrix.launches += 1
    return out


#: Kernel launches since the last reset (CPU calls do not count).
scan_matrix.launches = 0
