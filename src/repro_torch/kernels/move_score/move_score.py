"""Micro-move scan frequencies: the CUDA kernel ``csrc/move_score.cu``.

The Hopper counterpart of the TPU kernel ``move_scores_pallas``: for a
``(Q, C)`` window of recent queries and a packed ``(S, P, C)`` plane of
zone maps, the fraction of the window that must scan each partition.  The
reorganization planner orders a migration's moves by it.  The kernel
compares in float64 and counts in an integer, so the result is exactly
``count / Q`` on every input.  It is the fleet plane's shared-memory tile
(``csrc/fleet_tile.cuh``) with one tenant and the window frequency as its
only output: a thread takes four slots of a window row (one below four
rows); ``path=1`` (one) or ``path=2`` (four) forces either, for
measurement.  Past the tile's column limit a thread-per-output kernel
takes the plane, so every column count is taken.

:func:`move_scores` runs the kernel on CUDA tensors and the plain version
(:mod:`.ref`) on CPU tensors; there is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _backend

from . import ref

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])
_INT_MAX = 2 ** 31 - 1
#: ``path`` values: 0 lets the kernel choose, the others force the slots
#: a thread takes.
PATHS = {0: "choose", 1: "one slot a thread", 2: "four slots a thread"}


def _lib():
    lib = _backend.load("move_score")
    if lib.move_score.argtypes is None:
        lib.move_score.argtypes = _ARGTYPES
        lib.move_score.restype = ctypes.c_int
    return lib


def _check(q_lo, q_hi, p_min, p_max) -> None:
    ops = {"q_lo": (q_lo, 2), "q_hi": (q_hi, 2), "p_min": (p_min, 3),
           "p_max": (p_max, 3)}
    for name, (t, dim) in ops.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"move_scores: {name} must be a tensor")
        if t.dtype != torch.float64:
            raise TypeError(f"move_scores: {name} must be float64, "
                            f"got {t.dtype}")
        if t.dim() != dim:
            raise ValueError(f"move_scores: {name} must be {dim}-D, got "
                             f"shape {tuple(t.shape)}")
        if t.device != q_lo.device:
            raise ValueError(f"move_scores: {name} is on {t.device}, q_lo "
                             f"on {q_lo.device}")
    if q_lo.shape != q_hi.shape or p_min.shape != p_max.shape:
        raise ValueError("move_scores: lo/hi (and min/max) shapes differ")
    if q_lo.shape[1] != p_min.shape[2]:
        raise ValueError(f"move_scores: window {tuple(q_lo.shape)} does not "
                         f"match the plane {tuple(p_min.shape)}")
    if q_lo.shape[0] == 0:
        raise ValueError("move_scores: the window is empty (a frequency "
                         "over zero queries is undefined)")
    if q_lo.device.type not in ("cpu", "cuda"):
        raise ValueError(f"move_scores: unsupported device {q_lo.device}")


def move_scores(q_lo: torch.Tensor, q_hi: torch.Tensor, p_min: torch.Tensor,
                p_max: torch.Tensor, *, path: int = 0) -> torch.Tensor:
    """(Q, C) window x (S, P, C) plane -> (S, P) float64 scan frequency.

    ``out[s, p]`` is the fraction of the Q window rows whose bounds overlap
    partition p of state s in every column.  float64 operands on one
    device, Q >= 1.  The window must be contiguous; the plane operands need
    dense columns and share their state and partition strides (a
    row-strided view is read in place).  ``path`` is the kernel's thread
    layout (:data:`PATHS`; 0 = its own choice); the plain version ignores
    it.
    """
    if path not in PATHS:
        raise ValueError(f"move_scores: path must be one of "
                         f"{sorted(PATHS)}, got {path!r}")
    _check(q_lo, q_hi, p_min, p_max)
    if q_lo.device.type == "cpu":
        return ref.move_scores(q_lo, q_hi, p_min, p_max)
    if not (q_lo.is_contiguous() and q_hi.is_contiguous()):
        raise ValueError("move_scores: the window must be contiguous")
    q, c = q_lo.shape
    s, p, _ = p_min.shape
    if c > 1 and (p_min.stride(2) != 1 or p_max.stride(2) != 1):
        raise ValueError(f"move_scores: the plane must have unit column "
                         f"stride, got strides {p_min.stride()}")
    if p_min.stride()[:2] != p_max.stride()[:2]:
        raise ValueError("move_scores: p_min and p_max strides differ")
    if q > _INT_MAX:
        raise ValueError("move_scores: window exceeds int32 rows")
    lib = _lib()
    out = torch.empty((s, p), dtype=torch.float64, device=q_lo.device)
    if s * p == 0:
        return out
    with torch.cuda.device(q_lo.device):
        err = lib.move_score(q_lo.data_ptr(), q_hi.data_ptr(),
                             p_min.data_ptr(), p_max.data_ptr(),
                             p_min.stride(0), p_min.stride(1),
                             out.data_ptr(), q, s, p, c, path,
                             _backend.stream_handle(q_lo.device))
    _backend.check_launch("move_score", err)
    move_scores.launches += 1
    return out


#: Kernel launches since the last reset (CPU calls do not count).
move_scores.launches = 0
