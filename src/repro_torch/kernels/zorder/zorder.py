"""Z-order (Morton) keys: the CUDA kernel ``csrc/zorder.cu``.

The Hopper counterpart of the TPU kernel ``zorder_keys_pallas``, in two
lanes of one kernel template:

* :func:`zorder_keys` -- the TPU kernel's function, float32 values
  quantized to ``bits`` bits, ``m * bits <= 32``.
* :func:`zorder_keys64` -- the Z-order layout generator's function: the
  selected columns of a float64 table, read in place through its row
  stride, quantized in float64 to 16 bits and interleaved into 64-bit keys
  (int64 with bit 63 flipped, see :mod:`.ref`).  Every Z-order build and
  every routing of a table through a Z-order layout runs it.

Both are exact: the kernel rounds each step as the reference does, so the
keys equal the plain versions' (:mod:`.ref`) bit for bit.  A wrapper runs
the kernel on CUDA tensors and the plain version on CPU tensors; there is
no fallback from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import _backend

from . import ref

_ARGTYPES32 = ([ctypes.c_void_p] * 4
               + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p])
_ARGTYPES64 = ([ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 4
               + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])


def _lib():
    lib = _backend.load("zorder")
    if lib.zorder_keys32.argtypes is None:
        lib.zorder_keys32.argtypes = _ARGTYPES32
        lib.zorder_keys32.restype = ctypes.c_int
        lib.zorder_keys64.argtypes = _ARGTYPES64
        lib.zorder_keys64.restype = ctypes.c_int
        lib.zorder_max_columns.argtypes = []
        lib.zorder_max_columns.restype = ctypes.c_int
    return lib


def _check_bounds(fn: str, lo, hi, m: int, dtype, device) -> None:
    for name, t in (("lo", lo), ("hi", hi)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{fn}: {name} must be a tensor")
        if t.dtype != dtype:
            raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != (m,):
            raise ValueError(f"{fn}: {name} must have shape ({m},), got "
                             f"{tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{fn}: {name} is on {t.device}, the values "
                             f"on {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {device}")


def _max_columns(fn: str, lib, m: int) -> None:
    if m > lib.zorder_max_columns():
        raise ValueError(f"{fn}: {m} columns exceed the "
                         f"{lib.zorder_max_columns()} the kernel takes")


def zorder_keys(values: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                bits: int = 10) -> torch.Tensor:
    """(N, m) float32 values, (m,) float32 lo/hi -> (N,) int64 Morton keys
    (uint32 values), ``m * bits <= 32`` and ``1 <= bits <= 16``."""
    if not isinstance(values, torch.Tensor) or values.dtype != torch.float32:
        raise TypeError("zorder_keys: values must be a float32 tensor")
    if values.dim() != 2 or values.shape[1] < 1:
        raise ValueError(f"zorder_keys: values must be (N, m) with m >= 1, "
                         f"got {tuple(values.shape)}")
    n, m = values.shape
    bits = int(bits)
    if not (1 <= bits <= 16 and m * bits <= 32):
        raise ValueError(f"zorder_keys: needs 1 <= bits <= 16 and m * bits "
                         f"<= 32, got m = {m}, bits = {bits}")
    _check_bounds("zorder_keys", lo, hi, m, torch.float32, values.device)
    if values.device.type == "cpu":
        return ref.zorder_keys(values, lo, hi, bits)
    if not (values.is_contiguous() and lo.is_contiguous()
            and hi.is_contiguous()):
        raise ValueError("zorder_keys: values, lo and hi must be contiguous")
    lib = _lib()
    _max_columns("zorder_keys", lib, m)
    out = torch.empty(n, dtype=torch.int64, device=values.device)
    if n == 0:
        return out
    with torch.cuda.device(values.device):
        err = lib.zorder_keys32(values.data_ptr(), lo.data_ptr(),
                                hi.data_ptr(), out.data_ptr(), n, m, bits,
                                _backend.stream_handle(values.device))
    _backend.check_launch("zorder_keys32", err)
    zorder_keys.launches += 1
    return out


def zorder_keys64(table: torch.Tensor, zcols: Sequence[int],
                  col_lo: torch.Tensor, col_hi: torch.Tensor
                  ) -> torch.Tensor:
    """(N, C) float64 table, m column indices, (m,) float64 lo/hi -> (N,)
    int64 keys with bit 63 flipped (16 bits per column, 64-bit keys).

    The table is read in place: any row stride, unit column stride.
    """
    if not isinstance(table, torch.Tensor) or table.dtype != torch.float64:
        raise TypeError("zorder_keys64: the table must be a float64 tensor")
    if table.dim() != 2:
        raise ValueError(f"zorder_keys64: the table must be (N, C), got "
                         f"{tuple(table.shape)}")
    n, c = table.shape
    cols = np.asarray(zcols, dtype=np.int64).reshape(-1)
    m = int(cols.size)
    if m < 1 or cols.min() < 0 or cols.max() >= c:
        raise ValueError(f"zorder_keys64: column indices {cols.tolist()} "
                         f"out of range for {c} columns")
    _check_bounds("zorder_keys64", col_lo, col_hi, m, torch.float64,
                  table.device)
    if table.device.type == "cpu":
        return ref.zorder_keys64(table, cols, col_lo, col_hi)
    if c > 1 and n > 0 and table.stride(1) != 1:
        raise ValueError(f"zorder_keys64: the table must have unit column "
                         f"stride, got strides {table.stride()}")
    if not (col_lo.is_contiguous() and col_hi.is_contiguous()):
        raise ValueError("zorder_keys64: col_lo and col_hi must be "
                         "contiguous")
    lib = _lib()
    _max_columns("zorder_keys64", lib, m)
    out = torch.empty(n, dtype=torch.int64, device=table.device)
    if n == 0:
        return out
    host_cols = (ctypes.c_int64 * m)(*cols.tolist())
    with torch.cuda.device(table.device):
        err = lib.zorder_keys64(table.data_ptr(), table.stride(0),
                                ctypes.addressof(host_cols),
                                col_lo.data_ptr(), col_hi.data_ptr(),
                                out.data_ptr(), n, m,
                                _backend.stream_handle(table.device))
    _backend.check_launch("zorder_keys64", err)
    zorder_keys64.launches += 1
    return out


#: Kernel launches since the last reset (CPU calls do not count).
zorder_keys.launches = 0
zorder_keys64.launches = 0
