"""Z-order (Morton) keys: the CUDA kernel ``csrc/zorder.cu``.

The Hopper counterpart of the TPU kernel ``zorder_keys_pallas``: three
entries over one kernel template.

* :func:`zorder_keys` -- the TPU kernel's function, float32 values
  quantized to ``bits`` bits, ``m * bits <= 32``.
* :func:`zorder_keys64` -- the Z-order layout generator's function: the
  selected columns of a float64 table, read in place through its row and
  column strides (any positive ones: row-major, column-major, strided
  views), quantized in float64 to 16 bits and interleaved into 64-bit keys
  (int64 with bit 63 flipped, see :mod:`.ref`).  Every Z-order build runs
  it once, on its sample's key columns.
* :func:`zorder_route64` -- those keys routed through a Z-order layout's
  ``k - 1`` key boundaries to int64 partition ids in the same pass, the
  keys never written (``k <= MAX_PARTS``).  Every routing of a table
  through a Z-order layout runs it.

All are exact: the kernel rounds each step as the reference does, so keys
and ids equal the plain versions' (:mod:`.ref`) bit for bit.  A wrapper runs
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
_ARGTYPES64 = ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
               + [ctypes.c_void_p] * 4
               + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p])
_ARGTYPES_ROUTE = ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
                   + [ctypes.c_void_p] * 4
                   + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

#: The most partitions :func:`zorder_route64` routes to: the kernel holds
#: the ``k - 1`` boundaries in shared memory (``zorder_max_parts()``).
MAX_PARTS = 4097


def _lib():
    lib = _backend.load("zorder")
    if lib.zorder_keys32.argtypes is None:
        lib.zorder_keys32.argtypes = _ARGTYPES32
        lib.zorder_keys32.restype = ctypes.c_int
        lib.zorder_keys64.argtypes = _ARGTYPES64
        lib.zorder_keys64.restype = ctypes.c_int
        lib.zorder_route64.argtypes = _ARGTYPES_ROUTE
        lib.zorder_route64.restype = ctypes.c_int
        for fn in (lib.zorder_max_columns, lib.zorder_max_parts):
            fn.argtypes = []
            fn.restype = ctypes.c_int
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


def _table_operands(fn: str, table, zcols, col_lo, col_hi):
    """Checks a float64 (N, C) table, its key columns and bounds; returns
    the columns as an int64 numpy array."""
    if not isinstance(table, torch.Tensor) or table.dtype != torch.float64:
        raise TypeError(f"{fn}: the table must be a float64 tensor")
    if table.dim() != 2:
        raise ValueError(f"{fn}: the table must be (N, C), got "
                         f"{tuple(table.shape)}")
    c = table.shape[1]
    cols = np.asarray(zcols, dtype=np.int64).reshape(-1)
    if cols.size < 1 or cols.min() < 0 or cols.max() >= c:
        raise ValueError(f"{fn}: column indices {cols.tolist()} out of "
                         f"range for {c} columns")
    _check_bounds(fn, col_lo, col_hi, int(cols.size), torch.float64,
                  table.device)
    return cols


def _launch_table(entry: str, table, cols, col_lo, col_hi, *extra
                  ) -> torch.Tensor:
    """Launches ``entry`` (``zorder_keys64`` or ``zorder_route64``) over a
    CUDA table read in place; ``extra`` goes between the bounds and the
    output.  Returns the (N,) int64 output."""
    for dim in (0, 1):
        if table.shape[dim] > 1 and table.stride(dim) < 1:
            raise ValueError(f"{entry}: the table's strides must be "
                             f"positive, got {table.stride()}")
    if not (col_lo.is_contiguous() and col_hi.is_contiguous()):
        raise ValueError(f"{entry}: col_lo and col_hi must be contiguous")
    lib = _lib()
    m = int(cols.size)
    _max_columns(entry, lib, m)
    n = table.shape[0]
    out = torch.empty(n, dtype=torch.int64, device=table.device)
    if n == 0:
        return out
    host_cols = (ctypes.c_int64 * m)(*cols.tolist())
    with torch.cuda.device(table.device):
        err = getattr(lib, entry)(
            table.data_ptr(), table.stride(0), table.stride(1),
            ctypes.addressof(host_cols), col_lo.data_ptr(),
            col_hi.data_ptr(), *extra, out.data_ptr(), n, m, 0,
            _backend.stream_handle(table.device))
    _backend.check_launch(entry, err)
    return out


def zorder_keys64(table: torch.Tensor, zcols: Sequence[int],
                  col_lo: torch.Tensor, col_hi: torch.Tensor
                  ) -> torch.Tensor:
    """(N, C) float64 table, m column indices, (m,) float64 lo/hi -> (N,)
    int64 keys with bit 63 flipped (16 bits per column, 64-bit keys).

    The table is read in place through any positive strides.
    """
    cols = _table_operands("zorder_keys64", table, zcols, col_lo, col_hi)
    if table.device.type == "cpu":
        return ref.zorder_keys64(table, cols, col_lo, col_hi)
    out = _launch_table("zorder_keys64", table, cols, col_lo, col_hi)
    zorder_keys64.launches += 1
    return out


def zorder_route64(table: torch.Tensor, zcols: Sequence[int],
                   col_lo: torch.Tensor, col_hi: torch.Tensor,
                   boundaries: torch.Tensor, k: int) -> torch.Tensor:
    """(N, C) float64 table, m column indices, (m,) float64 lo/hi, the
    ``k - 1`` sorted flipped int64 key boundaries of a Z-order layout ->
    (N,) int64 partition ids ``min(searchsorted(boundaries, key,
    right=True), k - 1)``, ``1 <= k <= MAX_PARTS``.

    The table is read in place through any positive strides; the keys are
    never written.
    """
    cols = _table_operands("zorder_route64", table, zcols, col_lo, col_hi)
    k = int(k)
    if not 1 <= k <= MAX_PARTS:
        raise ValueError(f"zorder_route64: k = {k} partitions, the kernel "
                         f"takes 1 to {MAX_PARTS}")
    if not isinstance(boundaries, torch.Tensor) \
            or boundaries.dtype != torch.int64:
        raise TypeError("zorder_route64: boundaries must be an int64 tensor")
    if tuple(boundaries.shape) != (k - 1,):
        raise ValueError(f"zorder_route64: boundaries must have shape "
                         f"({k - 1},), got {tuple(boundaries.shape)}")
    if boundaries.device != table.device:
        raise ValueError(f"zorder_route64: boundaries are on "
                         f"{boundaries.device}, the table on {table.device}")
    if table.device.type == "cpu":
        return ref.zorder_route64(table, cols, col_lo, col_hi, boundaries, k)
    if not boundaries.is_contiguous():
        raise ValueError("zorder_route64: boundaries must be contiguous")
    out = _launch_table("zorder_route64", table, cols, col_lo, col_hi,
                        boundaries.data_ptr(), k)
    zorder_route64.launches += 1
    return out


#: Kernel launches since the last reset (CPU calls do not count).
zorder_keys.launches = 0
zorder_keys64.launches = 0
zorder_route64.launches = 0
