"""Plain PyTorch versions of the Z-order (Morton) key kernel.

Three functions, the three entries of ``csrc/zorder.cu``:

* :func:`zorder_keys` -- the TPU kernel's function: (N, m) float32 values
  quantized in float32 to ``bits``-bit codes, ``m * bits <= 32``, keys as
  uint32 values held in int64.
* :func:`zorder_keys64` -- the layout generator's function
  (``core/zorder.py``): the selected columns of a float64 table quantized
  in float64 to ``ZBITS = 16`` bits, interleaved into 64-bit keys.  Bits
  that would land at positions >= 64 are dropped, as numpy's uint64 shift
  drops them.  The keys come back as int64 with bit 63 flipped
  (:func:`flip`), so signed order equals the unsigned order of the
  reference's uint64 keys and ``torch.searchsorted`` (which has no uint64
  version) routes by them; :func:`unflip` gives the uint64 keys back.
* :func:`zorder_route64` -- those keys routed to the partitions of a
  Z-order layout: ``searchsorted`` over its ``k - 1`` flipped key
  boundaries, clamped to ``k - 1``.

Bit b of column j lands at position ``b * m + j`` in both lanes.  Every
step is one IEEE operation in the reference's type (subtract, floor the
span at 1e-12, divide, clamp to [0, 1], multiply, truncate toward zero), so
the keys equal the reference's bit for bit.  These are the oracles the CUDA
kernel is held to and what its wrappers run on CPU tensors.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

ZBITS = 16          # bits per column in the layout generator's keys
_SIGN = -(1 << 63)  # bit 63 as an int64


def _interleave(codes: torch.Tensor, bits: int, width: int) -> torch.Tensor:
    """(N, m) int64 codes -> (N,) int64 Morton keys of ``width`` bits."""
    n, m = codes.shape
    keys = torch.zeros(n, dtype=torch.int64, device=codes.device)
    for b in range(bits):
        for j in range(m):
            pos = b * m + j
            if pos < width:
                keys |= ((codes[:, j] >> b) & 1) << pos
    return keys


def zorder_keys(values: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                bits: int = 10) -> torch.Tensor:
    """(N, m) float32 values, (m,) float32 lo/hi -> (N,) int64 keys.

    The TPU kernel ``zorder_keys_pallas``'s function; each key is the
    uint32 Morton code, ``m * bits <= 32`` and ``bits <= 16``.
    """
    span = torch.clamp_min(hi - lo, 1e-12)
    q = torch.clamp((values - lo) / span, 0.0, 1.0)
    codes = (q * ((1 << bits) - 1)).to(torch.int64)
    return _interleave(codes, bits, 32)


def flip(keys: torch.Tensor) -> torch.Tensor:
    """uint64 bit patterns held in int64 -> int64 in the same order."""
    return keys ^ _SIGN


def unflip(keys) -> np.ndarray:
    """The flipped int64 keys of :func:`zorder_keys64` as numpy uint64."""
    k = torch.as_tensor(keys).cpu().numpy().astype(np.int64)
    return (k ^ np.int64(_SIGN)).view(np.uint64)


def zorder_keys64(table: torch.Tensor, zcols: Sequence[int],
                  col_lo: torch.Tensor, col_hi: torch.Tensor
                  ) -> torch.Tensor:
    """(N, C) float64 table, m column indices, (m,) float64 lo/hi ->
    (N,) int64 keys with bit 63 flipped (see :func:`unflip`)."""
    cols = torch.as_tensor(np.asarray(zcols, dtype=np.int64),
                           device=table.device)
    span = torch.clamp_min(col_hi - col_lo, 1e-12)
    q = torch.clamp((table.index_select(1, cols) - col_lo) / span, 0.0, 1.0)
    codes = (q * ((1 << ZBITS) - 1)).to(torch.int64)
    return flip(_interleave(codes, ZBITS, 64))


def zorder_route64(table: torch.Tensor, zcols: Sequence[int],
                   col_lo: torch.Tensor, col_hi: torch.Tensor,
                   boundaries: torch.Tensor, k: int) -> torch.Tensor:
    """(N, C) float64 table, m column indices, (m,) float64 lo/hi, the
    ``k - 1`` sorted flipped int64 key boundaries -> (N,) int64 partition
    ids in ``[0, k - 1]``."""
    keys = zorder_keys64(table, zcols, col_lo, col_hi)
    return torch.clamp_max(
        torch.searchsorted(boundaries, keys, right=True), k - 1)
