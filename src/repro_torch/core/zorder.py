"""Workload-aware Z-order layout generation (paper §VI-A1).

Picks the top-m most-queried columns in the recent window, quantizes each to
16-bit codes, interleaves bits (Morton order), sorts and splits into k
equal-size partitions.

Split between host and device: the column choice and the sample draw (a
numpy ``Generator``, seeded as in the reference) stay on the host; the
sample gather, its bounds, the keys, their sort and the zone maps run on
the table's device.  A build keys its sample's key columns once, with the
Z-order kernel's 64-bit lane
(:func:`repro_torch.kernels.zorder.ops.zorder_keys64`), as int64 with bit
63 flipped so that signed order is the reference's unsigned order, and
routes the sample by ``torch.searchsorted`` over those keys; the router
reads a table in place and keys and routes it in one kernel pass
(:func:`repro_torch.kernels.zorder.ops.zorder_route64`).  Every step is
exact, so the layout equals the reference's.

:func:`quantize_columns` and :func:`interleave_bits` are host numpy copies
of the reference's, kept for parity checks.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.zorder import ops as zops

from . import layouts, workload as wl

ZBITS = 16  # bits per column in the Morton code


def quantize_columns(values: np.ndarray, col_lo: np.ndarray,
                     col_hi: np.ndarray) -> np.ndarray:
    """Linear-quantize selected columns to ZBITS-bit integer codes."""
    span = np.maximum(col_hi - col_lo, 1e-12)
    q = (values - col_lo) / span
    q = np.clip(q, 0.0, 1.0)
    return (q * ((1 << ZBITS) - 1)).astype(np.uint64)


def interleave_bits(codes: np.ndarray) -> np.ndarray:
    """Morton-interleave (N, m) ZBITS-bit codes into (N,) uint64 keys.

    Bit b of column j lands at position b*m + j, so high bits of all columns
    dominate jointly (standard Z-order).
    """
    n, m = codes.shape
    keys = np.zeros(n, dtype=np.uint64)
    for b in range(ZBITS):
        for j in range(m):
            bit = (codes[:, j] >> np.uint64(b)) & np.uint64(1)
            keys |= bit << np.uint64(b * m + j)
    return keys


class _ZOrderRouter:
    """Z-key quantile routing; a class (not a closure) so layouts — and
    the engines holding them — stay picklable.

    ``zcols`` is a host array; ``col_lo``/``col_hi`` (float64) and the
    ``k - 1`` flipped int64 ``boundaries`` live on the table's device.
    """

    def __init__(self, zcols, col_lo: torch.Tensor, col_hi: torch.Tensor,
                 boundaries: torch.Tensor, k: int):
        self.zcols = zcols
        self.col_lo = col_lo
        self.col_hi = col_hi
        self.boundaries = boundaries
        self.k = k

    def __call__(self, rows: torch.Tensor) -> torch.Tensor:
        return zops.zorder_route64(rows, self.zcols, self.col_lo,
                                   self.col_hi, self.boundaries, self.k)


def build_zorder_layout(layout_id: int,
                        data: torch.Tensor,
                        queries: Sequence[wl.Query],
                        k: int,
                        num_zcols: int = 3,
                        sample_frac: float = 0.02,
                        min_sample_rows: int = 4096,
                        seed: int = 0,
                        name: Optional[str] = None) -> layouts.Layout:
    """Generate a Z-order layout on the top-``num_zcols`` queried columns.

    Built from a data sample: key-quantile partition boundaries and estimated
    metadata come from the sample; exact metadata is computed only on
    materialization (actual reorganization).
    """
    rng = np.random.default_rng(seed)
    n, c = data.shape
    dev = data.device
    hist = wl.queried_column_histogram(queries, c)
    if hist.sum() == 0:
        zcols = np.arange(min(num_zcols, c))
    else:
        zcols = np.argsort(-hist, kind="stable")[:num_zcols]
    zcols = np.sort(zcols)

    m = min(max(int(n * sample_frac), min(n, min_sample_rows)), n)
    sample = data[torch.as_tensor(rng.choice(n, size=m, replace=False),
                                  device=dev)]
    sub = sample.index_select(1, torch.as_tensor(zcols, device=dev))
    col_lo = sub.amin(dim=0)
    col_hi = sub.amax(dim=0)
    keys = zops.zorder_keys64(sub, np.arange(len(zcols)), col_lo, col_hi)

    # Key-quantile boundaries let `route` assign any row consistently.
    cut = np.minimum((np.arange(1, k) * m) // k, m - 1)
    boundaries = torch.sort(keys).values[torch.as_tensor(cut, device=dev)]

    route = _ZOrderRouter(zcols, col_lo, col_hi, boundaries, k)
    # route(sample), from the keys already made.
    assignment = torch.clamp_max(
        torch.searchsorted(boundaries, keys, right=True), k - 1)
    meta = layouts.metadata_from_assignment(sample, assignment, k,
                                            row_scale=n / m)
    return layouts.Layout(
        layout_id=layout_id,
        name=name or f"zorder[{','.join(map(str, zcols.tolist()))}]#{layout_id}",
        technique="zorder",
        meta=meta,
        route=route,
        info={"zcols": zcols.tolist(), "sample_rows": m},
    )
