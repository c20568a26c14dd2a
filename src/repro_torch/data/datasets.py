"""Synthetic tables, built on a device.

``make_tpch_like`` is a denormalized lineitem-style fact table: mixed
uniform / correlated-date / low-cardinality-categorical columns.
``widen_columns`` pads a table with extra measure/dimension columns to the
width of the paper's denormalized tables.  Both draw from numpy with the
reference package's calls in the reference's order, so at the same seed the
table is the reference's, bit for bit (arithmetic between columns is single
IEEE operations, which the device rounds as the host does).

Tables are built one column at a time into a preallocated (N, C) float64
tensor on the device, so host memory stays near one column however many
rows the table has.
"""
from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels._backend import resolve_device

TPCH_COLUMNS = ["ship_date", "commit_date", "receipt_date", "quantity",
                "extended_price", "discount", "tax", "order_key", "part_key",
                "supp_key", "line_status", "return_flag"]

Device = Union[None, str, torch.device]


def _fill_tpch(out: torch.Tensor, seed: int) -> None:
    """Write the TPC-H-like columns into ``out[:, :12]``."""
    rng = np.random.default_rng(seed)
    n = out.shape[0]

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, dtype=np.float64)).to(out.device)

    out[:, 0] = dev(rng.uniform(0, 2500, n))                   # ship, days
    out[:, 1] = out[:, 0] + dev(rng.normal(30, 15, n))         # correlated
    out[:, 2] = out[:, 0] + dev(np.abs(rng.normal(14, 7, n)))
    out[:, 3] = dev(rng.integers(1, 51, n))                    # quantity
    out[:, 4] = out[:, 3] * dev(rng.uniform(900, 105000 / 50, n))
    out[:, 5] = dev(rng.choice(np.arange(0, 0.11, 0.01), n))   # discount
    out[:, 6] = dev(rng.choice(np.arange(0, 0.09, 0.01), n))   # tax
    out[:, 7] = torch.sort(dev(rng.uniform(0, 6e6, n))).values  # clustered
    out[:, 8] = dev(rng.uniform(0, 2e5, n))
    out[:, 9] = dev(rng.uniform(0, 1e4, n))
    out[:, 10] = dev(rng.integers(0, 2, n))
    out[:, 11] = dev(rng.integers(0, 3, n))


def _fill_widen(out: torch.Tensor, c: int, seed: int) -> None:
    """Write the extra columns ``out[:, c:]`` from the base ``out[:, :c]``."""
    n, target = out.shape
    rng = np.random.default_rng(seed + 99)

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, dtype=np.float64)).to(out.device)

    for i in range(target - c):
        kind = i % 3
        if kind == 0:
            out[:, c + i] = dev(rng.uniform(0, 1000, n))
        elif kind == 1:
            out[:, c + i] = dev(rng.zipf(1.6, n).clip(max=5000))
        else:
            scale = rng.uniform(0.5, 2.0)
            out[:, c + i] = out[:, i % c] * scale + dev(rng.normal(0, 10, n))


def make_tpch_like(n_rows: int = 200_000, seed: int = 0,
                   device: Device = None) -> Tuple[torch.Tensor, List[str]]:
    """(N, 12) TPC-H-like table on ``device`` (the card by default)."""
    out = torch.empty((n_rows, len(TPCH_COLUMNS)), dtype=torch.float64,
                      device=resolve_device(device))
    _fill_tpch(out, seed)
    return out, list(TPCH_COLUMNS)


def widen_columns(data: torch.Tensor, target_cols: int,
                  seed: int) -> torch.Tensor:
    """Pad a table with extra measure/dimension columns up to
    ``target_cols`` (the paper's denormalized tables have 58 columns)."""
    n, c = data.shape
    if c >= target_cols:
        return data
    out = torch.empty((n, target_cols), dtype=data.dtype, device=data.device)
    out[:, :c] = data
    _fill_widen(out, c, seed)
    return out


def build_table(n_rows: int, num_columns: int = 32, seed: int = 0,
                device: Device = None) -> torch.Tensor:
    """``widen_columns(make_tpch_like(n_rows, seed)[0], num_columns, seed)``
    built straight into one preallocated tensor: no second copy of the
    table on the device."""
    base = len(TPCH_COLUMNS)
    out = torch.empty((n_rows, max(base, num_columns)), dtype=torch.float64,
                      device=resolve_device(device))
    _fill_tpch(out, seed)
    _fill_widen(out, base, seed)
    return out
