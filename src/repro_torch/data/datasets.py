"""Synthetic tables, built on a device, mirroring the paper's three workloads.

* ``make_tpch_like``: a denormalized lineitem-style fact table -- mixed
  uniform / correlated-date / low-cardinality-categorical columns.
* ``make_tpcds_like``: a store_sales-style fact table with dimension-coded
  columns and skewed (Zipf) categorical distributions.
* ``make_telemetry_like``: an ingestion-log table dominated by an
  arrival-time column (queries are time ranges + collector filters), as
  the paper describes SuperCollider (§VI-A2); ``telemetry_templates``
  gives its query templates.

``widen_columns`` pads a table with extra measure/dimension columns to the
width of the paper's denormalized tables.  All draw from numpy with the
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
TPCDS_COLUMNS = ["sold_date", "sold_time", "item", "customer", "store",
                 "promo", "quantity", "wholesale", "list_price",
                 "sales_price", "ext_discount", "net_paid", "net_profit"]
TELEMETRY_COLUMNS = ["arrival_time", "collector", "job_id", "duration",
                     "rows_in", "bytes_in", "status", "team", "retries"]

Device = Union[None, str, torch.device]


def _on(out: torch.Tensor):
    """A host array -> float64 tensor on ``out``'s device."""
    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, dtype=np.float64)).to(out.device)
    return dev


def _fill_tpch(out: torch.Tensor, seed: int) -> None:
    """Write the TPC-H-like columns into ``out[:, :12]``."""
    rng = np.random.default_rng(seed)
    n = out.shape[0]
    dev = _on(out)

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
    dev = _on(out)

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


def make_tpcds_like(n_rows: int = 200_000, seed: int = 1,
                    device: Device = None) -> Tuple[torch.Tensor, List[str]]:
    """(N, 13) TPC-DS-like table on ``device`` (the card by default)."""
    out = torch.empty((n_rows, len(TPCDS_COLUMNS)), dtype=torch.float64,
                      device=resolve_device(device))
    rng = np.random.default_rng(seed)
    n = n_rows
    dev = _on(out)
    out[:, 0] = torch.sort(dev(rng.uniform(2450000, 2453000, n))).values
    out[:, 1] = dev(rng.uniform(0, 86400, n))                  # sold_time
    out[:, 2] = dev(rng.zipf(1.5, n).clip(max=18000))          # item
    out[:, 3] = dev(rng.uniform(0, 1e5, n))                    # customer
    out[:, 4] = dev(rng.zipf(1.3, n).clip(max=400))            # store
    out[:, 5] = dev(rng.zipf(2.0, n).clip(max=300))            # promo
    out[:, 6] = dev(rng.integers(1, 100, n))                   # quantity
    out[:, 7] = dev(rng.uniform(1, 100, n))                    # wholesale
    out[:, 8] = out[:, 7] * dev(rng.uniform(1.0, 2.0, n))      # list_price
    out[:, 9] = out[:, 8] * dev(rng.uniform(0.2, 1.0, n))      # sales_price
    out[:, 10] = (out[:, 8] - out[:, 9]) * out[:, 6]           # ext_discount
    out[:, 11] = out[:, 9] * out[:, 6]                         # net_paid
    out[:, 12] = out[:, 11] - out[:, 7] * out[:, 6]            # net_profit
    return out, list(TPCDS_COLUMNS)


def make_telemetry_like(n_rows: int = 200_000, seed: int = 2,
                        device: Device = None
                        ) -> Tuple[torch.Tensor, List[str]]:
    """(N, 9) telemetry-like table on ``device`` (the card by default)."""
    out = torch.empty((n_rows, len(TELEMETRY_COLUMNS)), dtype=torch.float64,
                      device=resolve_device(device))
    rng = np.random.default_rng(seed)
    n = n_rows
    dev = _on(out)
    out[:, 0] = torch.sort(dev(rng.uniform(0, 180 * 86400, n))).values
    out[:, 1] = dev(rng.zipf(1.4, n).clip(max=120))            # collector
    out[:, 2] = dev(rng.uniform(0, 5e4, n))                    # job_id
    out[:, 3] = dev(np.abs(rng.normal(300, 200, n)))           # duration
    out[:, 4] = dev(np.abs(rng.normal(1e6, 5e5, n)))           # rows_in
    out[:, 5] = out[:, 4] * dev(rng.uniform(50, 200, n))       # bytes_in
    out[:, 6] = dev(rng.choice([0, 1, 2], n, p=[0.9, 0.07, 0.03]))
    out[:, 7] = dev(rng.zipf(1.6, n).clip(max=100))            # team
    out[:, 8] = dev(rng.poisson(0.2, n))                       # retries
    return out, list(TELEMETRY_COLUMNS)


DATASETS = {
    "tpch": make_tpch_like,
    "tpcds": make_tpcds_like,
    "telemetry": make_telemetry_like,
}


def telemetry_templates(num_columns: int, seed: int = 0):
    """Telemetry-flavored templates matching the paper's description of the
    SuperCollider trace: time-range queries (hours..months), collector-name
    filters, plus job-debugging families (team dashboards, failure triage,
    long-job investigations, volume outliers) that conflict with pure
    time-ordering."""
    from repro_torch.core import workload as wl
    rng = np.random.default_rng(seed)
    templates = []
    tid = 0
    for hours in (6, 48, 24 * 30):     # time-range families
        sel = hours * 3600 / (180 * 86400)
        templates.append(wl.QueryTemplate(tid, (0,), (min(sel, 1.0),)))
        tid += 1
    for _ in range(2):                 # collector + time families
        templates.append(wl.QueryTemplate(
            tid, (1, 0), (float(rng.uniform(0.01, 0.05)),
                          float(rng.uniform(0.05, 0.2)))))
        tid += 1
    # cols: 2=job_id 3=duration 4=rows_in 5=bytes_in 6=status 7=team
    for cols, sels in (((7,), (0.03,)), ((6, 3), (0.05, 0.1)),
                       ((3,), (0.05,)), ((4, 5), (0.08, 0.15)),
                       ((2,), (0.04,))):
        templates.append(wl.QueryTemplate(tid, cols, sels))
        tid += 1
    return templates


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
