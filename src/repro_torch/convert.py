"""Carry layouts across from their numpy form.

A layout of the reference package is numpy arrays: zone maps
(``meta.mins``, ``meta.maxs``, ``meta.rows``) and a router — a qd-tree's
packed node arrays (``cols``, ``thresholds``, ``lefts``, ``rights``,
``leaf_ids``) or the default router's fields (``k``, ``sort_col``,
``boundaries``).  These functions rebuild the zone maps and the router in
this package, on a given device (the card by default), from those arrays
alone; ``repro_torch.core.layouts.Layout`` joins them into a layout.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core import layouts, qdtree
from repro_torch.kernels._backend import resolve_device, to_device

Device = Union[None, str, torch.device]


def metadata(mins: np.ndarray, maxs: np.ndarray, rows: np.ndarray,
             device: Device = None) -> layouts.PartitionMetadata:
    """Zone maps (P, C), (P, C) and row counts (P,) on ``device``."""
    dev = resolve_device(device)
    rows_host = np.array(rows, dtype=np.float64)
    return layouts.PartitionMetadata(
        mins=to_device(mins, dev), maxs=to_device(maxs, dev),
        rows=to_device(rows_host, dev), rows_host=rows_host)


def tree_router(cols: np.ndarray, thresholds: np.ndarray, lefts: np.ndarray,
                rights: np.ndarray, leaf_ids: np.ndarray,
                device: Device = None) -> qdtree._TreeRouter:
    """A qd-tree router from its packed node arrays."""
    return qdtree._TreeRouter(np.asarray(cols), np.asarray(thresholds),
                              np.asarray(lefts), np.asarray(rights),
                              np.asarray(leaf_ids), resolve_device(device))


def default_router(k: int, sort_col: Optional[int],
                   boundaries: Optional[np.ndarray],
                   device: Device = None) -> qdtree._DefaultRouter:
    """The arrival-order (or sort-column quantile) router."""
    dev = resolve_device(device)
    return qdtree._DefaultRouter(
        int(k), None if sort_col is None else int(sort_col),
        None if boundaries is None else to_device(boundaries, dev))

