"""Plain PyTorch version of the partition-pruning kernel.

Semantics match :func:`repro_torch.core.layouts.partitions_scanned`: a
partition must be scanned iff every column's [min, max] zone overlaps the
query's [lo, hi] range.  Comparisons are exact in any dtype, so this is the
oracle the CUDA kernel is held to, and what the wrapper runs on CPU tensors.
"""
from __future__ import annotations

import torch


def scan_matrix(q_lo: torch.Tensor, q_hi: torch.Tensor, p_min: torch.Tensor,
                p_max: torch.Tensor) -> torch.Tensor:
    """(Q, C), (Q, C), (P, C), (P, C) -> (Q, P) bool."""
    overlap = ((p_min[None, :, :] <= q_hi[:, None, :])
               & (p_max[None, :, :] >= q_lo[:, None, :]))       # (Q, P, C)
    return overlap.all(dim=-1)
