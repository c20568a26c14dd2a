"""Plain PyTorch version of the fused fleet-scan kernel.

Every tenant's query against that tenant's own packed plane: slot n of
tenant t must be scanned iff every column's [min, max] zone overlaps the
query's [lo, hi] range.  Comparisons are exact in any dtype, so this is the
oracle the CUDA kernel is held to, and what the wrapper runs on CPU tensors.
"""
from __future__ import annotations

import torch


def scan_fleet(q_lo: torch.Tensor, q_hi: torch.Tensor, p_min: torch.Tensor,
               p_max: torch.Tensor) -> torch.Tensor:
    """(T, C), (T, C), (T, N, C), (T, N, C) -> (T, N) bool."""
    overlap = ((p_min <= q_hi[:, None, :])
               & (p_max >= q_lo[:, None, :]))                   # (T, N, C)
    return overlap.all(dim=-1)
