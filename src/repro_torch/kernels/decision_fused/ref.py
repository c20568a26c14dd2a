"""Plain PyTorch version of the fused decision kernel.

Computes the same three products as the CUDA kernel by materializing the
broadcast tensors directly: the oracle the kernel is held to, and what the
wrapper runs on CPU tensors.  The scan is a conjunction of comparisons and
``freq`` a count divided by W, both exact (W is divided as a 0-dim
tensor: PyTorch's CUDA division turns a Python-number divisor into a
multiply by its reciprocal, which can miss count / W by an ulp); ``cost``
is a sum over P, whose order may differ from the kernel's in the last
bits.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _overlap(lo: torch.Tensor, hi: torch.Tensor, p_min: torch.Tensor,
             p_max: torch.Tensor) -> torch.Tensor:
    """(K, KT, C) bounds x (T, S, P, C) plane -> (K, T, S, P) bool; KT is
    T (per-tenant frames) or 1 (a window row shared by every tenant)."""
    return ((p_min[None] <= hi[:, :, None, None, :])
            & (p_max[None] >= lo[:, :, None, None, :])).all(dim=-1)


def fused_decision(q_lo: torch.Tensor, q_hi: torch.Tensor,
                   p_min: torch.Tensor, p_max: torch.Tensor,
                   rows: Optional[torch.Tensor] = None,
                   inv_totals: Optional[torch.Tensor] = None,
                   w_lo: Optional[torch.Tensor] = None,
                   w_hi: Optional[torch.Tensor] = None,
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                              Optional[torch.Tensor]]:
    """One pass over the packed fleet plane, three decision products.

    * ``scan``: (B, T, S, P) bool — frame b's query for tenant t overlaps
      partition p of state s;
    * ``cost``: (B, T, S) — ``(sum_p scan * rows) * inv_totals``
      (``None`` unless ``rows`` and ``inv_totals`` are given);
    * ``freq``: (T, S, P) — the share of the (W, C) window's rows that
      scan each partition, ``count / W`` (``None`` unless ``w_lo`` and
      ``w_hi`` are given).
    """
    scan = _overlap(q_lo, q_hi, p_min, p_max)
    cost = None
    if rows is not None:
        cost = (scan.to(rows.dtype) * rows[None]).sum(dim=-1) * inv_totals[None]
    freq = None
    if w_lo is not None:
        count = _overlap(w_lo[:, None], w_hi[:, None], p_min, p_max).sum(dim=0)
        count = count.to(p_min.dtype)
        freq = count / count.new_full((), w_lo.shape[0])
    return scan, cost, freq
