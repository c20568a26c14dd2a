"""Plain PyTorch version of the move-score kernel.

The broadcast ``(Q, S, P, C)`` overlap AND, then a count over the Q window
rows divided by Q, in float64: the oracle the CUDA kernel is held to, and
what the wrapper runs on CPU tensors.  The count is an integer and the one
division is correctly rounded, so the result is exactly numpy's mean of the
reference's 0/1 scan matrix.  Q is divided as a 0-dim tensor: PyTorch's
CUDA division turns a Python-number divisor into a multiply by its
reciprocal, which can miss count / Q by an ulp.
"""
from __future__ import annotations

import torch


def move_scores(q_lo: torch.Tensor, q_hi: torch.Tensor, p_min: torch.Tensor,
                p_max: torch.Tensor) -> torch.Tensor:
    """(Q, C) x (S, P, C) -> (S, P) float64 per-partition scan frequency.

    ``out[s, p]`` is the fraction of the Q window queries that must scan
    partition p of state s.
    """
    ov = ((p_min[None] <= q_hi[:, None, None, :])
          & (p_max[None] >= q_lo[:, None, None, :])).all(dim=-1)
    count = ov.sum(dim=0).to(torch.float64)
    return count / count.new_full((), q_lo.shape[0])
