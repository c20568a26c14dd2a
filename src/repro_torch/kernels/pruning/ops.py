"""Public wrappers over the pruning kernel.

``scan_matrix`` is the kernel's wrapper: CUDA tensors go to the kernel,
CPU tensors to the plain version.  ``scan_fractions`` and ``cost_vectors``
weight the scan matrix by partition row counts, as the cost model does:
the bool scan matrix is copied back and reduced on the host through
:func:`repro_torch.core.layouts.scanned_dot`, so the sums are the
reference package's, bit for bit, on any device.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from . import pruning

scan_matrix = pruning.scan_matrix


def scan_fractions(q_lo, q_hi, p_min, p_max, rows) -> np.ndarray:
    """Fraction of data records each query accesses: host float64 (Q,).

    ``rows`` is the (P,) row count per partition, a tensor or an array.
    """
    from repro_torch.core.layouts import scanned_dot
    rows = np.ascontiguousarray(torch.as_tensor(rows).cpu().numpy(),
                                dtype=np.float64)
    scanned = scan_matrix(q_lo, q_hi, p_min, p_max).cpu().numpy()
    return scanned_dot(scanned, rows) / max(rows.sum(), 1.0)


def cost_vectors(q_lo, q_hi,
                 layouts_meta: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]]) -> np.ndarray:
    """Batch cost vectors for several layouts (list of (min, max, rows)):
    host float64 (L, Q)."""
    return np.stack([scan_fractions(q_lo, q_hi, p_min, p_max, rows)
                     for p_min, p_max, rows in layouts_meta])
