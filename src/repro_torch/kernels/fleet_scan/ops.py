"""Public wrappers over the fleet-scan kernel.

``scan_fleet`` is the kernel's wrapper: CUDA tensors go to the kernel, CPU
tensors to the plain version.  ``fleet_scan_fractions`` weights the scan
by per-slot row counts, as the cost model does: the bool scan is copied
back and reduced on the host, so the sums do not depend on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from . import fleet_scan

scan_fleet = fleet_scan.scan_fleet


def fleet_scan_fractions(q_lo, q_hi, p_min, p_max, rows) -> np.ndarray:
    """(T, N) scan reduced to host float64 (T,) fraction of rows read per
    tenant.

    ``rows`` is (T, N), a tensor or an array: per-slot row counts, zero in
    padded slots, so each tenant's fraction is sum(scanned rows) /
    max(sum(all rows), 1).
    """
    rows = np.ascontiguousarray(torch.as_tensor(rows).cpu().numpy(),
                                dtype=np.float64)
    scanned = scan_fleet(q_lo, q_hi, p_min, p_max).cpu().numpy()
    return (np.einsum("tn,tn->t", scanned, rows)
            / np.maximum(rows.sum(axis=1), 1.0))
