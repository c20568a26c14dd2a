"""The metadata plane's scan matrix: one entry point, on the zone maps' device.

Everything the decision loop evaluates — service-cost estimates over all
candidate states, cost vectors over the R-TBS sample, serving — reduces to
the (Q, P) interval-overlap *scan matrix* over C columns.  This module
computes it where the zone maps live and hands it back to the host:

* on a CUDA device it is the hand-written kernel
  (:func:`repro_torch.kernels.pruning.pruning.scan_matrix`), which compares
  in float64 and is therefore exact on every input;
* on the CPU it is the kernel's plain PyTorch version.

Query bounds arrive as host arrays and go over in one copy; the bool scan
matrix (a few hundred bytes per query) comes back, and every caller reduces
it on the host with the same numpy einsum as the reference package, so
costs are bit-identical on both devices.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.pruning import pruning

#: Device types the scan runs on: the kernel on ``cuda``, its plain
#: version on ``cpu``.
BACKENDS = ("cpu", "cuda")


def scan_matrix(q_lo: np.ndarray, q_hi: np.ndarray, mins: torch.Tensor,
                maxs: torch.Tensor) -> np.ndarray:
    """(Q, C) host query bounds x (P, C) zone maps -> (Q, P) host bool.

    ``out[q, p]`` is True iff partition p must be scanned for query q, i.e.
    every column's [min, max] zone overlaps the query's [lo, hi] range.
    ``mins``/``maxs`` may be a row-strided view of a larger plane.
    """
    bounds = torch.as_tensor(np.stack([np.asarray(q_lo, dtype=np.float64),
                                       np.asarray(q_hi, dtype=np.float64)]),
                             device=mins.device)
    return pruning.scan_matrix(bounds[0], bounds[1], mins, maxs).cpu().numpy()


def masked_overlap(mins: torch.Tensor, maxs: torch.Tensor, q_lo: np.ndarray,
                   q_hi: np.ndarray) -> np.ndarray:
    """One query against a ``(..., P, C)`` plane -> host bool ``(..., P)``.

    The leading axes are flattened into partition rows, so a packed
    ``(S, P, C)`` plane is scanned in one launch; it must be viewable as
    ``(S * P, C)`` without a copy (a leading-axis slice of a contiguous
    plane is).
    """
    lead = mins.shape[:-1]
    rows = int(np.prod(lead, dtype=np.int64))
    flat_min = mins.view(rows, mins.shape[-1])
    flat_max = maxs.view(rows, maxs.shape[-1])
    out = scan_matrix(q_lo[None], q_hi[None], flat_min, flat_max)
    return out.reshape(lead)
