"""The metadata plane's scan matrix: the entry points, on the zone maps' device.

Everything the decision loop evaluates — service-cost estimates over all
candidate states, cost vectors over the R-TBS sample, serving — reduces to
the interval-overlap *scan matrix* over C columns.  This module computes it
where the zone maps live and hands it back to the host:

* :func:`scan_matrix` / :func:`masked_overlap` / :func:`block_overlap`:
  one table's (Q, P) scan, the pruning kernel
  (:mod:`repro_torch.kernels.pruning`);
* :func:`fleet_scan_matrix`: every tenant's query against its own packed
  plane, one fleet-scan launch per frame
  (:mod:`repro_torch.kernels.fleet_scan`);
* :func:`fused_frames_scan`: a whole block of frames against the fleet
  plane in one launch of the fused decision kernel
  (:mod:`repro_torch.kernels.decision_fused`);
* :func:`move_frequencies` / :func:`fused_window_freq`: the share of a
  window of recent queries scanning each partition, which orders a
  migration's micro-moves: the move-score kernel
  (:mod:`repro_torch.kernels.move_score`) or the fused decision kernel's
  ``freq`` output with no frames.

On a CUDA device each is the hand-written kernel, which compares in float64
and is therefore exact on every input; on the CPU it is the kernel's plain
PyTorch version.  Query bounds arrive as host arrays and go over in one
copy per call (:func:`block_overlap` takes them already on the device, a
row slice of a run's stacked bounds); the bool scan comes back in one
copy, and every caller
reduces it on the host with the same numpy einsum as the reference
package, so costs are bit-identical on both devices.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.decision_fused import decision_fused
from repro_torch.kernels.fleet_scan import fleet_scan
from repro_torch.kernels.move_score import move_score
from repro_torch.kernels.pruning import pruning

#: Device types the scans run on: the kernels on ``cuda``, their plain
#: versions on ``cpu``.
DEVICES = ("cpu", "cuda")

#: The fleet plane's two scoring lanes, each named after the kernel it
#: launches: ``fleet_scan`` once per frame, ``decision_fused`` once per
#: pass of frames.
BACKENDS = ("fleet_scan", "decision_fused")


def _bounds(q_lo: np.ndarray, q_hi: np.ndarray,
            device: torch.device) -> torch.Tensor:
    """Host lo/hi bounds as one (2, ...) float64 tensor: one copy."""
    return torch.as_tensor(np.stack([np.asarray(q_lo, dtype=np.float64),
                                     np.asarray(q_hi, dtype=np.float64)]),
                           device=device)


def scan_matrix(q_lo: np.ndarray, q_hi: np.ndarray, mins: torch.Tensor,
                maxs: torch.Tensor) -> np.ndarray:
    """(Q, C) host query bounds x (P, C) zone maps -> (Q, P) host bool.

    ``out[q, p]`` is True iff partition p must be scanned for query q, i.e.
    every column's [min, max] zone overlaps the query's [lo, hi] range.
    ``mins``/``maxs`` may be a row-strided view of a larger plane.
    """
    bounds = _bounds(q_lo, q_hi, mins.device)
    return pruning.scan_matrix(bounds[0], bounds[1], mins, maxs).cpu().numpy()


def masked_overlap(mins: torch.Tensor, maxs: torch.Tensor, q_lo: np.ndarray,
                   q_hi: np.ndarray) -> np.ndarray:
    """One query against a ``(..., P, C)`` plane -> host bool ``(..., P)``.

    The leading axes are flattened into partition rows, so a packed
    ``(S, P, C)`` plane is scanned in one launch; it must be viewable as
    ``(S * P, C)`` without a copy (a leading-axis slice of a contiguous
    plane is).
    """
    bounds = _bounds(q_lo[None], q_hi[None], mins.device)
    return block_overlap(mins, maxs, bounds[0], bounds[1])[0]


def block_overlap(mins: torch.Tensor, maxs: torch.Tensor, q_lo: torch.Tensor,
                  q_hi: torch.Tensor) -> np.ndarray:
    """A block of queries against a ``(..., P, C)`` plane -> host bool
    ``(B, ..., P)``, C-contiguous.

    ``q_lo``/``q_hi`` are (B, C) float64 tensors on the plane's device,
    read in place (a row slice of a larger bounds tensor is); the plane is
    flattened into partition rows as in :func:`masked_overlap`.  One
    launch, one copy back; row ``b`` of the result equals
    :func:`masked_overlap` on query ``b``.
    """
    lead = mins.shape[:-1]
    rows = int(np.prod(lead, dtype=np.int64))
    flat_min = mins.view(rows, mins.shape[-1])
    flat_max = maxs.view(rows, maxs.shape[-1])
    out = pruning.scan_matrix(q_lo, q_hi, flat_min, flat_max)
    return out.cpu().numpy().reshape((len(q_lo),) + tuple(lead))


def fleet_scan_matrix(q_lo: np.ndarray, q_hi: np.ndarray, mins: torch.Tensor,
                      maxs: torch.Tensor) -> np.ndarray:
    """(T, C) per-tenant host bounds x (T, N, C) plane -> (T, N) host bool.

    The fused fleet-wide scan: every tenant's slots are scored against that
    tenant's query.  ``q_lo``/``q_hi`` may also be (B, T, C), a block of B
    frames: the bounds go over in one copy, the kernel runs once per frame
    and the (B, T, N) result comes back in one copy.  ``mins``/``maxs`` may
    be a view of a larger plane (dense columns).
    """
    single = np.ndim(q_lo) == 2
    bounds = _bounds(q_lo, q_hi, mins.device)
    if single:
        bounds = bounds[:, None]
    frames = [fleet_scan.scan_fleet(bounds[0, k], bounds[1, k], mins, maxs)
              for k in range(bounds.shape[1])]
    if not frames:
        return np.zeros((0,) + tuple(mins.shape[:2]), dtype=bool)
    out = torch.stack(frames).cpu().numpy()
    return out[0] if single else out


def fused_frames_scan(q_lo: np.ndarray, q_hi: np.ndarray, p_min: torch.Tensor,
                      p_max: torch.Tensor) -> np.ndarray:
    """(B, T, C) host frame bounds x (T, S, P, C) plane -> (B, T, S, P)
    host bool, C-contiguous.

    One launch of the fused decision kernel scores every frame of a batched
    pass for every tenant — the counterpart of B :func:`fleet_scan_matrix`
    launches.
    """
    bounds = _bounds(q_lo, q_hi, p_min.device)
    scan, _, _ = decision_fused.fused_decision(bounds[0], bounds[1], p_min,
                                               p_max)
    return scan.cpu().numpy()


def move_frequencies(q_lo: np.ndarray, q_hi: np.ndarray, p_min: torch.Tensor,
                     p_max: torch.Tensor) -> np.ndarray:
    """(Q, C) host window x (S, P, C) plane -> (S, P) host float64.

    ``out[s, p]`` is ``count / Q``, the share of the window's queries that
    scan partition p of state s: one launch of the move-score kernel.
    """
    bounds = _bounds(q_lo, q_hi, p_min.device)
    return move_score.move_scores(bounds[0], bounds[1], p_min,
                                  p_max).cpu().numpy()


def fused_window_freq(q_lo: np.ndarray, q_hi: np.ndarray, p_min: torch.Tensor,
                      p_max: torch.Tensor) -> np.ndarray:
    """(W, C) host window x (T, S, P, C) plane -> (T, S, P) host float64.

    The fused decision kernel's ``freq`` output alone: one launch with no
    frames (B = 0) and no scan, the same ``count / W`` as
    :func:`move_frequencies`.
    """
    bounds = _bounds(q_lo, q_hi, p_min.device)
    t, c = p_min.shape[0], p_min.shape[3]
    frames = torch.empty((0, t, c), dtype=torch.float64, device=p_min.device)
    _, _, freq = decision_fused.fused_decision(
        frames, frames, p_min, p_max, w_lo=bounds[0], w_hi=bounds[1],
        emit_scan=False)
    return freq.cpu().numpy()
