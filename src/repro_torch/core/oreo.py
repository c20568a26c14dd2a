"""OREO run configuration and result traces.

The online loop of Figure 1 — including the paper's Δ-delay semantics for
background reorganization (§VI-D5) — lives in :mod:`repro_torch.engine`
(:class:`~repro_torch.engine.LayoutEngine` +
:class:`~repro_torch.engine.OreoPolicy`).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from . import layout_manager as lm


@dataclasses.dataclass
class RunResult:
    """Per-query trace of an online (or offline) reorganization run."""

    name: str
    alpha: float
    query_costs: np.ndarray                 # (T,) fraction of data accessed
    reorg_indices: List[int]                # query idx at which reorgs charged
    state_seq: np.ndarray                   # (T,) decision state per query
    info: dict = dataclasses.field(default_factory=dict)
    # Wall-clock breakdown of the run, aggregated by the engine over every
    # query stepped: decision layer / physical reorganization (prepare +
    # swap) / serving.  Zero for traces not produced by an engine.
    decide_seconds: float = 0.0
    reorg_seconds: float = 0.0
    serve_seconds: float = 0.0

    @property
    def wall_seconds(self) -> float:
        return self.decide_seconds + self.reorg_seconds + self.serve_seconds

    @property
    def total_query_cost(self) -> float:
        return float(self.query_costs.sum())

    @property
    def total_reorg_cost(self) -> float:
        return float(len(self.reorg_indices) * self.alpha)

    @property
    def total_cost(self) -> float:
        return self.total_query_cost + self.total_reorg_cost

    @property
    def num_reorgs(self) -> int:
        return len(self.reorg_indices)

    def cumulative(self) -> np.ndarray:
        """Running total (query + reorg) cost after each query.

        Each reorganization charges ``alpha`` exactly once, at its reorg
        index (duplicate indices accumulate), so ``cumulative()[-1]`` always
        equals :attr:`total_cost` and repeated calls are stable.
        """
        per_query = self.query_costs.astype(np.float64, copy=True)
        if self.reorg_indices:
            np.add.at(per_query,
                      np.asarray(self.reorg_indices, dtype=np.int64),
                      self.alpha)
        return np.cumsum(per_query)

    def summary(self) -> str:
        return (f"{self.name}: total={self.total_cost:.1f} "
                f"(query={self.total_query_cost:.1f}, "
                f"reorg={self.total_reorg_cost:.1f}, "
                f"moves={self.num_reorgs})")


@dataclasses.dataclass
class OreoConfig:
    alpha: float = 80.0
    gamma: float = 1.0               # transition-bias exponent (0 = uniform)
    delta: int = 0                   # background-reorg delay in queries
    seed: int = 0
    stay_on_phase_start: bool = True
    manager: lm.LayoutManagerConfig = dataclasses.field(
        default_factory=lm.LayoutManagerConfig)
