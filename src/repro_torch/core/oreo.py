"""OREO run configuration, result traces, and the deprecated batch runner.

The online loop of Figure 1 — including the paper's Δ-delay semantics for
background reorganization (§VI-D5) — lives in :mod:`repro_torch.engine`
(:class:`~repro_torch.engine.LayoutEngine` +
:class:`~repro_torch.engine.OreoPolicy`).  This module keeps
:class:`OreoConfig` and :class:`RunResult`, plus :class:`OreoRunner` as a
deprecated batch alias over the engine.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional

import numpy as np
import torch

from . import layout_manager as lm
from . import layouts, mts, workload as wl


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


class OreoRunner:
    """Deprecated batch alias for the stepwise engine.

    The online loop lives in :mod:`repro_torch.engine`; this shim composes
    ``LayoutEngine(OreoPolicy(...), InMemoryBackend(data))`` and gives the
    engine's trace.  Prefer::

        from repro_torch.engine import InMemoryBackend, LayoutEngine, OreoPolicy

        policy = OreoPolicy(data, initial_layout, generator, config)
        engine = LayoutEngine(policy, InMemoryBackend(data),
                              delta=config.delta)
        result = engine.run(stream)
    """

    def __init__(self, data: torch.Tensor, initial_layout: layouts.Layout,
                 generator: lm.GeneratorFn,
                 config: Optional[OreoConfig] = None):
        warnings.warn(
            "OreoRunner is deprecated; use repro_torch.engine.LayoutEngine "
            "with OreoPolicy + a StorageBackend instead.",
            DeprecationWarning, stacklevel=2)
        from repro_torch import engine as _engine   # engine builds on core
        self.config = config or OreoConfig()
        self.data = data
        self.policy = _engine.OreoPolicy(data, initial_layout, generator,
                                         self.config)
        self.backend = _engine.InMemoryBackend(data)
        self.engine = _engine.LayoutEngine(self.policy, self.backend,
                                           delta=self.config.delta)

    @property
    def manager(self) -> lm.LayoutManager:
        return self.policy.manager

    @property
    def dumts(self) -> mts.DynamicUMTS:
        return self.policy.dumts

    def run(self, stream: wl.WorkloadStream, name: str = "OREO") -> RunResult:
        return self.engine.run(stream, name=name)
