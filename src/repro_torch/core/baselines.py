"""Methods of comparison (paper §VI-A3 and §VI-C).

Online (no workload knowledge, same candidate stream as OREO):
  * Greedy -- switches to any freshly generated layout that beats the current
    one on the sliding window, ignoring reorganization cost.
  * Regret -- switches only once the *cumulative* query-cost saving of a
    candidate over the current layout exceeds alpha (TASM-style).

Offline (workload knowledge):
  * Static -- one layout optimized for the entire workload, never switches.
  * MTS-Optimal -- fixed precomputed state space (best layout per template) +
    OREO's D-UMTS switching.
  * Offline-Optimal -- sees the whole stream; switches to each template's best
    layout exactly at template boundaries (lower bound for online methods).

Every method runs through the shared :class:`repro_torch.engine.LayoutEngine`
loop as a pluggable policy (:mod:`repro_torch.engine.policies`); the
``run_*`` functions below compose policy + in-memory backend over ``data``,
a float64 tensor on its device.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import layout_manager as lm
from . import layouts, oreo, workload as wl


def _run(policy, data: torch.Tensor, stream: wl.WorkloadStream,
         name: str) -> oreo.RunResult:
    from repro_torch import engine as _engine   # engine builds on core
    return _engine.LayoutEngine(policy, _engine.InMemoryBackend(data)).run(
        stream, name=name)


# ---------------------------------------------------------------------------
# Static
# ---------------------------------------------------------------------------

def run_static(data: torch.Tensor, stream: wl.WorkloadStream,
               generator: lm.GeneratorFn, alpha: float,
               target_partitions: int = 32,
               name: str = "Static") -> oreo.RunResult:
    from repro_torch import engine as _engine
    policy = _engine.StaticPolicy(data, stream, generator, alpha,
                                  target_partitions=target_partitions)
    return _run(policy, data, stream, name)


# ---------------------------------------------------------------------------
# Greedy / Regret share OREO's candidate generation cadence
# ---------------------------------------------------------------------------

def run_greedy(data: torch.Tensor, stream: wl.WorkloadStream,
               generator: lm.GeneratorFn, initial_layout: layouts.Layout,
               alpha: float, mgr_cfg: Optional[lm.LayoutManagerConfig] = None,
               name: str = "Greedy") -> oreo.RunResult:
    from repro_torch import engine as _engine
    policy = _engine.GreedyPolicy(data, initial_layout, generator, alpha,
                                  mgr_cfg=mgr_cfg)
    return _run(policy, data, stream, name)


def run_regret(data: torch.Tensor, stream: wl.WorkloadStream,
               generator: lm.GeneratorFn, initial_layout: layouts.Layout,
               alpha: float, mgr_cfg: Optional[lm.LayoutManagerConfig] = None,
               max_candidates: int = 8,
               name: str = "Regret") -> oreo.RunResult:
    """Switch when cumulative saving vs. the current layout exceeds alpha."""
    from repro_torch import engine as _engine
    policy = _engine.RegretPolicy(data, initial_layout, generator, alpha,
                                  mgr_cfg=mgr_cfg,
                                  max_candidates=max_candidates)
    return _run(policy, data, stream, name)


# ---------------------------------------------------------------------------
# Template-aware oracles (§VI-C)
# ---------------------------------------------------------------------------

def per_template_layouts(data: torch.Tensor, stream: wl.WorkloadStream,
                         generator: lm.GeneratorFn, target_partitions: int,
                         queries_per_template: int = 200
                         ) -> Dict[int, layouts.Layout]:
    """Best layout per query template, built from that template's queries."""
    by_template: Dict[int, List[wl.Query]] = {}
    for q in stream.queries:
        by_template.setdefault(q.template_id, []).append(q)
    out: Dict[int, layouts.Layout] = {}
    for tid, qs in sorted(by_template.items()):
        out[tid] = generator(tid, data, qs[:queries_per_template],
                             target_partitions)
        out[tid].materialize(data)
    return out


def run_mts_optimal(data: torch.Tensor, stream: wl.WorkloadStream,
                    generator: lm.GeneratorFn, alpha: float,
                    target_partitions: int = 32, gamma: float = 1.0,
                    seed: int = 0,
                    name: str = "MTS Optimal") -> oreo.RunResult:
    """Fixed precomputed state space + our MTS switching (no dynamic states)."""
    from repro_torch import engine as _engine
    policy = _engine.MTSOptimalPolicy(data, stream, generator, alpha,
                                      target_partitions=target_partitions,
                                      gamma=gamma, seed=seed)
    return _run(policy, data, stream, name)


def run_offline_optimal(data: torch.Tensor, stream: wl.WorkloadStream,
                        generator: lm.GeneratorFn, alpha: float,
                        target_partitions: int = 32,
                        name: str = "Offline Optimal") -> oreo.RunResult:
    """Knows the whole stream: per-template layout, switch at boundaries."""
    from repro_torch import engine as _engine
    policy = _engine.OfflineOptimalPolicy(data, stream, generator, alpha,
                                          target_partitions=target_partitions)
    return _run(policy, data, stream, name)
