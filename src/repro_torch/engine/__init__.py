"""Online layout-optimization engine on PyTorch: loop, policies, backend.

    from repro_torch.engine import LayoutEngine, InMemoryBackend, OreoPolicy

    policy = OreoPolicy(data, initial_layout, generator, OreoConfig(alpha=80))
    engine = LayoutEngine(policy, InMemoryBackend(data), delta=policy.config.delta)
    for query in live_traffic:
        step = engine.step(query)          # serve + decide + maybe reorg
    trace = engine.result()

``data`` is the table as a float64 tensor on its device; every scan runs
there (:mod:`repro_torch.engine.compute`).
"""
from repro_torch.engine import compute
from repro_torch.engine.backends import InMemoryBackend, StorageBackend
from repro_torch.engine.core import LayoutEngine, StepResult
from repro_torch.engine.policies import (Decision, GreedyPolicy, OreoPolicy,
                                         Policy, RegretPolicy, StaticPolicy)
from repro_torch.engine.state_matrix import StateMatrix

__all__ = [
    "Decision", "GreedyPolicy", "InMemoryBackend", "LayoutEngine",
    "OreoPolicy", "Policy", "RegretPolicy", "StateMatrix", "StaticPolicy",
    "StepResult", "StorageBackend", "compute",
]
