"""OREO core on PyTorch: online data-layout reorganization.

* :class:`~repro_torch.core.mts.DynamicUMTS` -- D-UMTS decision maker
  (Alg. 1-4), on the host.
* :class:`~repro_torch.core.layout_manager.LayoutManager` -- candidate
  generation + ε-admission (Alg. 5).
* Layout generators: Qd-tree and default (arrival-order), whose sample
  work and zone maps run on the table's device.
"""
from repro_torch.core import layout_manager, layouts, mts, oreo, predictors
from repro_torch.core import qdtree, sampling, workload
from repro_torch.core.layout_manager import (LayoutManager,
                                             LayoutManagerConfig,
                                             make_generator)
from repro_torch.core.layouts import (Layout, PartitionMetadata, cost_vector,
                                      eval_cost, eval_cost_states,
                                      eval_skipped, layout_distance,
                                      metadata_from_assignment,
                                      partitions_scanned)
from repro_torch.core.mts import (DynamicUMTS, theorem_iv1_bound,
                                  theorem_iv2_bound)
from repro_torch.core.oreo import OreoConfig, RunResult
from repro_torch.core.qdtree import build_default_layout, build_qdtree_layout
from repro_torch.core.workload import (DRIFT_SCENARIOS, Event, FleetStream,
                                       IngestEvent, Query, QueryEvent,
                                       QueryTemplate, WorkloadStream,
                                       as_event, generate_workload,
                                       interleave_streams,
                                       make_drift_scenario, make_templates,
                                       stack_queries)

__all__ = [
    "DRIFT_SCENARIOS", "DynamicUMTS", "Event", "FleetStream", "IngestEvent",
    "Layout", "LayoutManager", "LayoutManagerConfig",
    "OreoConfig", "PartitionMetadata", "Query", "QueryEvent",
    "QueryTemplate", "RunResult", "WorkloadStream", "as_event",
    "build_default_layout", "build_qdtree_layout",
    "cost_vector", "eval_cost", "eval_cost_states", "eval_skipped",
    "generate_workload", "interleave_streams", "layout_distance",
    "make_drift_scenario", "make_generator",
    "make_templates", "metadata_from_assignment", "partitions_scanned",
    "stack_queries", "theorem_iv1_bound", "theorem_iv2_bound",
    "layout_manager", "layouts", "mts", "oreo", "predictors", "qdtree",
    "sampling", "workload",
]
