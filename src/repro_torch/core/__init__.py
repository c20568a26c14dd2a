"""OREO core on PyTorch: online data-layout reorganization.

* :class:`~repro_torch.core.mts.DynamicUMTS` -- D-UMTS decision maker
  (Alg. 1-4), on the host.
* :class:`~repro_torch.core.layout_manager.LayoutManager` -- candidate
  generation + ε-admission (Alg. 5).
* :class:`~repro_torch.engine.LayoutEngine` -- the stepwise online loop
  (Fig. 1), in :mod:`repro_torch.engine`
  (:class:`~repro_torch.core.oreo.OreoRunner` remains as a deprecated
  alias).
* Layout generators: Qd-tree, Z-order, default (arrival-order), whose
  sample work, keys and zone maps run on the table's device.
* Baselines: Static / Greedy / Regret / MTS-Optimal / Offline-Optimal, each
  a Policy over the shared engine loop.
"""
from repro_torch.core import baselines, cost_model, layout_manager, layouts
from repro_torch.core import mts, oreo, predictors, qdtree, sampling
from repro_torch.core import workload, zorder
from repro_torch.core.cost_model import CostModel
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
from repro_torch.core.oreo import OreoConfig, OreoRunner, RunResult
from repro_torch.core.qdtree import build_default_layout, build_qdtree_layout
from repro_torch.core.workload import (DRIFT_SCENARIOS, INGEST_SCENARIOS,
                                       Event, FleetStream, IngestBatch,
                                       IngestEvent, IngestStream, Query,
                                       QueryEvent, QueryTemplate,
                                       WorkloadStream, as_event,
                                       generate_workload, interleave_streams,
                                       make_drift_scenario,
                                       make_ingest_scenario, make_templates,
                                       stack_queries)
from repro_torch.core.zorder import build_zorder_layout

__all__ = [
    "CostModel", "DRIFT_SCENARIOS", "DynamicUMTS", "Event", "FleetStream",
    "INGEST_SCENARIOS", "IngestBatch", "IngestEvent", "IngestStream",
    "Layout", "LayoutManager", "LayoutManagerConfig",
    "OreoConfig", "OreoRunner", "PartitionMetadata", "Query", "QueryEvent",
    "QueryTemplate", "RunResult", "WorkloadStream", "as_event",
    "build_default_layout", "build_qdtree_layout", "build_zorder_layout",
    "cost_vector", "eval_cost", "eval_cost_states", "eval_skipped",
    "generate_workload", "interleave_streams",
    "layout_distance", "make_drift_scenario", "make_generator",
    "make_ingest_scenario",
    "make_templates", "metadata_from_assignment", "partitions_scanned",
    "stack_queries", "theorem_iv1_bound", "theorem_iv2_bound",
    "baselines", "cost_model", "layout_manager", "layouts", "mts", "oreo",
    "predictors", "qdtree", "sampling", "workload", "zorder",
]
