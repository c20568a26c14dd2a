"""The predictive decision plane: forecast → grow → pre-position.

Dataflow (each layer optional and independently testable)::

    per-tenant query stream
        │ observe
        ▼
    EwmaMixtureForecaster ──────────► Forecast (key, queries, dwell)
    (period detector + EWMA trend)        │                │
                                          ▼                ▼
                              QdTreeGrower.propose   ForecastPolicy
                              (online state growth)  (α-safe pre-position)
                                          │                │
                                          ▼                ▼
                          StateMatrix register/      DynamicUMTS.force_move
                          deregister events          + α-charged Δ-delayed
                          (the FleetMatrix plane     reorg through the
                          on the device, serve       engine/governor path
                          caches stay exact)

Everything here is deterministic and picklable; the reactive OREO
envelope is the safety net (see :class:`ForecastPolicy`'s clamp).  The
forecasters are host logic; predicted costs and the grower's vetting run
the pruning kernel's scans (:func:`repro_torch.core.layouts.eval_cost`),
the grower builds its qd-trees over the table on its device, and grown
states enter and leave the planes that ``decision_fused``, ``fleet_scan``
and ``move_score`` score.
"""
from .grower import GROWN_ID_BASE, QdTreeGrower, grown_ids
from .policy import ForecastConfig, ForecastPolicy
from .predictors import (AdversarialForecaster, EwmaMixtureForecaster,
                         Forecast, PeriodDetector, template_key)

__all__ = [
    "AdversarialForecaster", "EwmaMixtureForecaster", "Forecast",
    "ForecastConfig", "ForecastPolicy", "GROWN_ID_BASE", "PeriodDetector",
    "QdTreeGrower", "grown_ids", "template_key",
]
