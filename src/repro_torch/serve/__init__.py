"""Serving of the port: the traffic-facing tier in front of the fleet, and
the LLM-decode substrate.

* :class:`ServeFrontend` — admission-controlled, load-leveled front end
  over any :class:`repro_torch.engine.EventSink` (a ``FleetEngine`` or a
  ``FleetRouter``); sheds reorg work (never serve work) under overload and
  serves through a plane-versioned read-through cache.
* :class:`FrontendConfig` / :class:`AdmissionResult` — its knobs and
  per-submit outcome.
* :class:`TokenBucket` / :class:`CircuitBreaker` — deterministic
  admission primitives (event-counter clocked).
* :class:`VersionedResultCache` / :func:`cache_key` — the serve-cost
  cache keyed on StateMatrix plane versions.
* :class:`Request` / :class:`SlotBatcher`, :func:`build_serve_fns` /
  :func:`greedy_generate` / :func:`serve_requests` — the LLM-decode
  substrate (fixed-slot continuous batching; unrelated to the front end).
"""
from repro_torch.serve import (admission, batching, cache, frontend,
                               serve_loop)
from repro_torch.serve.admission import CircuitBreaker, TokenBucket
from repro_torch.serve.batching import Request, SlotBatcher
from repro_torch.serve.cache import VersionedResultCache, cache_key
from repro_torch.serve.frontend import (AdmissionResult, FrontendConfig,
                                        ServeFrontend)
from repro_torch.serve.serve_loop import (build_serve_fns, greedy_generate,
                                          serve_requests)

__all__ = [
    "AdmissionResult", "CircuitBreaker", "FrontendConfig", "Request",
    "ServeFrontend", "SlotBatcher", "TokenBucket", "VersionedResultCache",
    "build_serve_fns", "cache_key", "greedy_generate", "serve_requests",
    "admission", "batching", "cache", "frontend", "serve_loop",
]
