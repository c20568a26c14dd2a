"""Serving of the port: the LLM-decode substrate (fixed-slot continuous
batching).  The fleet front end (admission, cache, frontend) comes with a
later slice."""
from repro_torch.serve import batching, serve_loop
from repro_torch.serve.batching import Request, SlotBatcher
from repro_torch.serve.serve_loop import (build_serve_fns, greedy_generate,
                                          serve_requests)

__all__ = ["Request", "SlotBatcher", "build_serve_fns", "greedy_generate",
           "serve_requests", "batching", "serve_loop"]
