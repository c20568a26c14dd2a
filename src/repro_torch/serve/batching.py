"""Request batcher: fixed-slot continuous batching for the decode loop.

Requests occupy slots of a (B, S) ring; finished slots are refilled from the
queue between decode steps.  The decode step itself is one call over the
full slot batch (per-slot valid lengths handled by the KV valid-length
mask), whatever the request churn.  Pure Python, line for line the
counterpart of ``repro.serve.batching``.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray                 # (T,)
    max_new_tokens: int = 32
    generated: List[int] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


class SlotBatcher:
    """Assigns requests to fixed batch slots; tracks per-slot progress."""

    def __init__(self, num_slots: int):
        self.num_slots = num_slots
        self.slots: List[Optional[Request]] = [None] * num_slots
        # A deque, not a list: fill_slots pops from the front every decode
        # step, and list.pop(0) is O(queue) per request.
        self.queue: Deque[Request] = collections.deque()
        self.completed: List[Request] = []

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def fill_slots(self) -> List[int]:
        """Move queued requests into free slots; returns newly filled idxs."""
        filled = []
        for i in range(self.num_slots):
            if self.slots[i] is None and self.queue:
                self.slots[i] = self.queue.popleft()
                filled.append(i)
        return filled

    def record_tokens(self, tokens: np.ndarray) -> None:
        """tokens: (num_slots,) next token per slot."""
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            req.generated.append(int(tokens[i]))
            if req.done:
                self.completed.append(req)
                self.slots[i] = None

    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def pending(self) -> int:
        return len(self.queue)
