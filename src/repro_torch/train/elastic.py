"""Fault tolerance for the training loop; the counterpart of
``repro.train.elastic``.

* ``FaultTolerantTrainer`` -- checkpoint/restart driver: periodic atomic
  checkpoints, automatic restore-and-replay on step failure, deterministic
  per-step data (batches keyed by step index -> bit-exact resume).  It
  catches ``RuntimeError`` (which a failed kernel launch also raises),
  ``ValueError`` and ``FloatingPointError``; ``restarts`` counts them, so a
  caller that injects faults can check that no other failure was retried.
* ``Prefetcher`` -- the next batch is materialized while the current step
  runs (double buffering).

* ``remesh`` -- elastic rescale: every :class:`DTensor` of a state
  redistributed onto new placements (possibly on a new mesh).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional

from . import checkpoint


class Prefetcher:
    """Background-thread batch prefetch (double buffering)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.it = it
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.done = object()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            for item in self.it:
                self.q.put(item)
        finally:
            self.q.put(self.done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is self.done:
            raise StopIteration
        return item


class FaultTolerantTrainer:
    """Runs ``train_step`` with checkpoint/restart semantics.

    ``batch_fn(step) -> batch`` must be deterministic in ``step`` so that
    recovery replays the exact same data order (bit-exact resume).
    ``fault_hook(step)`` lets tests inject failures at chosen steps.
    """

    def __init__(self, train_step: Callable, state: Any,
                 batch_fn: Callable[[int], Dict],
                 ckpt_dir: str, ckpt_every: int = 10,
                 max_restarts: int = 3,
                 fault_hook: Optional[Callable[[int], None]] = None):
        self.train_step = train_step
        self.state = state
        self.batch_fn = batch_fn
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.fault_hook = fault_hook
        self.metrics_log = []
        self.restarts = 0

    def _restore(self) -> int:
        step = checkpoint.latest_step(self.ckpt_dir)
        if step is None:
            return 0
        self.state = checkpoint.restore(self.ckpt_dir, step, self.state)
        return step

    def run(self, num_steps: int, start_step: int = 0) -> Any:
        step = start_step
        while step < num_steps:
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                batch = self.batch_fn(step)
                self.state, metrics = self.train_step(self.state, batch)
                self.metrics_log.append(
                    {k: float(v) for k, v in metrics.items()} | {"step": step})
                step += 1
                if step % self.ckpt_every == 0:
                    checkpoint.save(self.state, self.ckpt_dir, step)
            except (RuntimeError, ValueError, FloatingPointError) as e:
                # Node failure / NaN blow-up: restore + replay.
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise RuntimeError(
                        f"exceeded {self.max_restarts} restarts") from e
                step = self._restore()
        checkpoint.save(self.state, self.ckpt_dir, step)
        return self.state


def remesh(state: Any, layouts: Any) -> Any:
    """Elastic rescale: the state with every tensor moved onto its layout.

    ``layouts`` mirrors ``state``'s dicts, with a module's parameters
    keyed by name (as :func:`~repro_torch.train.train_loop.train_state_specs`
    keys them); each leaf is a ``(mesh, placements)`` pair.  A
    :class:`DTensor` on the same mesh is redistributed, one on another mesh
    gathered and distributed anew, a plain tensor distributed; a module's
    parameters are replaced in place (their ``requires_grad`` kept) and
    the module is returned.  Entries without a layout stay as they are.
    """
    from torch import nn
    if isinstance(state, nn.Module):
        for name, p in list(state.named_parameters()):
            if name not in layouts:
                continue
            owner, _, attr = name.rpartition(".")
            module = state.get_submodule(owner) if owner else state
            setattr(module, attr, nn.Parameter(
                _moved(p.detach(), *layouts[name]),
                requires_grad=p.requires_grad))
        return state
    if isinstance(state, dict):
        return {k: remesh(v, layouts[k]) if k in layouts else v
                for k, v in state.items()}
    return _moved(state, *layouts)


def _moved(x, mesh, placements):
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(x, DTensor):
        if x.device_mesh == mesh:
            return x.redistribute(mesh, placements)
        x = x.full_tensor()
    if not isinstance(x, torch.Tensor):
        return x
    return distribute_tensor(x, mesh, placements)
