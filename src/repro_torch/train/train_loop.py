"""Train-step builder: microbatch gradient accumulation, remat, optional
error-feedback int8 compression; the counterpart of
``repro.train.train_loop``.

``build_train_step`` returns a ``(state, batch) -> (state, metrics)``
function.  The state is ``{"params": module, "opt": optimizer state}`` (plus
``"ef_residual"`` with compression); the step updates it in place and
returns it, as the reference's launcher donates it to the jitted step.  The
gradients come from :func:`torch.autograd.grad` of ``model.loss_fn``, so
parameters' ``.grad`` fields are never written.  :func:`train_state_specs`
gives the state's logical shardings (the parameters' specs keyed by name,
for the moments too).  On a mesh, microbatches split each device's own
rows of the batch (:func:`_split`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import transformer
from repro_torch.models.factory import ModelBundle

from . import compression, optimizer as opt


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    microbatches: int = 1
    accum_dtype: str = "float32"
    compress_grads: bool = False           # error-feedback int8 (cross-pod)


def init_train_state(model: ModelBundle, generator: torch.Generator,
                     opt_cfg: opt.OptimizerConfig,
                     options: Optional[TrainOptions] = None) -> Dict:
    params = transformer.trainable(model.init_params(generator))
    state = {"params": params, "opt": opt.init_opt_state(params, opt_cfg)}
    if options and options.compress_grads:
        state["ef_residual"] = compression.init_residual(params)
    return state


def train_state_specs(model: ModelBundle,
                      options: Optional[TrainOptions] = None) -> Dict:
    pspecs = model.param_specs()
    specs = {"params": pspecs,
             "opt": {"m": pspecs, "v": pspecs, "step": ()}}
    if options and options.compress_grads:
        specs["ef_residual"] = pspecs
    return specs


def _split(x, n: int) -> list:
    """``n`` microbatches of ``x``'s rows.  A :class:`DTensor` whose rows
    are sharded splits each device's own rows, so no row moves between
    devices; where a microbatch is smaller than the devices sharding the
    rows, the leading ones among them gather first (a microbatch is then
    replicated over them)."""
    b = x.shape[0]
    if b % n:
        raise ValueError(f"a batch of {b} does not split into {n} "
                         f"microbatches")
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return [x[i * (b // n):(i + 1) * (b // n)] for i in range(n)]
    mesh, pl = x.device_mesh, list(x.placements)
    rows = [i for i, p in enumerate(pl) if p == Shard(0)]
    while rows and (b // n) % math.prod(mesh.size(i) for i in rows):
        pl[rows.pop(0)] = Replicate()
    if pl != list(x.placements):
        x = x.redistribute(mesh, pl)
    local = x.to_local()
    step = local.shape[0] // n
    return [DTensor.from_local(local[i * step:(i + 1) * step], mesh, pl,
                               run_check=False,
                               shape=(b // n,) + tuple(x.shape[1:]),
                               stride=x.stride())
            for i in range(n)]


def build_train_step(model: ModelBundle, opt_cfg: opt.OptimizerConfig,
                     options: Optional[TrainOptions] = None) -> Callable:
    options = options or TrainOptions()
    n_micro = options.microbatches

    def value_and_grad(params, batch) -> Tuple[torch.Tensor, Dict]:
        names, leaves = zip(*params.named_parameters())
        loss = model.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # A parameter the loss does not read (the audio family's token
        # embedding) has a zero gradient, as the reference's autodiff gives.
        return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                               for n, p, g in zip(names, leaves, grads)}

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        params = state["params"]
        if n_micro == 1:
            loss, grads = value_and_grad(params, batch)
        else:
            acc_dt = getattr(torch, options.accum_dtype)
            parts = {k: _split(x, n_micro) for k, x in batch.items()}
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=model.device)
            grads = {n: torch.zeros_like(p, dtype=acc_dt)
                     for n, p in params.named_parameters()}
            for i in range(n_micro):
                loss, g = value_and_grad(
                    params, {k: xs[i] for k, xs in parts.items()})
                grads = {n: grads[n] + g[n].to(acc_dt) for n in grads}
                loss_sum = loss_sum + loss
            loss = loss_sum / n_micro
            grads = {n: a / n_micro for n, a in grads.items()}

        if options.compress_grads:
            grads, residual = compression.ef_int8_roundtrip(
                grads, state["ef_residual"])

        params, new_opt, metrics = opt.adamw_update(
            params, grads, state["opt"], opt_cfg)
        new_state = {"params": params, "opt": new_opt}
        if options.compress_grads:
            new_state["ef_residual"] = residual
        metrics = dict(metrics, loss=loss)
        return new_state, metrics

    return train_step
