"""AdamW + warmup-cosine schedule, the counterpart of
``repro.train.optimizer``.

Optimizer moment dtype is configurable (``state_dtype``): float32 is the
default; bfloat16 halves the optimizer's memory.  The state is ``{"m": {name:
tensor}, "v": {name: tensor}, "step": int32 0-d tensor}`` keyed by the
parameters' names.  :func:`adamw_update` writes the new parameters and
moments into the existing tensors (the reference's launcher donates its
state to the step, so nothing else reads the old values), which keeps a
full-width model's state resident once.

Weight decay goes to the reference's matrices: its leaves of two or more
dimensions, where every per-layer tensor counts with the layers' stacked
axis (:func:`decays`), so the per-layer norm scales decay and the final
norm does not.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Tuple

import torch
from torch import nn

from repro_torch import convert


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"          # "float32" | "bfloat16"


def named(tree) -> Dict[str, torch.Tensor]:
    """A module's parameters, or a mapping's tensors, by name."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    if isinstance(tree, Mapping):
        return dict(tree)
    raise TypeError(f"expected a module or a mapping, got {type(tree)}")


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether the reference decays the parameter ``name``: its leaf, with
    the layers stacked on axis 0, has two or more dimensions."""
    stacked = convert.ref_path(name)[1] is not None
    return p.dim() + stacked >= 2


def state_dtype(cfg: OptimizerConfig) -> torch.dtype:
    return getattr(torch, cfg.state_dtype)


def schedule(step, cfg: OptimizerConfig) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr, in float32."""
    step = torch.as_tensor(step).float()
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    progress = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * (
        1.0 + torch.cos(math.pi * progress))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params, cfg: OptimizerConfig) -> Dict:
    dt = state_dtype(cfg)
    leaves = named(params)
    device = next(iter(leaves.values())).device
    # zeros_like: a sharded parameter's moments are sharded as it is.
    return {"m": {n: torch.zeros_like(p, dtype=dt, requires_grad=False)
                  for n, p in leaves.items()},
            "v": {n: torch.zeros_like(p, dtype=dt, requires_grad=False)
                  for n, p in leaves.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in named(tree).values()))


@torch.no_grad()
def adamw_update(params, grads, opt_state: Dict, cfg: OptimizerConfig
                 ) -> Tuple[nn.Module, Dict, Dict]:
    """Returns (params, new_opt_state, metrics); ``grads`` maps each
    parameter's name to its gradient.  Parameters and moments are updated
    in place, each from the float32 update cast back to its dtype."""
    step = opt_state["step"] + 1
    lr = schedule(step, cfg)
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                            1.0)
    dt = state_dtype(cfg)
    step_f = step.float()
    bc1 = 1.0 - torch.pow(cfg.b1, step_f)
    bc2 = 1.0 - torch.pow(cfg.b2, step_f)
    for name, p in named(params).items():
        g = grads[name].float() * scale
        m, v = opt_state["m"][name], opt_state["v"][name]
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if decays(name, p):                              # matrices only
            delta = delta + cfg.weight_decay * p.float()
        new_p = p.float() - lr * delta
        p.copy_(new_p.to(p.dtype))
        m.copy_(m32.to(dt))
        v.copy_(v32.to(dt))
    opt_state["step"] = step
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
