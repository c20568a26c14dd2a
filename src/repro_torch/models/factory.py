"""Model factory: one interface over the ported architecture families.

``build_model(cfg, device=None)`` returns a :class:`ModelBundle` whose
functions take the parameters explicitly, as ``repro.models.factory``'s
do, so a serving loop reads the same in both packages.  The bundle runs on
the card unless ``device="cpu"`` is given; without a card the default
raises.  Every family is ported: the dense, MoE, VLM and audio families
through ``transformer``, the SSM family through ``rwkv6`` and the hybrid
through ``hybrid``; ``input_specs`` belongs to the launch slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels._backend import resolve_device
from repro_torch.models import hybrid, losses, rwkv6, transformer


@dataclasses.dataclass
class ModelBundle:
    cfg: ArchConfig
    device: torch.device
    init_params: Callable                  # (generator) -> params
    forward: Callable                      # (params, batch) -> logits
    loss_fn: Callable                      # (params, batch) -> scalar loss
    prefill: Callable                      # (params, batch) -> (logits, cache)
    decode_step: Callable                  # (params, batch, cache) -> (logits, cache)
    cache_spec: Callable                   # (batch, max_len) -> shapes, dtypes


def _module_for(cfg: ArchConfig):
    if cfg.family in transformer.FAMILIES:
        return transformer
    if cfg.family == "ssm":
        return rwkv6
    if cfg.family == "hybrid":
        return hybrid
    raise ValueError(f"unknown family {cfg.family}")


def build_model(cfg: ArchConfig,
                device: Union[None, str, torch.device] = None
                ) -> ModelBundle:
    dev = resolve_device(device)
    mod = _module_for(cfg)

    def init_params(generator: torch.Generator):
        if torch.device(generator.device).type != dev.type:
            raise ValueError(f"init_params: the generator is on "
                             f"{generator.device}, the model on {dev}")
        return mod.init_params(generator, cfg)

    def loss_fn(params, batch):
        # Chunked CE: the (B, T, V) logits tensor is never materialized.
        h = mod.hidden(params, cfg, batch)
        return losses.chunked_lm_loss(h, params.head, batch["targets"])

    return ModelBundle(
        cfg=cfg, device=dev,
        init_params=init_params,
        forward=lambda params, batch: mod.forward(params, cfg, batch),
        loss_fn=loss_fn,
        prefill=lambda params, batch, **kw: mod.prefill(params, cfg, batch,
                                                        **kw),
        decode_step=lambda params, batch, cache: mod.decode_step(
            params, cfg, batch, cache),
        cache_spec=lambda batch, max_len: mod.cache_spec(cfg, batch,
                                                         max_len),
    )
