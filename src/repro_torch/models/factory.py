"""Model factory: one interface over the ported architecture families.

``build_model(cfg, device=None)`` returns a :class:`ModelBundle` whose
functions take the parameters explicitly, as ``repro.models.factory``'s
do, so a serving loop reads the same in both packages.  The bundle runs on
the card unless ``device="cpu"`` is given; without a card the default
raises.  Every family is ported: the dense, MoE, VLM and audio families
through ``transformer``, the SSM family through ``rwkv6`` and the hybrid
through ``hybrid``.  ``param_specs`` and ``cache_specs`` give the logical
shardings of the parameters (by name) and of the decode cache, and
:func:`input_specs` the shapes and shardings of a dry-run cell's inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.kernels._backend import resolve_device
from repro_torch.models import hybrid, losses, rwkv6, transformer
from repro_torch.models import layers as L


@dataclasses.dataclass
class ModelBundle:
    cfg: ArchConfig
    device: torch.device
    init_params: Callable                  # (generator) -> params
    param_specs: Callable                  # () -> {name: logical spec}
    forward: Callable                      # (params, batch) -> logits
    loss_fn: Callable                      # (params, batch) -> scalar loss
    prefill: Callable                      # (params, batch) -> (logits, cache)
    decode_step: Callable                  # (params, batch, cache) -> (logits, cache)
    cache_spec: Callable                   # (batch, max_len) -> shapes, dtypes
    cache_specs: Callable                  # (seq_axes) -> logical specs


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
        param_specs=lambda: mod.param_specs(cfg),
        forward=lambda params, batch: mod.forward(params, cfg, batch),
        loss_fn=loss_fn,
        prefill=lambda params, batch, **kw: mod.prefill(params, cfg, batch,
                                                        **kw),
        decode_step=lambda params, batch, cache: mod.decode_step(
            params, cfg, batch, cache),
        cache_spec=lambda batch, max_len: mod.cache_spec(cfg, batch,
                                                         max_len),
        cache_specs=lambda seq_axes=("model",): mod.cache_specs(cfg,
                                                                seq_axes),
    )


def input_specs(cfg: ArchConfig, shape: ShapeConfig
                ) -> Tuple[Dict, Dict]:
    """(batch shapes, batch logical specs) for a dry-run cell; each shape
    a ``(shape, dtype)`` pair, as :func:`transformer.cache_spec` gives
    them.

    * train/prefill: full-sequence inputs (+ targets for train).
    * decode: one new token (the cache comes from ``cache_spec``).
    * vlm: stub patch embeddings for the prefix + text tokens.
    * audio: stub frame embeddings for the full sequence.
    """
    B, T = shape.global_batch, shape.seq_len
    i32 = torch.int32
    bf16 = L.DEFAULT_DTYPE
    if shape.kind == "decode":
        if cfg.family == "audio":
            return ({"embeds": ((B, 1, cfg.d_model), bf16)},
                    {"embeds": ("batch", None, None)})
        return {"tokens": ((B, 1), i32)}, {"tokens": ("batch", None)}
    shapes: Dict = {}
    specs: Dict = {}
    if cfg.family == "vlm":
        prefix = cfg.prefix_len
        shapes["embeds"] = ((B, prefix, cfg.d_model), bf16)
        shapes["tokens"] = ((B, T - prefix), i32)
        specs["embeds"] = ("batch", None, None)
        specs["tokens"] = ("batch", None)
    elif cfg.family == "audio":
        shapes["embeds"] = ((B, T, cfg.d_model), bf16)
        specs["embeds"] = ("batch", None, None)
    else:
        shapes["tokens"] = ((B, T), i32)
        specs["tokens"] = ("batch", None)
    if shape.kind == "train":
        shapes["targets"] = ((B, T), i32)
        specs["targets"] = ("batch", None)
    return shapes, specs
