"""Zamba2-style hybrid (arXiv:2411.15242): a Mamba-2 backbone and one
*shared* attention block applied every ``attn_every`` layers (the same
weights each time); the counterpart of ``repro.models.hybrid``.

Forward structure (G = n_layers / attn_every groups)::

    for g in range(G):
        x = shared_attn_block(x)          # transformer._layer_apply
        for i in range(attn_every):
            x = mamba2_layer(x)

The shared block is a :class:`~repro_torch.models.transformer.Block`, so
its prefill and training attention is the flash kernel's
(``layers.attention_apply``).  It keeps a KV cache per application: the
cache is ``{"k", "v": (G, B, S, Hkv, dh), "mamba": {"conv": (L, B, cw-1,
ch), "h": (L, B, H, dh, ds)}, "index": int}``, updated in place by
:func:`decode_step`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models import mamba2, sharding, transformer


class Hybrid(nn.Module):
    """``embed`` (V, d), ``mamba`` (:class:`~repro_torch.models.mamba2.Layer`
    s), ``shared_attn`` (a transformer block), ``final_norm`` (d,),
    ``head`` (d, V)."""

    def __init__(self, embed: torch.Tensor, mamba, shared_attn,
                 final_norm: torch.Tensor, head: torch.Tensor):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.mamba = nn.ModuleList(mamba)
        self.shared_attn = shared_attn
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.head = nn.Parameter(head, requires_grad=False)


def n_groups(cfg) -> int:
    if cfg.n_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split "
                         f"into groups of {cfg.attn_every}")
    return cfg.n_layers // cfg.attn_every


def param_specs(cfg) -> Dict[str, tuple]:
    """Every parameter's logical spec, keyed by its name in
    ``named_parameters()``."""
    shared = {f"shared_attn.{k}": v
              for k, v in transformer.layer_specs(cfg).items()}
    return {"embed": (None, "model"),
            **transformer.stacked_specs("mamba", cfg.n_layers,
                                        mamba2.layer_specs(cfg)),
            **shared, "final_norm": (None,), "head": ("fsdp", "model")}


def init_params(generator: torch.Generator, cfg) -> Hybrid:
    embed = (torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                         device=generator.device) * 0.02).to(L.DEFAULT_DTYPE)
    mamba = [mamba2.init_layer(generator, cfg) for _ in range(cfg.n_layers)]
    return Hybrid(embed, mamba, transformer.init_layer(generator, cfg),
                  L.init_rms_norm(cfg.d_model, generator.device),
                  L.dense_init(generator, cfg.d_model, cfg.vocab))


def _group(params: Hybrid, cfg, g: int) -> nn.ModuleList:
    per = cfg.attn_every
    return params.mamba[g * per:(g + 1) * per]


def _group_out(shared: transformer.Block, layers: nn.ModuleList,
               x: torch.Tensor, cfg, positions: torch.Tensor
               ) -> torch.Tensor:
    x, _ = transformer._layer_apply(shared, x, cfg, positions, prefix_len=0)
    for layer in layers:
        x, _ = mamba2.layer_apply(layer, x, cfg)
    return x


def hidden(params: Hybrid, cfg, batch: Dict,
           remat: bool = True) -> torch.Tensor:
    """Full-sequence forward up to the final norm; with ``remat`` and grad
    enabled each group is recomputed in the backward."""
    x = _embed(params, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    remat = remat and torch.is_grad_enabled()
    for g in range(n_groups(cfg)):
        args = (params.shared_attn, _group(params, cfg, g), x, cfg,
                positions)
        x = L.remat(_group_out, *args) if remat else _group_out(*args)
    return L.rms_norm(x, params.final_norm)


def _embed(params: Hybrid, batch: Dict) -> torch.Tensor:
    x = transformer._gather_embed(params, batch["tokens"])
    return sharding.constrain(x, "batch", None, None)


def forward(params: Hybrid, cfg, batch: Dict,
            remat: bool = True) -> torch.Tensor:
    return transformer._logits(hidden(params, cfg, batch, remat), params)


def prefill(params: Hybrid, cfg, batch: Dict,
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """The last position's logits (B, 1, V), each shared-block
    application's k/v padded with zeros to ``max_len`` positions, and every
    Mamba-2 layer's state."""
    x = _embed(params, batch)
    B, T = x.shape[0], x.shape[1]
    S = max(max_len or T, T)
    positions = torch.arange(T, device=x.device)
    G = n_groups(cfg)
    ks = vs = None
    states = []
    for g in range(G):
        x, kv = transformer._layer_apply(params.shared_attn, x, cfg,
                                         positions, prefix_len=0)
        if ks is None:
            ks = sharding.zeros((G, B, S, cfg.n_kv_heads, cfg.head_dim),
                                (None, "batch", None, None, None),
                                kv["k"].dtype, x.device)
            vs = torch.zeros_like(ks)
        ks[g, :, :T] = kv["k"]
        vs[g, :, :T] = kv["v"]
        for layer in _group(params, cfg, g):
            x, st = mamba2.layer_apply(layer, x, cfg)
            states.append(st)
    mstates = {n: torch.stack([st[n] for st in states]) for n in ("conv",
                                                                   "h")}
    cache = {"k": ks, "v": vs, "mamba": mstates, "index": T}
    x = L.rms_norm(x, params.final_norm)
    return transformer._logits(x[:, -1:], params), cache


def decode_step(params: Hybrid, cfg, batch: Dict, cache: Dict
                ) -> Tuple[torch.Tensor, Dict]:
    """One token: the shared block against its application's KV cache,
    the Mamba-2 layers from their states; every part of the cache is
    updated in place.  Returns logits (B, 1, V) and the cache with
    ``index + 1``."""
    x = _embed(params, batch)
    idx = int(cache["index"])
    positions = torch.full((x.shape[0], 1), idx, dtype=torch.int64,
                           device=x.device)
    mstates = cache["mamba"]
    for g in range(n_groups(cfg)):
        x, _ = transformer._layer_apply(
            params.shared_attn, x, cfg, positions, prefix_len=0,
            cache={"k": cache["k"][g], "v": cache["v"][g], "index": idx})
        for j, layer in enumerate(_group(params, cfg, g)):
            i = g * cfg.attn_every + j
            x, st = mamba2.layer_apply(
                layer, x, cfg, state={n: mstates[n][i] for n in mstates})
            for n in mstates:
                mstates[n][i] = st[n]
    x = L.rms_norm(x, params.final_norm)
    return transformer._logits(x, params), {
        "k": cache["k"], "v": cache["v"], "mamba": mstates,
        "index": idx + 1}


def cache_spec(cfg, batch: int, max_len: int) -> Dict:
    """Shapes and dtypes of the decode cache."""
    kv = ((n_groups(cfg), batch, max_len, cfg.n_kv_heads, cfg.head_dim),
          L.DEFAULT_DTYPE)
    mamba = {n: ((cfg.n_layers,) + shape, dtype)
             for n, (shape, dtype) in mamba2.state_spec(cfg, batch).items()}
    return {"k": kv, "v": kv, "mamba": mamba, "index": ((), torch.int64)}


def cache_specs(cfg, seq_axes=("model",)) -> Dict:
    """Logical specs of :func:`cache_spec`'s tensors: the KV caches'
    sequence on ``seq_axes``, each Mamba-2 state stacked on the layers'
    axis."""
    kv = transformer.kv_cache_spec(seq_axes)
    return {"k": kv, "v": kv,
            "mamba": {n: (None,) + s
                      for n, s in mamba2.state_specs(cfg).items()},
            "index": ()}
