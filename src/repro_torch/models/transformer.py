"""Decoder-only transformer: the dense family, token input.

The counterpart of ``repro.models.transformer`` for ``family == "dense"``:
GQA attention with optional qk-norm, RoPE full/half/none, a SwiGLU /
GeGLU / squared-ReLU / GELU MLP, and a KV-cache prefill / decode.  The
parameters are a :class:`Transformer` module whose layers are a
:class:`torch.nn.ModuleList` (the reference stacks them on axis 0 and
scans; here a Python loop walks them).  The cache is
``{"k", "v": (L, B, S, Hkv, dh), "index": int}``; a decode step writes the
new k/v into it in place.  MoE, VLM (prefix-LM) and audio inputs raise
``NotImplementedError`` naming the slice that ports them.

Parameters are created with ``requires_grad=False``, so serving builds no
graph; :func:`trainable` turns grad on for training.  :func:`hidden` runs
each block under :func:`torch.utils.checkpoint.checkpoint` when grad is
enabled (the reference's default full remat per layer).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LATER_FAMILIES
from repro_torch.models import layers as L


def check_family(cfg) -> None:
    if cfg.family != "dense" or cfg.moe is not None or cfg.embed_input:
        family = "moe" if cfg.moe is not None else cfg.family
        raise NotImplementedError(
            f"{cfg.name}: the {family} family is not ported yet; it comes "
            f"with {LATER_FAMILIES.get(family, 'a later slice')}")


class Block(nn.Module):
    def __init__(self, attn: L.Attention, mlp: L.MLP, ln1: torch.Tensor,
                 ln2: torch.Tensor):
        super().__init__()
        self.attn, self.mlp = attn, mlp
        self.ln1 = nn.Parameter(ln1, requires_grad=False)
        self.ln2 = nn.Parameter(ln2, requires_grad=False)


class Transformer(nn.Module):
    """``embed`` (V, d), ``layers``, ``final_norm`` (d,), ``head`` (d, V)."""

    def __init__(self, embed: torch.Tensor, layers, final_norm: torch.Tensor,
                 head: torch.Tensor):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.layers = nn.ModuleList(layers)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.head = nn.Parameter(head, requires_grad=False)


def trainable(params: nn.Module) -> nn.Module:
    """Turn grad on for every parameter of ``params``; returns it."""
    for p in params.parameters():
        p.requires_grad_(True)
    return params


def init_layer(generator: torch.Generator, cfg) -> Block:
    dev = generator.device
    return Block(L.init_attention(generator, cfg), L.init_mlp(generator, cfg),
                 L.init_rms_norm(cfg.d_model, dev),
                 L.init_rms_norm(cfg.d_model, dev))


def init_params(generator: torch.Generator, cfg) -> Transformer:
    """Random weights drawn from ``generator`` on its device: embed
    ``normal * 0.02``, dense ``normal * d_in ** -0.5``, both bf16; norms
    float32 zeros."""
    check_family(cfg)
    embed = (torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                         device=generator.device) * 0.02).to(L.DEFAULT_DTYPE)
    layers = [init_layer(generator, cfg) for _ in range(cfg.n_layers)]
    return Transformer(embed, layers,
                       L.init_rms_norm(cfg.d_model, generator.device),
                       L.dense_init(generator, cfg.d_model, cfg.vocab))


def _layer_apply(block: Block, x: torch.Tensor, cfg,
                 positions: torch.Tensor, cache: Optional[Dict] = None
                 ) -> Tuple[torch.Tensor, Dict]:
    h, new_cache = L.attention_apply(block.attn, L.rms_norm(x, block.ln1),
                                     cfg, positions, causal=True,
                                     cache=cache)
    x = x + h
    x = x + L.mlp_apply(block.mlp, L.rms_norm(x, block.ln2), cfg)
    return x, new_cache


def _embed_input(params: Transformer, cfg, batch: Dict) -> torch.Tensor:
    check_family(cfg)
    tokens = torch.as_tensor(batch["tokens"], device=params.embed.device)
    return params.embed[tokens.long()]


def _block_out(block: Block, x: torch.Tensor, cfg,
               positions: torch.Tensor) -> torch.Tensor:
    return _layer_apply(block, x, cfg, positions)[0]


def hidden(params: Transformer, cfg, batch: Dict,
           remat: bool = True) -> torch.Tensor:
    """Full-sequence forward up to the final norm; returns (B, T, d).  With
    ``remat`` and grad enabled each block's activations are recomputed in
    the backward, keeping only the blocks' inputs."""
    x = _embed_input(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    remat = remat and torch.is_grad_enabled()
    for block in params.layers:
        if remat:
            x = checkpoint(_block_out, block, x, cfg, positions,
                           use_reentrant=False)
        else:
            x = _block_out(block, x, cfg, positions)
    return L.rms_norm(x, params.final_norm)


def forward(params: Transformer, cfg, batch: Dict,
            remat: bool = True) -> torch.Tensor:
    """Full-sequence forward; returns logits (B, T, V)."""
    return hidden(params, cfg, batch, remat) @ params.head


def prefill(params: Transformer, cfg, batch: Dict,
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """Forward returning the last position's logits (B, 1, V) and a KV
    cache padded with zeros to ``max_len`` positions."""
    x = _embed_input(params, cfg, batch)
    B, T = x.shape[0], x.shape[1]
    S = max(max_len or T, T)
    positions = torch.arange(T, device=x.device)
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    ks = torch.zeros(shape, dtype=x.dtype, device=x.device)
    vs = torch.zeros_like(ks)
    for i, block in enumerate(params.layers):
        x, kv = _layer_apply(block, x, cfg, positions)
        ks[i, :, :T] = kv["k"]
        vs[i, :, :T] = kv["v"]
    cache = {"k": ks, "v": vs, "index": T}
    x = L.rms_norm(x, params.final_norm)
    return x[:, -1:] @ params.head, cache


def decode_step(params: Transformer, cfg, batch: Dict, cache: Dict
                ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode against the stacked-layer KV cache, which is
    updated in place; returns logits (B, 1, V) and the cache with
    ``index + 1``."""
    x = _embed_input(params, cfg, batch)
    idx = int(cache["index"])
    positions = torch.full((x.shape[0], 1), idx, dtype=torch.int64,
                           device=x.device)
    for i, block in enumerate(params.layers):
        x, _ = _layer_apply(block, x, cfg, positions,
                            cache={"k": cache["k"][i], "v": cache["v"][i],
                                   "index": idx})
    x = L.rms_norm(x, params.final_norm)
    new_cache = {"k": cache["k"], "v": cache["v"], "index": idx + 1}
    return x @ params.head, new_cache


def cache_spec(cfg, batch: int, max_len: int) -> Dict:
    """Shapes and dtypes of the decode cache."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": (shape, L.DEFAULT_DTYPE), "v": (shape, L.DEFAULT_DTYPE),
            "index": ((), torch.int64)}
