"""Decoder-only transformer covering the dense / MoE / VLM / audio
families.

The counterpart of ``repro.models.transformer``: GQA attention with
optional qk-norm, RoPE full/half/none, a SwiGLU / GeGLU / squared-ReLU /
GELU MLP or a top-k MoE, and three input streams: token embeddings, the
audio stub frontend's frame embeddings (``batch["embeds"]`` (B, T, d)),
and the VLM's patch embeddings (B, prefix_len, d) followed by text tokens,
the prefix attended bidirectionally (prefix-LM).  The parameters are a
:class:`Transformer` module whose layers are a
:class:`torch.nn.ModuleList` (the reference stacks them on axis 0 and
scans; here a Python loop walks them).  The cache is
``{"k", "v": (L, B, S, Hkv, dh), "index": int}``; a decode step writes the
new k/v into it in place.  The SSM and hybrid families have modules of
their own (``rwkv6``, ``hybrid``); the hybrid's shared attention block is
this module's :class:`Block`.

Parameters are created with ``requires_grad=False``, so serving builds no
graph; :func:`trainable` turns grad on for training.  :func:`hidden` runs
each block under :func:`torch.utils.checkpoint.checkpoint` when grad is
enabled, with the remat policy of :func:`layers.set_remat_policy` (the
reference's default is full remat per layer).

:func:`param_specs` gives every parameter's logical sharding keyed by its
name in ``named_parameters()`` (a layer's spec is the reference's stacked
spec without its leading None), :func:`cache_specs` the decode cache's;
the reference's sharding constraints stand at its sites, no-ops without a
mesh.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models import sharding


FAMILIES = ("dense", "moe", "vlm", "audio")


def check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: the {cfg.family} family is not a "
                         f"transformer (those are {', '.join(FAMILIES)})")


class Block(nn.Module):
    """``attn``, ``ln1``, ``ln2`` and the feed-forward part: ``mlp`` (an
    :class:`~repro_torch.models.layers.MLP`) or ``moe`` (a
    :class:`~repro_torch.models.layers.MoE`); the other is None."""

    def __init__(self, attn: L.Attention, ffn, ln1: torch.Tensor,
                 ln2: torch.Tensor):
        super().__init__()
        self.attn = attn
        self.mlp = self.moe = None
        if isinstance(ffn, L.MoE):
            self.moe = ffn
        else:
            self.mlp = ffn
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


def layer_specs(cfg) -> Dict[str, tuple]:
    """Each :class:`Block` parameter's logical spec, keyed by its name in
    the block."""
    specs = {f"attn.{k}": v for k, v in L.attention_specs(cfg).items()}
    specs.update({"ln1": (None,), "ln2": (None,)})
    ffn, ffn_specs = (("moe", L.moe_specs(cfg)) if cfg.moe is not None
                      else ("mlp", L.mlp_specs(cfg)))
    specs.update({f"{ffn}.{k}": v for k, v in ffn_specs.items()})
    return specs


def stacked_specs(prefix: str, n: int, specs: Dict[str, tuple]
                  ) -> Dict[str, tuple]:
    """``specs`` of each of ``n`` stacked modules, named
    ``prefix.<i>.<name>``."""
    return {f"{prefix}.{i}.{k}": v for i in range(n)
            for k, v in specs.items()}


def param_specs(cfg) -> Dict[str, tuple]:
    """Every parameter's logical spec, keyed by its name in
    ``named_parameters()``."""
    return {"embed": (None, "model"),
            **stacked_specs("layers", cfg.n_layers, layer_specs(cfg)),
            "final_norm": (None,), "head": ("fsdp", "model")}


def kv_cache_spec(seq_axes=("model",)) -> tuple:
    """A stacked (L, B, S, Hkv, dh) cache's logical spec: the sequence on
    ``seq_axes``."""
    return (None, "batch", seq_axes if len(seq_axes) > 1 else seq_axes[0],
            None, None)


def trainable(params: nn.Module) -> nn.Module:
    """Turn grad on for every parameter of ``params``; returns it."""
    for p in params.parameters():
        p.requires_grad_(True)
    return params


def init_layer(generator: torch.Generator, cfg) -> Block:
    dev = generator.device
    attn = L.init_attention(generator, cfg)
    ffn = (L.init_moe(generator, cfg) if cfg.moe is not None
           else L.init_mlp(generator, cfg))
    return Block(attn, ffn, L.init_rms_norm(cfg.d_model, dev),
                 L.init_rms_norm(cfg.d_model, dev))


def init_params(generator: torch.Generator, cfg) -> Transformer:
    """Random weights drawn from ``generator`` on its device: embed
    ``normal * 0.02``, dense ``normal * d_in ** -0.5``, experts ``normal *
    d_model ** -0.5``, all bf16 but the float32 router; norms float32
    zeros."""
    check_family(cfg)
    embed = (torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                         device=generator.device) * 0.02).to(L.DEFAULT_DTYPE)
    layers = [init_layer(generator, cfg) for _ in range(cfg.n_layers)]
    return Transformer(embed, layers,
                       L.init_rms_norm(cfg.d_model, generator.device),
                       L.dense_init(generator, cfg.d_model, cfg.vocab))


def _layer_apply(block: Block, x: torch.Tensor, cfg,
                 positions: torch.Tensor, prefix_len: int = 0,
                 cache: Optional[Dict] = None
                 ) -> Tuple[torch.Tensor, Dict]:
    h, new_cache = L.attention_apply(block.attn, L.rms_norm(x, block.ln1),
                                     cfg, positions, causal=True,
                                     prefix_len=prefix_len, cache=cache)
    x = x + h
    h2 = L.rms_norm(x, block.ln2)
    if cfg.moe is not None:
        x = x + L.moe_apply(block.moe, h2, cfg)
    else:
        x = x + L.mlp_apply(block.mlp, h2, cfg)
    return x, new_cache


def _gather_embed(params: Transformer, tokens) -> torch.Tensor:
    tokens = torch.as_tensor(tokens, device=params.embed.device)
    return sharding.sharded_embed_lookup(params.embed, tokens)


def _embeds(params: Transformer, batch: Dict) -> torch.Tensor:
    """The stub frontend's embeddings, rounded to bf16 as the reference
    casts them."""
    return torch.as_tensor(batch["embeds"], device=params.embed.device).to(
        L.DEFAULT_DTYPE)


def _embed_input(params: Transformer, cfg, batch: Dict) -> torch.Tensor:
    """The input activation stream of any input modality."""
    check_family(cfg)
    if cfg.family == "audio":
        x = _embeds(params, batch)
    else:
        x = _gather_embed(params, batch["tokens"])
        if cfg.family == "vlm":
            emb = _embeds(params, batch)
            dt = torch.promote_types(emb.dtype, x.dtype)
            x = torch.cat([emb.to(dt), x.to(dt)], dim=1)
    return sharding.constrain_residual(x)


def _logits(x: torch.Tensor, params) -> torch.Tensor:
    return sharding.constrain(x @ params.head, "batch", None, "model")


def _prefix_len(cfg) -> int:
    return cfg.prefix_len if cfg.family == "vlm" else 0


def _block_out(block: Block, x: torch.Tensor, cfg, positions: torch.Tensor,
               prefix_len: int) -> torch.Tensor:
    return _layer_apply(block, x, cfg, positions, prefix_len)[0]


def hidden(params: Transformer, cfg, batch: Dict,
           remat: bool = True) -> torch.Tensor:
    """Full-sequence forward up to the final norm; returns (B, T, d).  With
    ``remat`` and grad enabled each block's activations are recomputed in
    the backward, keeping only the blocks' inputs."""
    x = _embed_input(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    prefix_len = _prefix_len(cfg)
    remat = remat and torch.is_grad_enabled()
    for block in params.layers:
        if remat:
            x = L.remat(_block_out, block, x, cfg, positions, prefix_len)
        else:
            x = _block_out(block, x, cfg, positions, prefix_len)
    return L.rms_norm(x, params.final_norm)


def forward(params: Transformer, cfg, batch: Dict,
            remat: bool = True) -> torch.Tensor:
    """Full-sequence forward; returns logits (B, T, V)."""
    return _logits(hidden(params, cfg, batch, remat), params)


def prefill(params: Transformer, cfg, batch: Dict,
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """Forward returning the last position's logits (B, 1, V) and a KV
    cache padded with zeros to ``max_len`` positions."""
    x = _embed_input(params, cfg, batch)
    B, T = x.shape[0], x.shape[1]
    S = max(max_len or T, T)
    positions = torch.arange(T, device=x.device)
    prefix_len = _prefix_len(cfg)
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    # k's dtype: a bf16 frame stream against float32 weights gives float32.
    dtype = torch.promote_types(x.dtype, params.layers[0].attn.wk.dtype)
    ks = sharding.zeros(shape, (None, "batch", None, None, None), dtype,
                        x.device)
    vs = torch.zeros_like(ks)
    for i, block in enumerate(params.layers):
        x, kv = _layer_apply(block, x, cfg, positions, prefix_len)
        ks[i, :, :T] = kv["k"]
        vs[i, :, :T] = kv["v"]
    cache = {"k": ks, "v": vs, "index": T}
    x = L.rms_norm(x, params.final_norm)
    return _logits(x[:, -1:], params), cache


def decode_step(params: Transformer, cfg, batch: Dict, cache: Dict
                ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode against the stacked-layer KV cache, which is
    updated in place; returns logits (B, 1, V) and the cache with
    ``index + 1``.  The audio family takes ``embeds`` (B, 1, d), the
    others ``tokens`` (B, 1)."""
    check_family(cfg)
    x = (_embeds(params, batch) if cfg.family == "audio"
         else _gather_embed(params, batch["tokens"]))
    x = sharding.constrain(x, "batch", None, None)
    idx = int(cache["index"])
    positions = torch.full((x.shape[0], 1), idx, dtype=torch.int64,
                           device=x.device)
    for i, block in enumerate(params.layers):
        x, _ = _layer_apply(block, x, cfg, positions, prefix_len=0,
                            cache={"k": cache["k"][i], "v": cache["v"][i],
                                   "index": idx})
    x = L.rms_norm(x, params.final_norm)
    new_cache = {"k": cache["k"], "v": cache["v"], "index": idx + 1}
    return _logits(x, params), new_cache


def cache_spec(cfg, batch: int, max_len: int) -> Dict:
    """Shapes and dtypes of the decode cache."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": (shape, L.DEFAULT_DTYPE), "v": (shape, L.DEFAULT_DTYPE),
            "index": ((), torch.int64)}


def cache_specs(cfg, seq_axes=("model",)) -> Dict:
    """Logical specs of :func:`cache_spec`'s tensors: the reference's
    ``cache_spec`` specs."""
    kv = kv_cache_spec(seq_axes)
    return {"k": kv, "v": kv, "index": ()}
