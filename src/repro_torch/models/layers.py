"""Shared model layers of the dense transformer: norms, RoPE, GQA
attention, MLPs.

The counterpart of ``repro.models.layers`` (dense parts): parameters live
in :class:`torch.nn.Module` s (:class:`Attention`, :class:`MLP`) whose
tensors keep the reference's ``(d_in, d_out)`` orientation, and the layer
math is plain functions on tensors with the reference's names and
signatures.  Products are ``x @ w`` through :func:`torch.matmul`, as the
reference leaves them to XLA outside any kernel.

:func:`flash_attention` is the CUDA kernel's wrapper: on CUDA tensors it
launches ``csrc/flash_attention.cu``, on CPU tensors it runs the plain
blocked version.  The reference's comment says its attention dispatches to
the Pallas kernel, but ``attention_apply`` calls the jnp version directly;
here every prefill attention on the card runs the kernel.  Decode
attention (one query over the cache) stays plain PyTorch, as the reference
computes it in jnp outside any kernel.  Training differentiates through
the kernel's autograd Function (its backward is a kernel too); remat is the
transformer's.  MoE and sharding belong to later slices; the reference's
sharding constraints are no-ops on one card and are dropped.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: F401
    flash_attention)
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    AttnBlocking, get_attn_blocking, set_attn_blocking)

DEFAULT_DTYPE = torch.bfloat16


# ---------------------------------------------------------------------------
# Initializers / norms
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype=DEFAULT_DTYPE) -> torch.Tensor:
    """``normal * d_in ** -0.5`` drawn on the generator's device."""
    scale = (1.0 / d_in) ** 0.5
    w = torch.randn((d_in, d_out), generator=generator,
                    device=generator.device)
    return (w * scale).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32, times ``1 + scale`` (``scale`` starts at 0),
    cast back to the input dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dt)


def init_rms_norm(d: int, device=None) -> torch.Tensor:
    return torch.zeros((d,), dtype=torch.float32, device=device)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, base: float = 10000.0,
         mode: str = "full") -> torch.Tensor:
    """Rotary embedding with a NeoX-style half split.  ``mode='half'``
    rotates only the first half of the head dims (ChatGLM's 2-d RoPE
    convention); ``'none'`` is identity.

    x: (B, T, H, dh); positions: (T,) or (B, T).
    """
    if mode == "none":
        return x
    dh = x.shape[-1]
    rot = dh if mode == "full" else dh // 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=x.device)
    freqs = torch.pow(base, -ar / half)                   # float32
    if positions.dim() == 1:
        angles = positions[:, None].float() * freqs[None, :]
        angles = angles[None, :, None, :]                 # (1, T, 1, half)
    else:
        angles = positions[..., None].float() * freqs
        angles = angles[:, :, None, :]                    # (B, T, 1, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1f, x2f = x_rot[..., :half].float(), x_rot[..., half:].float()
    rotated = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin],
                        dim=-1)
    if mode == "half":
        return torch.cat([rotated.to(x.dtype), x_pass], dim=-1)
    return rotated.to(x.dtype)


# ---------------------------------------------------------------------------
# Decode attention (plain PyTorch, as the reference's jnp)
# ---------------------------------------------------------------------------

def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid_len: int) -> torch.Tensor:
    """Single-token attention over a KV cache.

    q: (B, 1, Hq, dh); caches: (B, S, Hkv, dh); keys at or past
    ``valid_len`` are masked.  Scores in float32; the probabilities are
    rounded to the cache dtype before P·V, as the reference does.
    """
    B, _, Hq, dh = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    g = Hq // Hkv
    qr = q.reshape(B, Hkv, g, dh)
    s = torch.einsum("bhgd,bkhd->bhgk", qr.float(),
                     k_cache.float()) * (dh ** -0.5)
    mask = torch.arange(S, device=q.device)[None, None, None, :] < valid_len
    s = torch.where(mask, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, Hq, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """``wq`` (d, Hq dh), ``wk``/``wv`` (d, Hkv dh), ``wo`` (Hq dh, d) and,
    with qk-norm, ``q_norm``/``k_norm`` (dh,) in float32."""

    def __init__(self, wq, wk, wv, wo, q_norm=None, k_norm=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = (
            _param(wq), _param(wk), _param(wv), _param(wo))
        self.q_norm = None if q_norm is None else _param(q_norm)
        self.k_norm = None if k_norm is None else _param(k_norm)


def init_attention(generator: torch.Generator, cfg) -> Attention:
    d, dh = cfg.d_model, cfg.head_dim
    norms = ((init_rms_norm(dh, generator.device),
              init_rms_norm(dh, generator.device))
             if cfg.qk_norm else (None, None))
    return Attention(dense_init(generator, d, cfg.n_heads * dh),
                     dense_init(generator, d, cfg.n_kv_heads * dh),
                     dense_init(generator, d, cfg.n_kv_heads * dh),
                     dense_init(generator, cfg.n_heads * dh, d), *norms)


def attention_apply(params: Attention, x: torch.Tensor, cfg,
                    positions: torch.Tensor, causal: bool = True,
                    prefix_len: int = 0, cache: Optional[Dict] = None
                    ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, T, d).  With ``cache`` (decode): T == 1, the cache holds k/v
    (B, S, Hkv, dh) and the int ``index``; the new k/v are written at
    ``index`` in place and the cache is returned with ``index + 1``.
    Without a cache: full-sequence flash attention; returns (out, new_kv)
    where new_kv holds this segment's k/v for the prefill cache.
    """
    B, T, d = x.shape
    dh = cfg.head_dim
    q = (x @ params.wq).reshape(B, T, cfg.n_heads, dh)
    k = (x @ params.wk).reshape(B, T, cfg.n_kv_heads, dh)
    v = (x @ params.wv).reshape(B, T, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = rms_norm(q, params.q_norm)
        k = rms_norm(k, params.k_norm)
    q = rope(q, positions, cfg.rope_base, cfg.rope_mode)
    k = rope(k, positions, cfg.rope_base, cfg.rope_mode)

    if cache is not None:
        idx = int(cache["index"])
        k_cache, v_cache = cache["k"], cache["v"]
        if not 0 <= idx <= k_cache.shape[1] - T:
            raise IndexError(f"decode index {idx} is past the cache's "
                             f"{k_cache.shape[1]} positions")
        k_cache[:, idx:idx + T] = k
        v_cache[:, idx:idx + T] = v
        out = decode_attention(q, k_cache, v_cache, valid_len=idx + 1)
        new_cache = {"k": k_cache, "v": v_cache, "index": idx + 1}
    else:
        out = flash_attention(q, k, v, causal=causal, prefix_len=prefix_len)
        new_cache = {"k": k, "v": v}
    out = out.reshape(B, T, cfg.n_heads * dh)
    return out @ params.wo, new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

GATED = ("swiglu", "geglu")


class MLP(nn.Module):
    """Gated (swiglu, geglu): ``w_gate``/``w_up`` (d, ff), ``w_down``
    (ff, d); otherwise ``w_in`` (d, ff), ``w_out`` (ff, d)."""

    def __init__(self, **weights):
        super().__init__()
        for name, w in weights.items():
            setattr(self, name, _param(w))


def init_mlp(generator: torch.Generator, cfg,
             d_ff: Optional[int] = None) -> MLP:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    if cfg.act in GATED:
        return MLP(w_gate=dense_init(generator, d, ff),
                   w_up=dense_init(generator, d, ff),
                   w_down=dense_init(generator, ff, d))
    return MLP(w_in=dense_init(generator, d, ff),
               w_out=dense_init(generator, ff, d))


def _act(name: str, h: torch.Tensor) -> torch.Tensor:
    if name == "gelu":
        return F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    if name == "sq_relu":                      # squared-ReLU (Nemotron/Primer)
        r = F.relu(h)
        return r * r
    raise ValueError(name)


def mlp_apply(params: MLP, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.act == "swiglu":
        h = F.silu(x @ params.w_gate) * (x @ params.w_up)
        return h @ params.w_down
    if cfg.act == "geglu":
        h = F.gelu(x @ params.w_gate, approximate="tanh") * (x @ params.w_up)
        return h @ params.w_down
    return _act(cfg.act, x @ params.w_in) @ params.w_out
