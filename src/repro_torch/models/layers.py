"""Shared model layers of the transformer: norms, RoPE, GQA attention,
MLPs and the top-k MoE.

The counterpart of ``repro.models.layers``: parameters live in
:class:`torch.nn.Module` s (:class:`Attention`, :class:`MLP`,
:class:`MoE`) whose tensors keep the reference's ``(d_in, d_out)``
orientation, and the layer math is plain functions on tensors with the
reference's names and signatures.  Products are ``x @ w`` through
:func:`torch.matmul`, as the reference leaves them to XLA outside any kernel.

:func:`flash_attention` is the CUDA kernel's wrapper: on CUDA tensors it
launches ``csrc/flash_attention.cu``, on CPU tensors it runs the plain
blocked version.  The reference's comment says its attention dispatches to
the Pallas kernel, but ``attention_apply`` calls the jnp version directly;
here every prefill attention on the card runs the kernel.  Decode
attention (one query over the cache) stays plain PyTorch, as the reference
computes it in jnp outside any kernel.  Training differentiates through
the kernel's operator (its backward is a kernel too).

The spec helpers (:func:`attention_specs`, :func:`mlp_specs`,
:func:`moe_specs`) give each weight's logical sharding, and the
reference's :func:`~repro_torch.models.sharding.constrain` calls stand at
its sites: no-ops without a mesh.  Under a mesh the attention kernel runs
on each device's shard through ``local_map`` (:func:`_attend`).  The remat
policy (:func:`set_remat_policy`) picks what a block's checkpoint keeps:
``"nothing"`` (recompute the whole block) or ``"dots"`` (keep the 2-D
weight products).

The MoE keeps the reference's sort-based dispatch and its capacity drops
token for token (:func:`moe_route`): ``jax.lax.top_k``'s order (the lower
index first on a tie) is a stable descending sort, ``jnp.argsort`` a
stable one, ``jnp.searchsorted`` the left side.  Its scatters become
gathers: each capacity slot reads the token that fills it, and each token
sums its k expert outputs in the reference's order (their sorted
positions), so the card adds no atomics and two runs give the same bits.
The expert products stay ``torch.einsum``, as the reference leaves them
to XLA outside any kernel.
"""
from __future__ import annotations

import functools
import types
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: F401
    flash_attention)
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    AttnBlocking, get_attn_blocking, set_attn_blocking)
from repro_torch.models import sharding

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


class Weights(nn.Module):
    """Named tensors held as parameters with grad off, in the order given:
    the reference's dict of one layer's leaves."""

    def __init__(self, **weights):
        super().__init__()
        for name, w in weights.items():
            setattr(self, name, _param(w))


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
    # Under a mesh the cache's sequence holds the tensor axis: the query's
    # heads are gathered whole (the reference leaves this to its compiler).
    q = sharding.constrain(q, "batch", None, None, None)
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

def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` promoting a bfloat16 ``x`` against float32 ``w`` (frame
    embeddings into a float32 copy), as each of the reference's products
    promotes its operands."""
    return x.to(torch.promote_types(x.dtype, w.dtype)) @ w


def attention_specs(cfg) -> Dict:
    specs = {
        "wq": ("fsdp", "model"), "wk": ("fsdp", "model"),
        "wv": ("fsdp", "model"), "wo": ("model", "fsdp"),
    }
    if cfg.qk_norm:
        specs["q_norm"] = (None,)
        specs["k_norm"] = (None,)
    return specs


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
    # Sequence parallelism: the sequence is gathered before the
    # token-mixing op (a no-op otherwise).
    x = sharding.constrain(x, "batch", None, None)
    q = sharding.split_last(_matmul(x, params.wq), cfg.n_heads, dh)
    # k and v are replicated over the tensor axis before the (Hkv, dh)
    # split (the reference constrains them after it): Hkv may be smaller
    # than the axis.
    k = sharding.constrain(_matmul(x, params.wk), "batch", None, None)
    v = sharding.constrain(_matmul(x, params.wv), "batch", None, None)
    k = k.reshape(B, T, cfg.n_kv_heads, dh)
    v = v.reshape(B, T, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = rms_norm(q, params.q_norm)
        k = rms_norm(k, params.k_norm)
    q = rope(q, positions, cfg.rope_base, cfg.rope_mode)
    k = rope(k, positions, cfg.rope_base, cfg.rope_mode)
    q = sharding.constrain(q, "batch", None, "model", None)

    if cache is not None:
        idx = int(cache["index"])
        k_cache, v_cache = cache["k"], cache["v"]
        if not 0 <= idx <= k_cache.shape[1] - T:
            raise IndexError(f"decode index {idx} is past the cache's "
                             f"{k_cache.shape[1]} positions")
        sharding.write_seq(k_cache, k, idx)
        sharding.write_seq(v_cache, v, idx)
        out = decode_attention(q, k_cache, v_cache, valid_len=idx + 1)
        out = out.reshape(B, T, cfg.n_heads * dh)
        new_cache = {"k": k_cache, "v": v_cache, "index": idx + 1}
    else:
        out = _attend(q, k, v, causal, prefix_len)
        new_cache = {"k": k, "v": v}
    return sharding.constrain_residual(out @ params.wo), new_cache


def _kv_repeats(hq: int, hkv: int, m: int) -> int:
    """How many times to repeat each kv head so that the kv heads split
    over ``m`` devices as the query heads do: the least r with Hkv r a
    multiple of m that divides the group Hq / Hkv (the whole group when
    none does)."""
    g = hq // hkv
    for r in range(1, g + 1):
        if (hkv * r) % m == 0 and g % r == 0:
            return r
    return g


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            prefix_len: int) -> torch.Tensor:
    """:func:`flash_attention` of (B, T, H, dh) operands, its output's heads
    merged: (B, T, H dh).  Under a mesh the kernel runs on each device's
    shard through ``local_map``: batch on the data axes and heads on the
    tensor axis (where the axis divides the query heads; otherwise the
    heads stay whole), the sequence whole; the heads are merged there too,
    so no sharded (H, dh) split meets autograd.  Each kv head is repeated so
    that a device's query heads find theirs (:func:`_kv_repeats`)."""
    B, T, hq, dh = q.shape
    if not sharding.is_sharded(q):
        out = flash_attention(q, k, v, causal=causal, prefix_len=prefix_len)
        return out.reshape(B, T, hq * dh)
    from torch.distributed.tensor.experimental import local_map
    ctx = sharding.get_ctx()
    mesh = ctx.mesh
    m = mesh.size(mesh.mesh_dim_names.index(ctx.model_axis))
    hkv = k.shape[2]
    heads = "model" if hq % m == 0 else None
    if heads and hkv % m:
        r = _kv_repeats(hq, hkv, m)
        k = torch.repeat_interleave(k, r, dim=2)
        v = torch.repeat_interleave(v, r, dim=2)
    q, k, v = (sharding.constrain(x, "batch", None, heads, None)
               for x in (q, k, v))

    def local(a, b, c):
        out = flash_attention(a, b, c, causal=causal, prefix_len=prefix_len)
        return out.reshape(out.shape[0], out.shape[1], -1)
    f = local_map(local, out_placements=list(q.placements),
                  in_placements=(q.placements, k.placements, v.placements),
                  device_mesh=mesh)
    return f(q, k, v)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

GATED = ("swiglu", "geglu")


def mlp_specs(cfg) -> Dict:
    if cfg.act in GATED:
        return {"w_gate": ("fsdp", "model"), "w_up": ("fsdp", "model"),
                "w_down": ("model", "fsdp")}
    return {"w_in": ("fsdp", "model"), "w_out": ("model", "fsdp")}


class MLP(Weights):
    """Gated (swiglu, geglu): ``w_gate``/``w_up`` (d, ff), ``w_down``
    (ff, d); otherwise ``w_in`` (d, ff), ``w_out`` (ff, d)."""


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
    x = sharding.constrain(x, "batch", None, None)
    if cfg.act == "swiglu":
        h = F.silu(x @ params.w_gate) * (x @ params.w_up)
        out = h @ params.w_down
    elif cfg.act == "geglu":
        h = F.gelu(x @ params.w_gate, approximate="tanh") * (x @ params.w_up)
        out = h @ params.w_down
    else:
        out = _act(cfg.act, x @ params.w_in) @ params.w_out
    return sharding.constrain_residual(out)


# ---------------------------------------------------------------------------
# MoE (top-k routing, sort-based dispatch)
# ---------------------------------------------------------------------------

def moe_specs(cfg) -> Dict:
    return {
        "router": (None, None),
        "w_gate": ("model", "fsdp", None),
        "w_up": ("model", "fsdp", None),
        "w_down": ("model", None, "fsdp"),
    }


class MoE(nn.Module):
    """``router`` (d, E) in float32; ``w_gate``/``w_up`` (E, d, fe) and
    ``w_down`` (E, fe, d)."""

    def __init__(self, router, w_gate, w_up, w_down):
        super().__init__()
        self.router, self.w_gate, self.w_up, self.w_down = (
            _param(router), _param(w_gate), _param(w_up), _param(w_down))


def init_moe(generator: torch.Generator, cfg) -> MoE:
    """The router as ``dense_init`` in float32; every expert weight,
    ``w_down`` included, ``normal * d_model ** -0.5`` in bf16."""
    d, m = cfg.d_model, cfg.moe
    e, fe = m.num_experts, m.d_expert
    scale = (1.0 / d) ** 0.5

    def experts(d_in, d_out):
        w = torch.randn((e, d_in, d_out), generator=generator,
                        device=generator.device)
        return (w * scale).to(DEFAULT_DTYPE)

    return MoE(dense_init(generator, d, e, dtype=torch.float32),
               experts(d, fe), experts(d, fe), experts(fe, d))


def _expert_ffn(params: MoE, xb: torch.Tensor, act: str) -> torch.Tensor:
    """xb: (..., E, C, d) grouped expert inputs -> same-shaped outputs."""
    gate = torch.einsum("...ecd,edf->...ecf", xb, params.w_gate)
    up = torch.einsum("...ecd,edf->...ecf", xb, params.w_up)
    if act == "swiglu":
        h = F.silu(gate) * up
    elif act == "geglu":
        h = F.gelu(gate, approximate="tanh") * up
    else:
        h = _act(act, gate) * up
    return torch.einsum("...ecf,efd->...ecd", h, params.w_down)


def _experts(params: MoE, buf: torch.Tensor, act: str) -> torch.Tensor:
    """:func:`_expert_ffn` of the capacity buffer.  Under a mesh each
    device runs the experts it holds on its slots through ``local_map``,
    each expert's weights gathered over their fsdp axis first."""
    if not sharding.is_sharded(buf):
        return _expert_ffn(params, buf, act)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    experts = Shard(buf.ndim - 3)
    pl = list(buf.placements)
    w_pl = [Shard(0) if p == experts else Replicate() for p in pl]

    def local(b, g, u, d):
        w = types.SimpleNamespace(w_gate=g, w_up=u, w_down=d)
        return _expert_ffn(w, b, act)
    f = local_map(local, out_placements=pl,
                  in_placements=(pl, w_pl, w_pl, w_pl),
                  device_mesh=buf.device_mesh, redistribute_inputs=True)
    return f(buf, params.w_gate, params.w_up, params.w_down)


# Module-level capacity knob, as the reference's.
MOE_OPTIONS = {"capacity_factor": 1.25}


def set_moe_capacity_factor(cf: float) -> None:
    MOE_OPTIONS["capacity_factor"] = cf


# Remat policy of a block's checkpoint: "nothing" (keep only the block's
# input, recompute the rest) or "dots" (keep the 2-D weight products'
# outputs as well: no recomputed product in the backward, more memory).
REMAT_OPTIONS = {"policy": "nothing"}

_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def set_remat_policy(policy: str) -> None:
    if policy not in ("nothing", "dots"):
        raise ValueError(f"remat policy {policy!r} is not 'nothing' or "
                         f"'dots'")
    REMAT_OPTIONS["policy"] = policy


def _save_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_policy():
    """The ``context_fn`` of :func:`torch.utils.checkpoint.checkpoint` for
    the policy set: None for ``"nothing"``; for ``"dots"`` selective
    checkpointing that saves ``aten.mm``/``aten.addmm`` outputs (the
    reference's ``checkpoint_dots_with_no_batch_dims``: batched products
    and attention are recomputed)."""
    if REMAT_OPTIONS["policy"] != "dots":
        return None
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return functools.partial(create_selective_checkpoint_contexts,
                             _save_dots)


def remat(fn, *args):
    """``fn(*args)`` under a non-reentrant checkpoint with the policy
    set."""
    from torch.utils.checkpoint import checkpoint
    context_fn = remat_policy()
    if context_fn is None:
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest in descending
    order, the lower index first on a tie."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(tokens: int, cfg, capacity_factor: float) -> int:
    """Slots per expert in a group of ``tokens`` tokens."""
    m = cfg.moe
    return max(int(tokens * m.top_k / m.num_experts * capacity_factor
                   + 0.999), 1)


def moe_route(logits: torch.Tensor, k: int, capacity: int) -> Dict:
    """The reference's routing of groups of tokens from their router
    logits (G, T, E): each token's top-k experts and renormalized gates,
    its (token, k) entries stably sorted by expert, each entry's position
    in its expert's slot list, and whether it fits the ``capacity``.

    Returns ``expert_idx`` (G, T, k); ``sort_idx`` (each sorted entry's
    flat index, token * k + j), ``sorted_expert``, ``sorted_token``,
    ``sorted_gate``, ``keep`` and ``dest`` (expert * capacity + slot) over
    the G x T k sorted entries; ``starts`` and ``counts`` (G, E), each
    expert's first sorted entry and its number of entries.
    """
    G, T, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    gate, expert_idx = _top_k(probs, k)                       # (G, T, k)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    flat_expert = expert_idx.reshape(G, T * k)
    sort_idx = torch.argsort(flat_expert, dim=-1, stable=True)
    sorted_expert = torch.gather(flat_expert, 1, sort_idx)
    experts = torch.arange(E, device=logits.device).expand(G, E).contiguous()
    starts = torch.searchsorted(sorted_expert, experts)
    ends = torch.searchsorted(sorted_expert, experts, right=True)
    pos = torch.arange(T * k, device=logits.device) - torch.gather(
        starts, 1, sorted_expert)
    return {"expert_idx": expert_idx, "sort_idx": sort_idx,
            "sorted_expert": sorted_expert,
            "sorted_token": torch.div(sort_idx, k, rounding_mode="floor"),
            "sorted_gate": torch.gather(gate.reshape(G, T * k), 1,
                                        sort_idx),
            "keep": pos < capacity,
            "dest": sorted_expert * capacity + torch.clamp_max(
                pos, capacity - 1),
            "starts": starts, "counts": ends - starts}


_ROUTE_KEYS = ("expert_idx", "sort_idx", "sorted_expert", "sorted_token",
               "sorted_gate", "keep", "dest", "starts", "counts")


def _route(logits: torch.Tensor, k: int, capacity: int) -> Dict:
    """:func:`moe_route`; under a mesh each device routes its own groups
    (``local_map`` over the groups' axis: the sort stays local to the data
    shard, as in the reference)."""
    if not sharding.is_sharded(logits):
        return moe_route(logits, k, capacity)
    from torch.distributed.tensor.experimental import local_map
    logits = sharding.constrain(logits, "batch", None, None)
    pl = list(logits.placements)
    f = local_map(lambda lg: tuple(moe_route(lg, k, capacity)[key]
                                   for key in _ROUTE_KEYS),
                  out_placements=tuple([pl] * len(_ROUTE_KEYS)),
                  in_placements=(pl,), device_mesh=logits.device_mesh)
    return dict(zip(_ROUTE_KEYS, f(logits)))


def _moe_groups(params: MoE, x: torch.Tensor, cfg,
                capacity_factor: float,
                buf_kinds=("batch", "model", None, None)) -> torch.Tensor:
    """Sort-based dispatch within each group of x (G, T, d): the capacity
    buffer (G, E, C, d), sharded by ``buf_kinds`` under a mesh, the expert
    FFNs, and each token's k gated expert outputs summed in sorted
    order."""
    m = cfg.moe
    G, T, d = x.shape
    E, k = m.num_experts, m.top_k
    C = capacity(T, cfg, capacity_factor)
    r = _route(x.float() @ params.router.float(), k, C)
    # Slot (e, c) holds sorted entry starts[e] + c while c < counts[e]
    # (then it also fits the capacity); the other slots stay 0.
    slot = torch.arange(C, device=x.device)
    entry = (r["starts"][:, :, None] + slot).reshape(G, E * C)
    filled = (slot < r["counts"][:, :, None]).reshape(G, E * C)
    token = torch.gather(r["sorted_token"], 1,
                         torch.clamp_max(entry, T * k - 1))
    gathered = torch.gather(x, 1, token[..., None].expand(G, E * C, d))
    buf = torch.where(filled[..., None], gathered,
                      torch.zeros((), dtype=x.dtype, device=x.device))
    buf = sharding.constrain(buf.reshape(G, E, C, d), *buf_kinds)
    out_buf = sharding.constrain(_experts(params, buf, cfg.act),
                                 *buf_kinds)
    back = torch.gather(out_buf.reshape(G, E * C, d), 1,
                        r["dest"][..., None].expand(G, T * k, d))
    back = back * (r["sorted_gate"] * r["keep"]).to(x.dtype)[..., None]
    # Each token's k sorted positions, ascending: the reference's
    # scatter-add adds them in this order.
    order = torch.empty_like(r["sort_idx"]).scatter_(
        1, r["sort_idx"], torch.arange(T * k, device=x.device).expand(G, -1))
    order = torch.sort(order.reshape(G, T, k), dim=-1).values
    parts = torch.gather(back, 1, order.reshape(G, T * k, 1).expand(
        G, T * k, d)).reshape(G, T, k, d)
    out = torch.zeros((G, T, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        out = out + parts[:, :, j]
    return out


def moe_apply(params: MoE, x: torch.Tensor, cfg,
              capacity_factor: Optional[float] = None) -> torch.Tensor:
    """Top-k MoE with per-sequence sort-based dispatch.

    Tokens are grouped by batch row, placed in a capacity-bounded
    (B, E, C, d) buffer, pushed through the expert FFNs, and combined
    with renormalized top-k gates.  Overflowing tokens are dropped (GShard
    convention).  Decode (T == 1) dispatches the whole batch as one group
    (:func:`_moe_flat`), so C = B k / E cf.
    """
    # Dispatch sorts tokens per batch row: keep the full sequence local.
    x = sharding.constrain(x, "batch", None, None)
    B, T, d = x.shape
    if capacity_factor is None:
        capacity_factor = MOE_OPTIONS["capacity_factor"]
    if T == 1:
        out = _moe_flat(params, x[:, 0], cfg, capacity_factor)[:, None]
    else:
        out = _moe_groups(params, x, cfg, capacity_factor)
    return sharding.constrain_residual(out)


def _moe_flat(params: MoE, x: torch.Tensor, cfg,
              capacity_factor: float) -> torch.Tensor:
    """Single-group dispatch over the flat (N, d) token batch (decode):
    experts sharded on the tensor axis and capacity slots on the data
    axes."""
    return _moe_groups(params, x[None], cfg, capacity_factor,
                       buf_kinds=(None, "model", "batch", None))[0]


def moe_aux_loss(params: MoE, x: torch.Tensor, cfg) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss."""
    m = cfg.moe
    probs = torch.softmax(x.float() @ params.router.float(), dim=-1)
    _, expert_idx = _top_k(probs, m.top_k)
    counts = torch.bincount(expert_idx.reshape(-1),
                            minlength=m.num_experts).float()
    frac_tokens = counts / torch.clamp_min(counts.sum(), 1.0)
    frac_probs = probs.mean(dim=(0, 1))
    return m.num_experts * torch.sum(frac_tokens * frac_probs)
