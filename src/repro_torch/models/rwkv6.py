"""RWKV-6 "Finch" (arXiv:2404.05892): the attention-free SSM family; the
counterpart of ``repro.models.rwkv6``.

Time-mix: data-dependent token-shift lerps (the ddlerp LoRA), a
per-channel decay ``w = exp(-exp(w0 + lora(x)))``, a per-head matrix state
``S_t = diag(w_t) S_{t-1} + k_t v_t^T`` and the output ``o_t = r_t (S_{t-1}
+ diag(u) k_t v_t^T)``, then a per-head group norm.  Channel-mix: a
squared-ReLU FFN gated by a sigmoid.

Two sequence modes, as the reference's (``SEQ_MODE``, :func:`set_seq_mode`):
``chunked`` (the default, chunk 64) runs :func:`_wkv_chunked`, the chunked
linear attention with the decay factorized in float32; ``scan`` runs the
exact per-step recurrence :func:`_wkv_scan`, which a decode step also
takes from the carried float32 state.  Both are PyTorch products on the
card, as the reference's are ``lax.scan`` and ``einsum`` outside any
Pallas kernel.

The parameters are the transformer's container,
:class:`~repro_torch.models.transformer.Transformer` (``embed``,
``layers`` of :class:`Layer`, ``final_norm``, ``head``), with grad off;
the decode cache is ``{"wkv": (L, B, H, dh, dh) float32, "tm_shift",
"cm_shift": (L, B, d), "index": int}``, updated in place by
:func:`decode_step`.  Every product keeps the reference's dtypes: a bf16
stream against the float32 lerp and LoRA tensors promotes to float32
where ``jnp`` promotes it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import sharding, transformer

DDLERP_DIM = 32
DECAY_LORA_DIM = 64
# The reference's default: a backward through the per-step scan would
# keep O(T) state snapshots, the chunked form O(T / chunk).
SEQ_MODE = {"mode": "chunked", "chunk": 64}


def set_seq_mode(mode: str, chunk: int = 64) -> None:
    SEQ_MODE["mode"] = mode
    SEQ_MODE["chunk"] = chunk


class Layer(L.Weights):
    """One layer: ``ln1``, ``ln2``, ``mu_x`` (d,), ``mu`` (5, d),
    ``ddlerp_a`` (d, 32), ``ddlerp_b`` (5, 32, d), ``w0`` (d,),
    ``w_lora_a`` (d, 64), ``w_lora_b`` (64, d), ``u`` (d,), ``wr``, ``wk``,
    ``wv``, ``wg``, ``wo`` (d, d), ``gn`` (d,), ``cm_mu_k``, ``cm_mu_r``
    (d,), ``cm_wk`` (d, ff), ``cm_wv`` (ff, d), ``cm_wr`` (d, d)."""


def layer_specs(cfg) -> Dict[str, tuple]:
    """Each :class:`Layer` parameter's logical spec."""
    return {
        "ln1": (None,), "ln2": (None,), "mu_x": (None,), "mu": (None, None),
        "ddlerp_a": (None, None), "ddlerp_b": (None, None, None),
        "w0": (None,), "w_lora_a": (None, None), "w_lora_b": (None, None),
        "u": (None,),
        "wr": ("fsdp", "model"), "wk": ("fsdp", "model"),
        "wv": ("fsdp", "model"), "wg": ("fsdp", "model"),
        "wo": ("model", "fsdp"), "gn": (None,),
        "cm_mu_k": (None,), "cm_mu_r": (None,),
        "cm_wk": ("fsdp", "model"), "cm_wv": ("model", "fsdp"),
        "cm_wr": ("fsdp", "model"),
    }


def param_specs(cfg) -> Dict[str, tuple]:
    """Every parameter's logical spec, keyed by its name in
    ``named_parameters()``."""
    return {"embed": (None, "model"),
            **transformer.stacked_specs("layers", cfg.n_layers,
                                        layer_specs(cfg)),
            "final_norm": (None,), "head": ("fsdp", "model")}


def init_layer(generator: torch.Generator, cfg) -> Layer:
    """The projections ``dense_init`` in bf16; the lerps, LoRAs and ``u``
    ``normal * 0.02`` in float32; ``w0`` -6; norms zeros."""
    d, ff = cfg.d_model, cfg.d_ff
    dev = generator.device

    def small(*shape):
        return torch.randn(shape, generator=generator, device=dev) * 0.02

    def dense(d_in, d_out):
        return L.dense_init(generator, d_in, d_out)
    return Layer(
        ln1=L.init_rms_norm(d, dev), ln2=L.init_rms_norm(d, dev),
        mu_x=small(d), mu=small(5, d), ddlerp_a=small(d, DDLERP_DIM),
        ddlerp_b=small(5, DDLERP_DIM, d),
        w0=torch.full((d,), -6.0, device=dev),
        w_lora_a=small(d, DECAY_LORA_DIM), w_lora_b=small(DECAY_LORA_DIM, d),
        u=small(d), wr=dense(d, d), wk=dense(d, d), wv=dense(d, d),
        wg=dense(d, d), wo=dense(d, d), gn=L.init_rms_norm(d, dev),
        cm_mu_k=small(d), cm_mu_r=small(d), cm_wk=dense(d, ff),
        cm_wv=dense(ff, d), cm_wr=dense(d, d))


def init_params(generator: torch.Generator, cfg) -> transformer.Transformer:
    embed = (torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                         device=generator.device) * 0.02).to(L.DEFAULT_DTYPE)
    layers = [init_layer(generator, cfg) for _ in range(cfg.n_layers)]
    return transformer.Transformer(embed, layers,
                                   L.init_rms_norm(cfg.d_model,
                                                   generator.device),
                                   L.dense_init(generator, cfg.d_model,
                                                cfg.vocab))


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """Token shift: x_{t-1}, zeros (or ``prev``) at t = 0."""
    first = (torch.zeros_like(x[:, :1]) if prev is None
             else prev[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _ddlerp(p: Layer, x: torch.Tensor, xx: torch.Tensor
            ) -> Tuple[torch.Tensor, ...]:
    """Data-dependent lerps for [w, k, v, r, g]."""
    dx = xx - x
    base = x + dx * p.mu_x
    dd = torch.tanh(base.float() @ p.ddlerp_a)
    dds = torch.einsum("btk,ikd->ibtd", dd, p.ddlerp_b)
    mixed = x[None] + dx[None] * (p.mu[:, None, None, :] + dds).to(x.dtype)
    # Under a mesh each lerp's gradient comes back reduced (a partial sum
    # would reach the LoRA's product with the sequence sharded).
    return tuple(sharding.constrain(m, "batch", None, None)
                 for m in mixed.unbind(0))


def _wkv_scan(r, k, v, w, u, dh: int,
              state: Optional[torch.Tensor] = None):
    """The exact per-step recurrence from ``state`` (zeros by default).
    r/k/v/w: (B, T, H, dh) float32; returns (o (B, T, H, dh), S (B, H, dh,
    dh))."""
    B, T, H, _ = r.shape
    S = (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=r.device)
         if state is None else state)
    outs = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]       # (B,H,dk,dv)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                 S + u[None, :, :, None] * kv))
        S = w[:, t, :, :, None] * S + kv
    return torch.stack(outs, 1), S


def _wkv_chunked(r, k, v, w, u, dh: int, chunk: int):
    """Chunked linear attention with per-channel decay, factorized in
    float32 as the reference's: within a chunk, with c[t] = sum_{tau <= t}
    log w_tau,

        o_t = r_t e^{c[t-1]} . S_in                          (cross)
            + sum_{s<t} (r_t e^{c[t-1]} . k_s e^{-c[s]}) v_s   (intra)
            + (r_t . u k_t) v_t                              (diagonal)

    The intra and diagonal terms read no state, so they are batched over
    every chunk; the loop carries the state, two products a chunk."""
    B, T, H, _ = r.shape
    Lc = min(chunk, T)
    pad = (-T) % Lc
    if pad:
        def z(x, value=0.0):
            return F.pad(x, (0, 0, 0, 0, 0, pad), value=value)
        r, k, v, w = z(r), z(k), z(v), z(w, 1.0)
    nc = (T + pad) // Lc

    def chunks(x):                                          # (nc,B,Lc,H,dh)
        return x.reshape(B, nc, Lc, H, dh).transpose(0, 1)
    rc, kc, vc, wc = chunks(r), chunks(k), chunks(v), chunks(w)
    logw = torch.log(torch.clamp_min(wc, 1e-12))
    c = torch.cumsum(logw, dim=2)
    c_prev = c - logw                                       # c[t-1]
    a = rc * torch.exp(c_prev)
    b = kc * torch.exp(-c)
    mask = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    att = torch.einsum("nblhk,nbmhk->nbhlm", a, b)
    att = torch.where(mask, att, 0.0)                       # strictly lower
    o_intra = torch.einsum("nbhlm,nbmhv->nblhv", att, vc)
    o_diag = (rc * (u * kc)).sum(-1, keepdim=True) * vc
    # S_out = e^{c[L-1]} S_in + sum_s e^{c[L-1] - c[s]} k_s v_s
    decay_last = torch.exp(c[:, :, -1])                     # (nc,B,H,dh)
    kd = kc * torch.exp(c[:, :, -1:] - c)
    S = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=r.device)
    o_cross = []
    for n in range(nc):
        o_cross.append(torch.einsum("blhk,bhkv->blhv", a[n], S))
        S = decay_last[n][..., None] * S + torch.einsum(
            "blhk,blhv->bhkv", kd[n], vc[n])
    o = torch.stack(o_cross) + o_intra + o_diag
    return o.transpose(0, 1).reshape(B, nc * Lc, H, dh)[:, :T], S


def time_mix(p: Layer, x: torch.Tensor, cfg, state: Optional[Dict] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (out, final wkv state, last x)."""
    B, T, d = x.shape
    dh = cfg.rwkv_head_dim
    H = d // dh
    prev = state["tm_shift"] if state is not None else None
    xw, xk, xv, xr, xg = _ddlerp(p, x, _shift(x, prev))
    w = torch.exp(-torch.exp(
        p.w0 + torch.tanh(xw.float() @ p.w_lora_a) @ p.w_lora_b))
    r, k, v = xr @ p.wr, xk @ p.wk, xv @ p.wv
    g = F.silu(xg @ p.wg)

    def heads(t):
        return sharding.split_last(t.float(), H, dh)
    u = p.u.reshape(H, dh)
    rh, kh, vh, wh = heads(r), heads(k), heads(v), heads(w)
    if state is not None:          # decode: exact steps from carried state
        o, S = sharding.batch_local(
            lambda r, k, v, w, s0, u: _wkv_scan(r, k, v, w, u, dh, s0),
            (rh, kh, vh, wh, state["wkv"].float()), u)
    elif SEQ_MODE["mode"] == "chunked":
        o, S = sharding.batch_local(_wkv_chunked, (rh, kh, vh, wh), u, dh,
                                    SEQ_MODE["chunk"])
    else:
        o, S = sharding.batch_local(_wkv_scan, (rh, kh, vh, wh), u, dh)
    # Per-head group norm.
    mean = o.mean(-1, keepdim=True)
    var = o.var(-1, keepdim=True, correction=0)
    o = (o - mean) * torch.rsqrt(var + 1e-5)
    o = sharding.merge_last(o) * (1.0 + p.gn)
    out = sharding.constrain((o.to(x.dtype) * g) @ p.wo, "batch", None, None)
    return out, S, x[:, -1]


def channel_mix(p: Layer, x: torch.Tensor, state: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    prev = state["cm_shift"] if state is not None else None
    dx = _shift(x, prev) - x
    xk = x + dx * p.cm_mu_k.to(x.dtype)
    xr = x + dx * p.cm_mu_r.to(x.dtype)
    kk = F.relu(xk @ p.cm_wk)
    kk = kk * kk
    out = torch.sigmoid(xr @ p.cm_wr) * (kk @ p.cm_wv)
    return sharding.constrain(out, "batch", None, None), x[:, -1]


def layer_apply(p: Layer, x: torch.Tensor, cfg,
                state: Optional[Dict] = None) -> Tuple[torch.Tensor, Dict]:
    h, wkv, tm_last = time_mix(p, L.rms_norm(x, p.ln1), cfg, state)
    x = x + h
    h2, cm_last = channel_mix(p, L.rms_norm(x, p.ln2), state)
    return x + h2, {"wkv": wkv, "tm_shift": tm_last, "cm_shift": cm_last}


def _layer_out(p: Layer, x: torch.Tensor, cfg) -> torch.Tensor:
    return layer_apply(p, x, cfg)[0]


def hidden(params: transformer.Transformer, cfg, batch: Dict,
           remat: bool = True) -> torch.Tensor:
    """Full-sequence forward up to the final norm; with ``remat`` and grad
    enabled each layer is recomputed in the backward."""
    x = _embed(params, batch)
    remat = remat and torch.is_grad_enabled()
    for layer in params.layers:
        x = (L.remat(_layer_out, layer, x, cfg) if remat
             else _layer_out(layer, x, cfg))
    return L.rms_norm(x, params.final_norm)


def _embed(params: transformer.Transformer, batch: Dict) -> torch.Tensor:
    x = transformer._gather_embed(params, batch["tokens"])
    return sharding.constrain(x, "batch", None, None)


def forward(params: transformer.Transformer, cfg, batch: Dict,
            remat: bool = True) -> torch.Tensor:
    return transformer._logits(hidden(params, cfg, batch, remat), params)


STATE = ("wkv", "tm_shift", "cm_shift")


def prefill(params: transformer.Transformer, cfg, batch: Dict,
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """The last position's logits (B, 1, V) and the decode state, O(1) in
    the sequence length (``max_len`` is not needed)."""
    x = _embed(params, batch)
    states = []
    for layer in params.layers:
        x, st = layer_apply(layer, x, cfg)
        states.append(st)
    cache = {n: torch.stack([st[n] for st in states]) for n in STATE}
    cache["index"] = x.shape[1]
    x = L.rms_norm(x, params.final_norm)
    return transformer._logits(x[:, -1:], params), cache


def decode_step(params: transformer.Transformer, cfg, batch: Dict,
                cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One token from the carried state, which is updated in place;
    returns logits (B, 1, V) and the cache with ``index + 1``."""
    x = _embed(params, batch)
    for i, layer in enumerate(params.layers):
        x, st = layer_apply(layer, x, cfg,
                            state={n: cache[n][i] for n in STATE})
        for n in STATE:
            cache[n][i] = st[n]
    x = L.rms_norm(x, params.final_norm)
    new_cache = {n: cache[n] for n in STATE}
    new_cache["index"] = int(cache["index"]) + 1
    return transformer._logits(x, params), new_cache


def cache_spec(cfg, batch: int, max_len: int) -> Dict:
    """Shapes and dtypes of the decode state, O(1) in ``max_len``."""
    d, dh = cfg.d_model, cfg.rwkv_head_dim
    n = cfg.n_layers
    return {"wkv": ((n, batch, d // dh, dh, dh), torch.float32),
            "tm_shift": ((n, batch, d), L.DEFAULT_DTYPE),
            "cm_shift": ((n, batch, d), L.DEFAULT_DTYPE),
            "index": ((), torch.int64)}


def cache_specs(cfg, seq_axes=("model",)) -> Dict:
    """Logical specs of :func:`cache_spec`'s tensors (the state is O(1) in
    the sequence, so ``seq_axes`` is not read)."""
    return {"wkv": (None, "batch", None, None, None),
            "tm_shift": (None, "batch", None),
            "cm_shift": (None, "batch", None), "index": ()}
