"""Mamba-2 (SSD, arXiv:2405.21060), the layer of the Zamba2 hybrid; the
counterpart of ``repro.models.mamba2``.

Scalar-per-head decay makes the chunked form exact in float32: every
pairwise decay factor in a chunk is exp(c_t - c_s) with c decreasing, so
each exponent is <= 0 (clipped to [-60, 0] as the reference clips it).

Train and prefill: :func:`_ssd_chunked` (the intra-chunk masked products
and the state carried from chunk to chunk, a handful of batched products
a chunk of ``CHUNK`` positions).  Decode: :func:`_ssd_scan`, the O(1)
recurrent step with the conv and SSM states carried in the cache.  Both
are PyTorch products on the card, as the reference's are ``lax.scan`` and
``einsum`` outside any Pallas kernel.  The bf16 conv input times the
float32 ``conv_w`` gives a float32 conv output, as ``jnp`` promotes it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import sharding

CHUNK = 256


def dims(cfg):
    d_in = cfg.ssm.expand * cfg.d_model
    H = d_in // cfg.ssm.head_dim
    return d_in, H, cfg.ssm.d_state, cfg.ssm.conv_width


class Layer(L.Weights):
    """One layer: ``ln`` (d,), ``in_proj`` (d, 2 d_in + 2 ds + H),
    ``conv_w`` (cw, d_in + 2 ds), ``conv_b`` (d_in + 2 ds,), ``A_log``,
    ``D``, ``dt_bias`` (H,), ``gn`` (d_in,), ``out_proj`` (d_in, d)."""


def layer_specs(cfg) -> Dict[str, tuple]:
    """Each :class:`Layer` parameter's logical spec."""
    return {
        "ln": (None,), "in_proj": ("fsdp", "model"),
        "conv_w": (None, "model"), "conv_b": ("model",),
        "A_log": (None,), "D": (None,), "dt_bias": (None,),
        "gn": ("model",), "out_proj": ("model", "fsdp"),
    }


def init_layer(generator: torch.Generator, cfg) -> Layer:
    """The projections ``dense_init`` in bf16; ``conv_w`` ``normal * 0.1``
    in float32; ``D`` ones; norms, biases and ``A_log`` zeros."""
    d = cfg.d_model
    d_in, H, ds, cw = dims(cfg)
    conv_ch = d_in + 2 * ds
    dev = generator.device
    return Layer(
        ln=L.init_rms_norm(d, dev),
        in_proj=L.dense_init(generator, d, 2 * d_in + 2 * ds + H),
        conv_w=torch.randn((cw, conv_ch), generator=generator,
                           device=dev) * 0.1,
        conv_b=torch.zeros((conv_ch,), device=dev),
        A_log=torch.zeros((H,), device=dev),
        D=torch.ones((H,), device=dev),
        dt_bias=torch.zeros((H,), device=dev),
        gn=L.init_rms_norm(d_in, dev),
        out_proj=L.dense_init(generator, d_in, d))


def _split_proj(zxbcdt: torch.Tensor, cfg):
    """(z, x, B, C, dt) from the input projection."""
    d_in, H, ds, _ = dims(cfg)
    return torch.split(zxbcdt, [d_in, d_in, ds, ds, H], dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, T, C); w: (cw, C); prev: (B, cw-1,
    C)."""
    cw, T = w.shape[0], x.shape[1]
    if prev is None:
        prev = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([prev, x], dim=1)
    out = sum(xp[:, i:i + T] * w[i] for i in range(cw))
    return F.silu(out + b)


def _ssd_chunked(xh, Bc, Cc, dt, a, h0):
    """Chunked SSD.  xh: (B, T, H, dh); Bc/Cc: (B, T, ds); dt: (B, T, H)
    float32; a: (H,) negative.  Returns (y (B, T, H, dh), h_final (B, H,
    dh, ds))."""
    B, T, H, dh = xh.shape
    ds = Bc.shape[-1]
    Lc = min(CHUNK, T)
    pad = (-T) % Lc
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        Bc, Cc, dt = (F.pad(t, (0, 0, 0, pad)) for t in (Bc, Cc, dt))
    nc = (T + pad) // Lc
    xc = xh.reshape(B, nc, Lc, H, dh).transpose(0, 1)
    Bcc = Bc.reshape(B, nc, Lc, ds).transpose(0, 1)
    Ccc = Cc.reshape(B, nc, Lc, ds).transpose(0, 1)
    dtc = dt.reshape(B, nc, Lc, H).transpose(0, 1)
    cum = torch.cumsum(dtc * a, dim=2)                      # (nc,B,Lc,H)
    mask = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool,
                                 device=xh.device))[None, :, :, None]
    h, ys = h0, []
    for n in range(nc):
        x_n, B_n, C_n, dt_n, cum_n = xc[n], Bcc[n], Ccc[n], dtc[n], cum[n]
        # intra-chunk: scores[b,t,s,h] = (C_t . B_s) e^{cum_t - cum_s} dt_s
        cb = torch.einsum("bts,bms->btm", C_n, B_n)        # (B,Lc,Lc)
        decay = torch.exp(torch.clamp(
            cum_n[:, :, None, :] - cum_n[:, None, :, :], -60.0, 0.0))
        scores = cb[..., None] * decay * dt_n[:, None, :, :]
        scores = torch.where(mask, scores, 0.0)
        y_intra = torch.einsum("btsh,bshd->bthd", scores, x_n)
        # cross-chunk: y += C_t e^{cum_t} . h_in
        y_cross = torch.einsum("bts,bhds->bthd", C_n, h) * torch.exp(
            cum_n)[..., None]
        # h_out = e^{cum_L} h_in + sum_s e^{cum_L - cum_s} dt_s x_s B_s
        w_last = torch.exp(torch.clamp(cum_n[:, -1][:, None] - cum_n,
                                       -60.0, 0.0)) * dt_n  # (B,Lc,H)
        h = torch.exp(cum_n[:, -1])[..., None, None] * h + torch.einsum(
            "bshd,bsz->bhdz", w_last[..., None] * x_n, B_n)
        ys.append(y_intra + y_cross)
    y = torch.stack(ys, 1).reshape(B, nc * Lc, H, dh)
    return y[:, :T], h


def _ssd_scan(xh, Bc, Cc, dt, a, h):
    """Recurrent steps from the carried state h (B, H, dh, ds):
    h_t = e^{a dt} h + dt x_t B_t^T, y_t = h_t C_t."""
    ys = []
    for t in range(xh.shape[1]):
        decay = torch.exp(dt[:, t] * a)                     # (B,H)
        upd = torch.einsum("bhd,bs->bhds", dt[:, t, :, None] * xh[:, t],
                           Bc[:, t])
        h = decay[..., None, None] * h + upd
        ys.append(torch.einsum("bhds,bs->bhd", h, Cc[:, t]))
    return torch.stack(ys, 1), h


def layer_apply(p: Layer, x: torch.Tensor, cfg,
                state: Optional[Dict] = None) -> Tuple[torch.Tensor, Dict]:
    """x: (B, T, d).  state (decode): {"conv": (B, cw-1, ch), "h": (B, H,
    dh, ds)}.  Returns the residual stream and the new state (conv in
    bf16, as the reference casts it)."""
    B, T, d = x.shape
    d_in, H, ds, cw = dims(cfg)
    z, xin, Bc, Cc, dt = _split_proj(L.rms_norm(x, p.ln) @ p.in_proj, cfg)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    prev = state["conv"].to(conv_in.dtype) if state is not None else None
    conv_out = _causal_conv(conv_in, p.conv_w, p.conv_b, prev)
    xin = conv_out[..., :d_in]
    Bc = conv_out[..., d_in:d_in + ds].float()
    Cc = conv_out[..., d_in + ds:].float()
    dt = F.softplus(dt.float() + p.dt_bias)
    a = -torch.exp(p.A_log)
    xh = sharding.split_last(xin.float(), H, cfg.ssm.head_dim)
    if state is not None:
        y, h_final = sharding.batch_local(
            lambda xh, Bc, Cc, dt, h, a: _ssd_scan(xh, Bc, Cc, dt, a, h),
            (xh, Bc, Cc, dt, state["h"].float()), a)
    else:
        h0 = torch.zeros((B, H, cfg.ssm.head_dim, ds), dtype=torch.float32,
                         device=x.device)
        y, h_final = sharding.batch_local(
            lambda xh, Bc, Cc, dt, h, a: _ssd_chunked(xh, Bc, Cc, dt, a, h),
            (xh, Bc, Cc, dt, h0), a)
    y = y + p.D[None, None, :, None] * xh
    y = sharding.merge_last(y).to(x.dtype) * F.silu(z)
    out = sharding.constrain(L.rms_norm(y, p.gn) @ p.out_proj, "batch",
                             None, None)
    older = (prev if prev is not None else torch.zeros(
        (B, cw - 1, conv_in.shape[-1]), dtype=conv_in.dtype,
        device=x.device))
    conv_state = torch.cat([older, conv_in], dim=1)[:, -(cw - 1):]
    return x + out, {"conv": conv_state.to(L.DEFAULT_DTYPE), "h": h_final}


def state_spec(cfg, batch: int) -> Dict:
    """Shapes and dtypes of one layer's decode state."""
    d_in, H, ds, cw = dims(cfg)
    return {"conv": ((batch, cw - 1, d_in + 2 * ds), L.DEFAULT_DTYPE),
            "h": ((batch, H, cfg.ssm.head_dim, ds), torch.float32)}


def state_specs(cfg) -> Dict[str, tuple]:
    """Logical specs of :func:`state_spec`'s tensors."""
    return {"conv": ("batch", None, "model"),
            "h": ("batch", "model", None, None)}
