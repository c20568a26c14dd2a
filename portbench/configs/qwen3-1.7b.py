"""Qwen3-1.7B (``qwen3-1.7b.json``) as the benchmark builds it for the port,
and its model FLOPs.  The harness finds this file by the configuration's
name; every cell of the configuration reads the model from it:

* :func:`arch_config`, :func:`make_weights`, :func:`port_params`: the
  port's ``ArchConfig``, random weights made on the device from the run's
  seed (handed to the port and to the plain reference alike), and the
  port's parameter module holding those tensors;
* :func:`vocab_size`: the token ids the traffic draws from;
* :func:`train_step_flops`, :func:`prefill_flops`: model FLOPs from the
  published widths, which the MFU readers divide by the peak.

Weights: one draw per kind of weight for all layers at once (a few large
calls), each leaf a view of its kind's draw.  Matrices are ``normal *
d_in ** -0.5`` (the embedding ``normal * 0.02``) in the served dtype;
norm scales are float32 zeros, read as ``1 + scale``.
"""
from __future__ import annotations

from typing import Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def widths(cfg: dict) -> tuple:
    return (cfg["num_hidden_layers"], cfg["hidden_size"],
            cfg["num_attention_heads"], cfg["num_key_value_heads"],
            cfg["head_dim"], cfg["intermediate_size"], cfg["vocab_size"])


def vocab_size(cfg: dict) -> int:
    return cfg["vocab_size"]


def arch_config(cfg: dict):
    """The port's ``ArchConfig``: a dense decoder with qk-norm and a gated
    SiLU MLP."""
    from repro_torch.configs.base import ArchConfig
    if cfg["hidden_act"] != "silu":
        raise ValueError(f"{cfg['hidden_act']}: only the gated SiLU MLP")
    n, d, hq, hkv, dh, ff, v = widths(cfg)
    return ArchConfig(name=cfg["name"], family="dense", n_layers=n,
                      d_model=d, n_heads=hq, n_kv_heads=hkv, d_head=dh,
                      d_ff=ff, vocab=v, act="swiglu", qk_norm=True,
                      rope_base=float(cfg["rope_theta"]),
                      source=cfg["source"])


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf by the port's parameter name."""
    n, d, hq, hkv, dh, ff, v = widths(cfg)
    dtype = DTYPES[cfg["torch_dtype"]]
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(shape, scale):
        return (torch.randn(shape, generator=g, device=device) * scale
                ).to(dtype)
    out = {"embed": draw((v, d), 0.02)}
    stacked = {"attn.wq": draw((n, d, hq * dh), d ** -0.5),
               "attn.wk": draw((n, d, hkv * dh), d ** -0.5),
               "attn.wv": draw((n, d, hkv * dh), d ** -0.5),
               "attn.wo": draw((n, hq * dh, d), (hq * dh) ** -0.5),
               "mlp.w_gate": draw((n, d, ff), d ** -0.5),
               "mlp.w_up": draw((n, d, ff), d ** -0.5),
               "mlp.w_down": draw((n, ff, d), ff ** -0.5)}
    norms = {"attn.q_norm": dh, "attn.k_norm": dh, "ln1": d, "ln2": d}
    zeros = {k: torch.zeros((n, w), dtype=torch.float32, device=device)
             for k, w in norms.items()}
    for i in range(n):
        for k, t in list(stacked.items()) + list(zeros.items()):
            out[f"layers.{i}.{k}"] = t[i]
    out["final_norm"] = torch.zeros(d, dtype=torch.float32, device=device)
    out["head"] = draw((d, v), d ** -0.5)
    return out


def port_params(w: Dict[str, torch.Tensor], cfg: dict):
    """The port's parameter module (``repro_torch.models.transformer``)
    holding the tensors of ``w`` themselves, grad off."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    def layer(i):
        p = f"layers.{i}."
        attn = L.Attention(w[p + "attn.wq"], w[p + "attn.wk"],
                           w[p + "attn.wv"], w[p + "attn.wo"],
                           w[p + "attn.q_norm"], w[p + "attn.k_norm"])
        mlp = L.MLP(w_gate=w[p + "mlp.w_gate"], w_up=w[p + "mlp.w_up"],
                    w_down=w[p + "mlp.w_down"])
        return T.Block(attn, mlp, w[p + "ln1"], w[p + "ln2"])
    return T.Transformer(w["embed"],
                         [layer(i) for i in range(cfg["num_hidden_layers"])],
                         w["final_norm"], w["head"])


def layer_matmul_params(cfg: dict) -> int:
    """Weights one decoder layer multiplies by: q, k, v, o and the gated
    MLP's gate, up and down."""
    _, d, hq, hkv, dh, ff, _ = widths(cfg)
    return d * hq * dh + 2 * d * hkv * dh + hq * dh * d + 3 * d * ff


def attention_flops(cfg: dict, batch: int, t: int) -> int:
    """Q K^T and P V of every layer's causal attention, forward."""
    n, _, hq, _, dh, _, _ = widths(cfg)
    return n * 4 * dh * hq * batch * (t * (t + 1) // 2)


def train_step_flops(cfg: dict, batch: int, t: int) -> int:
    """Model FLOPs of one training step: 6 per weight and token (forward
    and backward) for the layers and the output head, and three times the
    forward's causal attention; a recomputation is not counted."""
    n, d, _, _, _, _, v = widths(cfg)
    weights = n * layer_matmul_params(cfg) + d * v
    return 6 * weights * batch * t + 3 * attention_flops(cfg, batch, t)


def prefill_flops(cfg: dict, length: int) -> int:
    """Model FLOPs of prefilling one prompt of ``length`` tokens: 2 per
    layer weight and token, the output head at the last position, and
    the causal attention."""
    n, d, _, _, _, _, v = widths(cfg)
    return (2 * n * layer_matmul_params(cfg) * length + 2 * d * v
            + attention_flops(cfg, 1, length))
