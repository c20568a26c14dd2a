"""Error-feedback int8 gradient compression, the counterpart of
``repro.train.compression``.

Quantizing gradients to int8 with an error-feedback residual (the
1-bit-Adam / EF-SGD family) cuts the bytes a cross-device all-reduce
carries 4x (float32) or 2x (bf16), while the residual keeps the
accumulated quantization error unbiased.  ``ef_int8_roundtrip`` is the
quantize -> dequantize round trip with the carried residual on the summed
gradient; rounding is half to even, as ``jnp.round``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .optimizer import named


def init_residual(params) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in named(params).items()}


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp_min(g.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def ef_int8_roundtrip(grads, residual) -> Tuple[Dict, Dict]:
    """Returns (dequantized grads, new residual), both keyed as ``grads``."""
    new_grads, new_res = {}, {}
    for name, g in named(grads).items():
        g32 = g.float() + residual[name]
        q, scale = _quantize(g32)
        deq = q.float() * scale
        new_grads[name] = deq.to(g.dtype)
        new_res[name] = g32 - deq
    return new_grads, new_res
