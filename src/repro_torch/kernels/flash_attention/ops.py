"""GQA-aware attention over the reference's ``(B, T, H, dh)`` layout.

``attention`` keeps the signature of ``repro.kernels.flash_attention.ops
.attention`` without its ``use_kernel`` switch and block sizes: the
wrapper launches the CUDA kernel on CUDA tensors and runs the plain
version on CPU tensors.  The kernel maps query head ``h`` to kv head
``h // g`` itself, so nothing repeats the kv heads.
"""
from __future__ import annotations

import torch

from . import flash_attention as fa


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, prefix_len: int = 0) -> torch.Tensor:
    """q: (B, T, Hq, dh); k, v: (B, S, Hkv, dh) -> (B, T, Hq, dh)."""
    return fa.flash_attention(q, k, v, causal=causal, prefix_len=prefix_len)
