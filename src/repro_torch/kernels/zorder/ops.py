"""Public wrappers over the Z-order kernel.

``zorder_keys`` (the TPU kernel's float32 lane) and ``zorder_keys64`` (the
layout generator's float64, 64-bit lane) are the kernel's wrappers: CUDA
tensors go to the kernel, CPU tensors to the plain version.
"""
from __future__ import annotations

from . import zorder

zorder_keys = zorder.zorder_keys
zorder_keys64 = zorder.zorder_keys64
