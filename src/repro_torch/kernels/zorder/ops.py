"""Public wrappers over the Z-order kernel.

``zorder_keys`` (the TPU kernel's float32 lane), ``zorder_keys64`` (the
layout generator's float64, 64-bit lane) and ``zorder_route64`` (that
lane's keys routed to partition ids in the same pass) are the kernel's
wrappers: CUDA tensors go to the kernel, CPU tensors to the plain version.
"""
from __future__ import annotations

from . import zorder

zorder_keys = zorder.zorder_keys
zorder_keys64 = zorder.zorder_keys64
zorder_route64 = zorder.zorder_route64
