"""OREO on PyTorch and CUDA: the port of the ``repro`` package.

The layout mirrors ``repro`` (``core``, ``engine``, ``kernels``, ``data``),
with the same module and class names.  Host control logic (D-UMTS, the
samplers, the layout manager, the policies) is carried over line for line
and draws from numpy generators seeded as in ``repro``, so traces compare
bit for bit.  Tables and zone maps are tensors on an explicit device: the
card unless a caller passes ``device="cpu"``.
"""
