"""Public wrapper over the fused decision kernel.

``fused_decision`` is the kernel's wrapper: CUDA tensors go to the kernel,
CPU tensors to the plain version.  The engine reads ``scan`` (copied back
and reduced on the host, see :mod:`repro_torch.engine.compute`); ``cost``
is the kernel's own device reduction and ``freq`` the reorganization
planner's ordering signal.
"""
from __future__ import annotations

from . import decision_fused

fused_decision = decision_fused.fused_decision
