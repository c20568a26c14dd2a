"""Public wrapper over the move-score kernel.

``move_scan_frequencies`` is the kernel's wrapper: CUDA tensors go to the
kernel, CPU tensors to the plain version.  The benefit *combination* (the
block-row weighting of the frequencies) lives in one place only,
:func:`repro_torch.engine.reorg.planner.plan_migration`, on the host.
"""
from __future__ import annotations

from . import move_score

move_scan_frequencies = move_score.move_scores
