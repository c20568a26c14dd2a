"""Architecture and shape configuration registry: every family of the
reference (dense, MoE, VLM, audio, SSM and hybrid)."""
from repro_torch.configs.base import (SHAPES, ArchConfig, MoEConfig,
                                      ShapeConfig, SSMConfig, get_arch,
                                      list_archs, runnable_cells,
                                      skipped_cells)

__all__ = ["SHAPES", "ArchConfig", "MoEConfig", "ShapeConfig", "SSMConfig",
           "get_arch", "list_archs", "runnable_cells", "skipped_cells"]
