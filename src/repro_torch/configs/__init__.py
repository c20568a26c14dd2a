"""Architecture and shape configuration registry (dense, MoE, VLM and
audio families)."""
from repro_torch.configs.base import (LATER_ARCHS, LATER_FAMILIES, SHAPES,
                                      ArchConfig, MoEConfig, ShapeConfig,
                                      SSMConfig, get_arch, list_archs)

__all__ = ["LATER_ARCHS", "LATER_FAMILIES", "SHAPES", "ArchConfig",
           "MoEConfig", "ShapeConfig", "SSMConfig", "get_arch",
           "list_archs"]
