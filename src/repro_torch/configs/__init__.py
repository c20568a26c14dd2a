"""Architecture and shape configuration registry: every family of the
reference (dense, MoE, VLM, audio, SSM and hybrid)."""
from repro_torch.configs.base import (SHAPES, ArchConfig, MoEConfig,
                                      ShapeConfig, SSMConfig, get_arch,
                                      list_archs)

__all__ = ["SHAPES", "ArchConfig", "MoEConfig", "ShapeConfig", "SSMConfig",
           "get_arch", "list_archs"]
