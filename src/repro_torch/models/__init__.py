"""Model zoo of the port: the decoder-only transformer (dense, MoE, VLM,
audio), RWKV-6 (SSM) and the Mamba-2 hybrid with shared attention."""
from repro_torch.models import (factory, hybrid, layers, losses, mamba2,
                                rwkv6, transformer)
from repro_torch.models.factory import ModelBundle, build_model

__all__ = ["ModelBundle", "build_model", "factory", "hybrid", "layers",
           "losses", "mamba2", "rwkv6", "transformer"]
