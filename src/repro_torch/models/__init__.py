"""Model zoo of the port: the decoder-only transformer (dense, MoE, VLM,
audio), RWKV-6 (SSM) and the Mamba-2 hybrid with shared attention, with
logical sharding specs."""
from repro_torch.models import (factory, hybrid, layers, losses, mamba2,
                                rwkv6, sharding, transformer)
from repro_torch.models.factory import ModelBundle, build_model, input_specs

__all__ = ["ModelBundle", "build_model", "input_specs", "factory", "hybrid",
           "layers", "losses", "mamba2", "rwkv6", "sharding", "transformer"]
