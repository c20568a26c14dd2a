"""Model zoo of the port: the decoder-only transformer (dense, MoE, VLM,
audio)."""
from repro_torch.models import factory, layers, losses, transformer
from repro_torch.models.factory import ModelBundle, build_model

__all__ = ["ModelBundle", "build_model", "factory", "layers", "losses",
           "transformer"]
