"""Model zoo of the port: the dense decoder-only transformer so far."""
from repro_torch.models import factory, layers, losses, transformer
from repro_torch.models.factory import ModelBundle, build_model

__all__ = ["ModelBundle", "build_model", "factory", "layers", "losses",
           "transformer"]
