"""Model stack: layers, the decoder-only LM, enc-dec, uniform ModelAPI."""
from repro_torch.models.registry import ModelAPI, build_model, cross_entropy

__all__ = ["ModelAPI", "build_model", "cross_entropy"]
