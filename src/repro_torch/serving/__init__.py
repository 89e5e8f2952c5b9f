"""The batched Sinkhorn-WMD query service."""
from repro_torch.serving.wmd_service import WMDService

__all__ = ["WMDService"]
