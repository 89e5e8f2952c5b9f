"""Random initialisation on the generator's device, one tensor at a time."""
from __future__ import annotations

import torch


def normal(key: torch.Generator, shape, scale: float,
           dtype=torch.float32) -> torch.Tensor:
    """N(0, scale^2) samples of ``shape`` made in place on ``key``'s device
    (no temporary of the tensor's size)."""
    return torch.empty(tuple(shape), dtype=dtype,
                       device=key.device).normal_(0.0, scale, generator=key)
