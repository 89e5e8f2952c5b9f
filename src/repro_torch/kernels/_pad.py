"""The one pad-axis-to-multiple helper (port of `repro.kernels._pad`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_axis(x: torch.Tensor, axis: int, mult: int,
             value: float = 0.0) -> torch.Tensor:
    """Pad ``axis`` of ``x`` with ``value`` up to a multiple of ``mult``;
    returns ``x`` unchanged when already aligned."""
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * x.ndim            # F.pad lists the LAST axis first
    widths[2 * (x.ndim - 1 - axis % x.ndim) + 1] = pad
    return F.pad(x, widths, value=value)
