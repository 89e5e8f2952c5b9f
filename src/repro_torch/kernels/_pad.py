"""The one pad-axis-to-multiple helper (port of `repro.kernels._pad`) and
the check of the reference's tiling keywords."""
from __future__ import annotations

import numbers

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


def check_tile(name: str, key: str, value, *, optional: bool = False
               ) -> None:
    """Refuse a tiling keyword of the reference's signature (``v_tile``,
    ``rows_blk``, ``q_blk``) that the reference's padding refuses: it must
    be a positive int (or None where ``optional``: the reference's
    ``q_blk=None``, min(Q, 8)). The port's kernels choose their own tiles
    and their results do not depend on tiling, so a valid value changes
    nothing."""
    if value is None and optional:
        return
    if not isinstance(value, numbers.Integral):
        raise TypeError(f"{name}: {key} must be a positive int, got "
                        f"{value!r}")
    if value <= 0:
        raise ValueError(f"{name}: {key} must be positive, got {value}")
