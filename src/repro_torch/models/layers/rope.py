"""Rotary position embeddings (RoPE), decode-aware (absolute positions).

Port of `repro.models.layers.rope`."""
from __future__ import annotations

import torch


def _freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)                    # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq).

    Rotates pairs (x[2i], x[2i+1]) by positions * freq_i. Computed in f32.
    """
    dtype = x.dtype
    head_dim = x.shape[-1]
    freqs = _freqs(head_dim, theta, device=x.device)
    angles = positions.to(x.device)[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]               # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., 0::2].to(torch.float32)
    x2 = x[..., 1::2].to(torch.float32)
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    out = torch.stack([r1, r2], dim=-1).reshape(x.shape)
    return out.to(dtype)
