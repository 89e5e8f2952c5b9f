"""Transportation-cost matrix: pairwise euclidean distance between embeddings.

Port of `repro.core.cost_matrix`. The paper's hotspot #2: ``M = cdist(
vecs[sel], vecs)``. The matmul expansion ``|a - b|^2 = |a|^2 + |b|^2 - 2 a.b``
routes the O(v_r * V * w) work through one fp32 matmul (full fp32: see the
precision pins in `repro_torch`); the fused kernel form with the
exponential is `repro_torch.kernels.kexp`.
"""
from __future__ import annotations

import torch


def cdist_direct(a: torch.Tensor, b: torch.Tensor, *,
                 squared: bool = False) -> torch.Tensor:
    """O(n*m*w) elementwise form: sqrt(sum((a_i - b_j)^2)). Oracle."""
    d2 = torch.sum((a[:, None, :] - b[None, :, :]) ** 2, dim=-1)
    return d2 if squared else torch.sqrt(d2)


def cdist_matmul(a: torch.Tensor, b: torch.Tensor, *,
                 squared: bool = False) -> torch.Tensor:
    """Matmul form: |a|^2 + |b|^2 - 2ab, clamped at 0 for fp round-off."""
    a2 = torch.sum(a * a, dim=-1)[:, None]
    b2 = torch.sum(b * b, dim=-1)[None, :]
    d2 = torch.clamp(a2 + b2 - 2.0 * (a @ b.T), min=0.0)
    return d2 if squared else torch.sqrt(d2)


def cdist(a: torch.Tensor, b: torch.Tensor, *, squared: bool = False,
          method: str = "matmul") -> torch.Tensor:
    """Pairwise euclidean distance. a: (n, w), b: (m, w) -> (n, m)."""
    if method == "matmul":
        return cdist_matmul(a, b, squared=squared)
    if method == "direct":
        return cdist_direct(a, b, squared=squared)
    raise ValueError(f"unknown cdist method: {method!r}")
