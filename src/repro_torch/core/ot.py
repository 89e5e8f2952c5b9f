"""Generic entropy-regularized optimal transport via Sinkhorn-Knopp.

Port of `repro.core.ot`. The paper's solver is a specialization of
Cuturi's Sinkhorn distance to the 1-query-vs-N-docs WMD shape. This module
keeps the *general* (n x m) form, which the framework reuses in the MoE
**Sinkhorn router** (`models.layers.moe`): tokens x experts balanced
assignment is an OT problem with uniform expert marginals.

The fixed-count loop (``tol == 0``) reads nothing back from the device.
The early-exit loop (``tol > 0``) reads the stop test once an iteration,
and counts its iterations as the reference's ``while_loop`` does: the
first step is iteration 1, and each test compares the new scaling with
the one before it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SinkhornResult(NamedTuple):
    plan: torch.Tensor       # (n, m) transport plan P = diag(u) K diag(v)
    cost: torch.Tensor       # <P, C> transport cost (scalar)
    n_iter: torch.Tensor     # iterations actually run
    marginal_err: torch.Tensor  # |P 1 - a|_inf at exit


def sinkhorn_plan(cost: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
                  lamb: float, max_iter: int, tol: float = 0.0,
                  min_denom: float = 1e-30) -> SinkhornResult:
    """Solve min_P <P,C> - H(P)/lamb  s.t.  P 1 = a, P^T 1 = b.

    Args:
      cost: (n, m) cost matrix.
      a:    (n,) source marginal (sums to 1).
      b:    (m,) target marginal (sums to 1).
      lamb: regularization strength (larger = closer to exact OT).
      max_iter: iteration cap.
      tol:  if > 0, stop early when |u_new - u|_inf < tol.
    """
    k = torch.exp(-lamb * cost)                         # (n, m)
    n = a.shape[0]
    u = torch.full((n,), 1.0 / n, dtype=cost.dtype, device=cost.device)

    def step(u):
        v = b / torch.clamp_min(k.T @ u, min_denom)
        return a / torch.clamp_min(k @ v, min_denom)

    if tol > 0.0:
        u, u_prev, n_iter = step(u), u, 1
        while n_iter < max_iter and \
                float(torch.max(torch.abs(u - u_prev))) >= tol:
            u, u_prev, n_iter = step(u), u, n_iter + 1
    else:
        for _ in range(max_iter):
            u = step(u)
        n_iter = max_iter

    v = b / torch.clamp_min(k.T @ u, min_denom)
    plan = u[:, None] * k * v[None, :]
    return SinkhornResult(
        plan=plan,
        cost=torch.sum(plan * cost),
        n_iter=torch.tensor(n_iter, dtype=torch.int32),
        marginal_err=torch.max(torch.abs(plan.sum(dim=1) - a)),
    )


def sinkhorn_divergence(cost: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, lamb: float,
                        max_iter: int) -> torch.Tensor:
    """Scalar Sinkhorn distance <P*, C> (the d_M^lambda of the paper)."""
    return sinkhorn_plan(cost, a, b, lamb=lamb, max_iter=max_iter).cost
