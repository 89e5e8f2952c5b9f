"""The paper's Algorithm 1 / Fig. 3 -- dense Sinkhorn-WMD, and the precompute.

Port of `repro.core.sinkhorn`:

    I = (r > 0); r = r(I); M = M(I, :); K = exp(-lambda * M)
    x = ones(len(r), n_docs) / len(r)
    repeat:  u = 1/x
             v = c .* (1 / (K^T @ u))
             x = (diag(1/r) K) @ v
    u = 1/x; v = c .* (1 / (K^T @ u))
    WMD = sum(u .* ((K .* M) @ v), axis=0)

``c`` is dense here (V x N); the sparse engine is
`repro_torch.core.sparse_sinkhorn`. The dense version is the oracle.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SinkhornPrecompute(NamedTuple):
    """Iteration-invariant matrices (paper Fig. 4: ``precompute_matrices``)."""

    K: torch.Tensor         # (v_r, V) exp(-lambda * M)
    K_over_r: torch.Tensor  # (v_r, V) diag(1/r) K
    KM: torch.Tensor        # (v_r, V) K .* M
    r: torch.Tensor         # (v_r,)


def select_query(r: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side ``I = (r > 0); r = r(I)`` -- returns (sel_idx, r_sel)."""
    (sel,) = np.nonzero(np.asarray(r) > 0)
    r_sel = np.asarray(r, dtype=np.float32)[sel]
    return sel.astype(np.int32), r_sel


def m_rows(word_ids: torch.Tensor, vecs: torch.Tensor,
           *, b2: torch.Tensor | None = None) -> torch.Tensor:
    """Cost-matrix rows M[i] = |vecs[id_i] - vecs| (matmul expansion).

    ``b2`` optionally supplies precomputed per-vocab-word squared norms.
    """
    a = vecs[word_ids.long()]                                # (m, w)
    a2 = torch.sum(a * a, dim=-1)[:, None]
    if b2 is None:
        b2 = torch.sum(vecs * vecs, dim=-1)
    return torch.sqrt(torch.clamp(a2 + b2[None, :] - 2.0 * (a @ vecs.T),
                                  min=0.0))


def precompute_rows(word_ids: torch.Tensor, vecs: torch.Tensor, lamb: float,
                    *, b2: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The cacheable half of the precompute: (K, K.*M) rows keyed purely by
    (word_id, lamb). One row per requested word id."""
    m = m_rows(word_ids, vecs, b2=b2)
    k = torch.exp(-lamb * m)
    return k, k * m


def assemble_precompute(k_rows: torch.Tensor, km_rows: torch.Tensor,
                        r_sel: torch.Tensor) -> SinkhornPrecompute:
    """The per-query half: a cheap row scale over gathered rows."""
    return SinkhornPrecompute(K=k_rows, K_over_r=k_rows / r_sel[:, None],
                              KM=km_rows, r=r_sel)


def precompute(sel_idx: torch.Tensor, r_sel: torch.Tensor,
               vecs: torch.Tensor, lamb: float) -> SinkhornPrecompute:
    """M = cdist(vecs[sel], vecs); K = exp(-lamb M); K/r; K*M."""
    k, km = precompute_rows(sel_idx, vecs, lamb)
    return assemble_precompute(k, km, r_sel)


def _safe_recip(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.clamp(x, min=1e-30)


def _iterate_dense(pre: SinkhornPrecompute, c: torch.Tensor,
                   x: torch.Tensor):
    """One Sinkhorn iteration, dense formulation."""
    u = _safe_recip(x)                                  # (v_r, N)
    w = pre.K.T @ u                                     # (V, N) dense
    v = c * torch.where(c != 0.0, _safe_recip(w), 0.0)
    return pre.K_over_r @ v, v


def sinkhorn_wmd_dense(sel_idx: torch.Tensor, r_sel: torch.Tensor,
                       c: torch.Tensor, vecs: torch.Tensor, lamb: float,
                       max_iter: int) -> torch.Tensor:
    """Dense Sinkhorn-WMD of one query against N docs. Returns (N,).

    sel_idx (v_r,) int, r_sel (v_r,) f32, c (V, N) dense doc frequencies,
    vecs (V, w) embeddings; K = exp(-lamb * M), ``max_iter`` iterations.
    """
    pre = precompute(sel_idx, r_sel, vecs, lamb)
    x = torch.full((r_sel.shape[0], c.shape[1]), 1.0 / r_sel.shape[0],
                   dtype=torch.float32, device=c.device)
    for _ in range(max_iter):
        x, _ = _iterate_dense(pre, c, x)
    u = _safe_recip(x)
    w = pre.K.T @ u
    v = c * torch.where(c != 0.0, _safe_recip(w), 0.0)
    return torch.sum(u * (pre.KM @ v), dim=0)


def sinkhorn_wmd_dense_history(sel_idx: torch.Tensor, r_sel: torch.Tensor,
                               c: torch.Tensor, vecs: torch.Tensor,
                               lamb: float, max_iter: int
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Like `sinkhorn_wmd_dense` but also returns the per-iteration
    |x_t - x_{t-1}|_inf, (max_iter,), for convergence studies
    (`core.convergence`)."""
    pre = precompute(sel_idx, r_sel, vecs, lamb)
    x = torch.full((r_sel.shape[0], c.shape[1]), 1.0 / r_sel.shape[0],
                   dtype=torch.float32, device=c.device)
    deltas = []
    for _ in range(max_iter):
        x_new, _ = _iterate_dense(pre, c, x)
        deltas.append(torch.amax(torch.abs(x_new - x)))
        x = x_new
    u = _safe_recip(x)
    w = pre.K.T @ u
    v = c * torch.where(c != 0.0, _safe_recip(w), 0.0)
    hist = (torch.stack(deltas) if deltas
            else torch.zeros((0,), dtype=torch.float32, device=c.device))
    return torch.sum(u * (pre.KM @ v), dim=0), hist
