"""Convergence-monitored Sinkhorn solves ("while x changes" done properly).

Port of `repro.core.convergence`. The paper (section III-B1) notes the
ideal loop runs "as long as there is any change in the output" but uses a
fixed ``max_iter`` cutoff in practice. These solvers stop on the relative
iterate delta max|x_t - x_{t-1}| / (|x_{t-1}| + 1e-30) < ``tol`` (x spans a
huge dynamic range, so an absolute norm would never cross ``tol`` for a
strongly regularized K):

  * `sinkhorn_wmd_converged` -- one query, the fused plain spelling (as
    the reference's while-loop); one host sync per iteration for the test;
  * `sinkhorn_wmd_converged_batch` -- Q queries through the shared
    `sparse_sinkhorn.batched_sinkhorn_loop`, a converged query frozen while
    the others iterate; ``impl`` from the solvers' one table ("kernel" runs
    the batched CUDA kernels on the card). ``docs_chunk`` is per-op (inside
    each iteration), because the freeze masks and the reported n_iter and
    delta are defined over the full doc axis.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.sinkhorn import precompute
from repro_torch.core.sparse_sinkhorn import (batched_contractions,
                                              batched_sinkhorn_loop, pad_k,
                                              precompute_batch, safe_recip,
                                              sddmm_spmm_type1,
                                              sddmm_spmm_type2)


class ConvergedWMD(NamedTuple):
    wmd: torch.Tensor     # (N,) distances
    n_iter: torch.Tensor  # () iterations actually executed
    delta: torch.Tensor   # () final relative |dx|_inf


def sinkhorn_wmd_converged(sel_idx: torch.Tensor, r_sel: torch.Tensor,
                           cols: torch.Tensor, vals: torch.Tensor,
                           vecs: torch.Tensor, lamb: float, max_iter: int,
                           tol: float = 1e-6) -> ConvergedWMD:
    """Sparse fused Sinkhorn-WMD of one query with early exit once the
    relative iterate delta drops below ``tol`` (or at ``max_iter``)."""
    pre = precompute(sel_idx, r_sel, vecs, lamb)
    k_pad = pad_k(pre.K)
    km_pad = pad_k(pre.KM)
    v_r = r_sel.shape[0]
    x = torch.full((v_r, cols.shape[0]), 1.0 / v_r, dtype=pre.K.dtype,
                   device=pre.K.device)
    delta = torch.tensor(float("inf"), device=x.device)
    n_iter = 0
    while n_iter < max_iter and bool(delta >= tol):
        x_new = sddmm_spmm_type1(k_pad, pre.r, safe_recip(x), cols, vals)
        delta = torch.amax(torch.abs(x_new - x) / (torch.abs(x) + 1e-30))
        x, n_iter = x_new, n_iter + 1
    wmd = sddmm_spmm_type2(k_pad, km_pad, safe_recip(x), cols, vals)
    return ConvergedWMD(wmd=wmd, n_iter=torch.tensor(n_iter), delta=delta)


class BatchConvergedWMD(NamedTuple):
    wmd: torch.Tensor     # (Q, N) distances
    n_iter: torch.Tensor  # (Q,) iterations each query actually ran
    delta: torch.Tensor   # (Q,) final per-query relative |dx|_inf


def sinkhorn_wmd_converged_batch(sel_idx: torch.Tensor, r_sel: torch.Tensor,
                                 cols: torch.Tensor, vals: torch.Tensor,
                                 vecs: torch.Tensor, lamb: float,
                                 max_iter: int, tol: float = 1e-6,
                                 row_mask: torch.Tensor | None = None,
                                 impl: str = "kernel",
                                 docs_chunk: int | None = None
                                 ) -> BatchConvergedWMD:
    """Batched early-exit solve with per-query convergence masking.

    sel_idx / r_sel / row_mask (Q, v_r) bucketed queries
    (`core.distributed.pad_query_batch`). A query whose relative delta
    drops below ``tol`` keeps its x unchanged while the others iterate;
    freezing is exact, because queries never interact.
    """
    pre = precompute_batch(sel_idx, r_sel, vecs, lamb, row_mask)
    k_pad = pad_k(pre.K)
    km_pad = pad_k(pre.KM)
    q, v_r = r_sel.shape
    type1, type2 = batched_contractions(impl, k_pad, km_pad)
    x0 = torch.full((q, v_r, cols.shape[0]), 1.0 / v_r, dtype=pre.K.dtype,
                    device=pre.K.device)

    def iteration(x):
        return type1(k_pad, pre.r, safe_recip(x), cols, vals,
                     docs_chunk=docs_chunk)

    x, delta, n_iter = batched_sinkhorn_loop(iteration, x0,
                                             max_iter=max_iter, tol=tol)
    wmd = type2(k_pad, km_pad, safe_recip(x), cols, vals,
                docs_chunk=docs_chunk)
    return BatchConvergedWMD(wmd=wmd, n_iter=n_iter, delta=delta)
