"""Naive dense oracles for the ported kernels (port of `repro.kernels.ref`).

Written in the most transparent form possible (dense materialization +
masking; no gather, no fusion) so they are independent of both the CUDA
kernels and the plain gather spellings. Kernel tests assert a three-way
agreement: kernel (or its plain version) == reference ops == this oracle.
"""
from __future__ import annotations

import torch

TINY = 1e-30


def _ell_to_dense(cols: torch.Tensor, vals: torch.Tensor,
                  num_vocab: int) -> torch.Tensor:
    """(N, nnz) ELL -> (V, N) dense, dropping pad slots (col == V)."""
    one_hot = torch.nn.functional.one_hot(cols.long(), num_vocab + 1)
    dense = torch.einsum("nkv,nk->vn", one_hot.to(vals.dtype), vals)
    return dense[:num_vocab]


def _sampled_inverse_product(k_pad, u, cols, vals):
    """Dense SDDMM: full K^T @ u then mask to the sparsity pattern of c."""
    num_vocab = k_pad.shape[1] - 1
    c = _ell_to_dense(cols, vals, num_vocab)                  # (V, N)
    w = k_pad[:, :-1].T @ u                                   # (V, N)
    return torch.where(c != 0.0, c / torch.clamp(w, min=TINY), 0.0)


def sddmm_spmm_type1(k_pad, r_sel, u, cols, vals):
    """Oracle: dense w = K^T u; v = c/w (on support); x = (K/r) v."""
    v = _sampled_inverse_product(k_pad, u, cols, vals)
    return (k_pad[:, :-1] @ v) / r_sel[:, None]


def sddmm_spmm_type2(k_pad, km_pad, u, cols, vals):
    v = _sampled_inverse_product(k_pad, u, cols, vals)
    return torch.sum(u * (km_pad[:, :-1] @ v), dim=0)


def sddmm_spmm_type1_batch(k_pad, r_sel, u, cols, vals):
    """Batched oracle: the single-query oracle looped over the Q axis --
    blind to the shared-gather structure of the real paths."""
    return torch.stack([sddmm_spmm_type1(k, r, uu, cols, vals)
                        for k, r, uu in zip(k_pad, r_sel, u)])


def sddmm_spmm_type2_batch(k_pad, km_pad, u, cols, vals):
    return torch.stack([sddmm_spmm_type2(k, km, uu, cols, vals)
                        for k, km, uu in zip(k_pad, km_pad, u)])


def rwmd_bound_batch(m_pad, cols, vals):
    """Oracle for the doc-side RWMD min-SDDMM: densify the ELL, take the
    per-vocab-word min over query rows of the full M stripe, and contract
    with the dense doc frequencies -- no gather, no slot loop. Pad query
    rows carry +inf (never win the min); all-pad filler queries come out
    inf/NaN and are finite-ized to 0, as on the production paths."""
    num_vocab = m_pad.shape[-1] - 1
    c = _ell_to_dense(cols, vals, num_vocab)                  # (V, N)
    mins = torch.amin(m_pad[:, :, :num_vocab], dim=1)         # (Q, V)
    lb = torch.einsum("qv,vn->qn", mins, c)
    return torch.where(torch.isfinite(lb), lb, 0.0)


def lc_rwmd_bound_batch(minm, cols, vals):
    """Oracle for the LC-RWMD sparse dot: the (Q, V) min-cost vectors
    against the densified ELL as one dense matmul."""
    num_vocab = minm.shape[-1] - 1
    c = _ell_to_dense(cols, vals, num_vocab)                  # (V, N)
    lb = minm[:, :num_vocab] @ c
    return torch.where(torch.isfinite(lb), lb, 0.0)


def cdist(a, b, *, squared: bool = False):
    """Oracle: direct elementwise |a_i - b_j|."""
    d2 = torch.sum((a[:, None, :] - b[None, :, :]) ** 2, dim=-1)
    return d2 if squared else torch.sqrt(d2)


def cdist_kexp(a, b, *, lamb: float):
    m = cdist(a, b)
    k = torch.exp(-lamb * m)
    return k, k * m
