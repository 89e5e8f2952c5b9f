"""Public entry points of the ported kernels: dispatch by device.

Port of `repro.kernels.ops` (the batched SDDMM-SpMM and the row kexp). A
CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the kernel's plain PyTorch version. Nothing catches a
build or launch failure and falls back.

Padding rules differ from the TPU wrappers on purpose: the CUDA kernels
mask their own ragged edges (any v_r up to 128, any Q, N and nnz), so v_r,
Q and docs are not padded to tile multiples here and no (Q, v_r, V+1)
stripe is ever copied for alignment. What remains of the reference's rules
is the caller's: K carries its zero pad column (ELL pad slots gather it),
pad query rows carry r = 1 and an all-zero K row, and Q-filler queries an
all-zero K, all of which the kernels turn into exact zeros.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import kexp as _kexp
from repro_torch.kernels import sddmm_spmm as _sddmm_spmm


def sddmm_spmm_type1_batch(k_pad: torch.Tensor, r_sel: torch.Tensor,
                           u: torch.Tensor, cols: torch.Tensor,
                           vals: torch.Tensor, *,
                           docs_blk: int = 8) -> torch.Tensor:
    """Batched fused iteration body: k_pad (Q, v_r, V+1), r_sel (Q, v_r),
    u (Q, v_r, N), cols/vals (N, nnz) -> x (Q, v_r, N). ``docs_blk`` is the
    kernel's doc tile (results do not depend on it)."""
    if k_pad.is_cuda:
        return _sddmm_spmm.sddmm_spmm_type1_batch(
            k_pad.contiguous(), r_sel.contiguous(), u.contiguous(),
            cols.contiguous(), vals.contiguous(), docs_blk=docs_blk)
    return _sddmm_spmm.sddmm_spmm_type1_batch_plain(k_pad, r_sel, u, cols,
                                                    vals)


def sddmm_spmm_type2_batch(k_pad: torch.Tensor, km_pad: torch.Tensor,
                           u: torch.Tensor, cols: torch.Tensor,
                           vals: torch.Tensor, *,
                           docs_blk: int = 8) -> torch.Tensor:
    """Batched fused final distance -> (Q, N) WMD."""
    if k_pad.is_cuda:
        return _sddmm_spmm.sddmm_spmm_type2_batch(
            k_pad.contiguous(), km_pad.contiguous(), u.contiguous(),
            cols.contiguous(), vals.contiguous(), docs_blk=docs_blk)
    return _sddmm_spmm.sddmm_spmm_type2_batch_plain(k_pad, km_pad, u, cols,
                                                    vals)


def cdist_kexp_rows(a: torch.Tensor, b: torch.Tensor, *,
                    lamb: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-subset fused precompute (the cache-miss path of `core.kcache`):
    a (m, w) miss-row embeddings, b (V, w) -> (K, K.*M), each (m, V)."""
    if a.is_cuda:
        return _kexp.cdist_kexp_rows(a.contiguous(), b.contiguous(),
                                     lamb=lamb)
    return _kexp.cdist_kexp_rows_plain(a, b, lamb=lamb)
