"""Batched LC-RWMD sparse dot: the CUDA kernel and its plain version.

Port of the Pallas kernel `repro.kernels.lcrwmd.lc_rwmd_bound_batch`, tier
1 of the retrieval cascade. The per-vocab-word min-cost vector
``minm[q, c] = min_i M[q, i, c]`` is taken once per query outside
(`core.cascade.min_cost_vectors`), so a doc costs one sparse dot:

    lb[q, j] = sum_s vals[j, s] * minm[q, cols[j, s]]    (vals != 0)

An all-pad filler query has an all-+inf minm row and comes out +inf, which
`kernels.ops` finite-izes to 0.

`lc_rwmd_bound_batch` launches ``csrc/rwmd.cu`` (CUDA tensors only) on minm
read vocab-major, (V+1, Q); it shares its accumulation step with the min-SDDMM kernel, so the two are
bitwise equal. `lc_rwmd_bound_batch_plain` is the gather + slot sum spelling
of `core.cascade`, sharing `kernels.rwmd.slot_dot` with the min-SDDMM's
plain version for the same reason.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._pad import check_tile
from repro_torch.kernels.rwmd import check_ell, slot_dot


def lc_rwmd_bound_batch_plain(minm: torch.Tensor, cols: torch.Tensor,
                              vals: torch.Tensor) -> torch.Tensor:
    return slot_dot(minm[:, cols], vals)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def lc_rwmd_bound_batch(minm: torch.Tensor, cols: torch.Tensor,
                        vals: torch.Tensor, *, docs_blk: int | None = None,
                        q_blk: int | None = None, interpret: bool = False
                        ) -> torch.Tensor:
    """CUDA LC sparse dot. minm (Q, V+1) f32, cols int32 / vals f32
    (N, nnz) with every col in [0, V]. Returns the raw (Q, N) bounds.

    The kernel reads minm vocab-major, from ``minm.T`` (V+1, Q): free when
    minm lies so in memory, as `core.cascade.min_cost_vectors` makes it;
    a copy here otherwise. A block holds 4 warps, one document a warp at a
    time for up to 32 queries, whatever Q. ``docs_blk`` is the docs a block
    walks, rounded up to a multiple of 4 (None: 4). Results do not depend
    on it. The reference's ``q_blk`` is checked (None or a positive int),
    not followed; ``interpret`` changes nothing (no interpret mode)."""
    name = "lc_rwmd_bound_batch"
    check_tile(name, "q_blk", q_blk, optional=True)
    docs_blk = 1 if docs_blk is None else docs_blk
    if minm.dim() != 2:
        raise ValueError(f"{name}: minm must be (Q, V+1), got "
                         f"{tuple(minm.shape)}")
    minm_vm = minm.T.contiguous()            # (V+1, Q)
    check_ell(name, minm_vm, cols, vals, docs_blk)
    q = minm.shape[0]
    n, nnz = cols.shape
    lb = torch.empty((q, n), dtype=torch.float32, device=minm.device)
    if q and n:
        fn = _build.function("rwmd", name, _ARGTYPES)
        _build.check_launch(name, fn(
            minm_vm.data_ptr(), cols.data_ptr(), vals.data_ptr(),
            lb.data_ptr(), q, n, nnz, docs_blk,
            _build.stream(name, minm_vm, cols, vals, lb)))
    return lb
