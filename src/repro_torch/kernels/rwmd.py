"""Batched doc-side RWMD min-SDDMM: the CUDA kernel and its plain version.

Port of the Pallas kernel `repro.kernels.rwmd.rwmd_bound_batch`, the
bound of tier 2 of the retrieval cascade and of the bounds tier. For query
q, doc j and ELL slot s with vals[j, s] != 0:

    mn        = min_i M[q, i, cols[j, s]]      one column, min over v_r
    lb[q, j] += vals[j, s] * mn

Pad query rows carry +inf (they never win the min); pad slots are masked by
``vals == 0``, so the pad column's value is irrelevant. Both spellings
return the raw (Q, N) bounds: an all-pad filler query comes out +inf, which
`kernels.ops` finite-izes to 0.

`rwmd_bound_batch` launches ``csrc/rwmd.cu`` (CUDA tensors only) by one
of two routes that `rwmd_route` picks from the shapes alone: "dense" (the
column mins of all of M, vocab-major, then #9's walk: large document
sets, the bounds tier) or "gather" (each live slot's column read where it
lies: small ones, tier 2); both give the same bits. `rwmd_bound_batch_plain`
is the gather + masked min + slot sum spelling of `core.rwmd`, used for
CPU tensors and as the kernel's comparison on the card;
`rwmd_bound_batch_dense_plain` spells the dense route (`torch.amin`, then
the LC plain version) and is bitwise the same. Their final contraction
`slot_dot` is shared with the LC-RWMD plain version (`kernels.lcrwmd`),
so on every device the plain bounds are bitwise equal, as the kernels are.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._pad import check_tile

# v_r rows a warp can hold (4 per lane); the kernel refuses larger buckets
MAX_V_R = 128

# The dense route reads every column of M once (Q v_r (V+1) floats,
# coalesced); the gather route reads Q v_r 32-byte sectors per live slot.
# `rwmd_route` takes the dense route once the ELL's slots (pad slots
# included: a shape, not the data) reach this many per column of M. At
# paper_5k (V+1 = 100,001, nnz 144, Q = 16, v_r = 32) the gather route took
# 0.0708 ms of device time on 1,536 of the cascade's documents (2.21 slots
# a column) against the dense route's 0.0809, and 0.0986 against 0.0813 on
# 2,048 (2.95): NVIDIA H100 80GB HBM3, 700 W, scripts/bounds_ab.py.
DENSE_SLOTS_PER_COLUMN = 2.5

# Documents a block of the walk (4 warps, a document a warp): at tier 2's
# 256 documents the gather route took 0.0100 ms at docs_blk 4 against
# 0.0112 at 8 (same card, same script); bits do not depend on it.
BOUND_DOCS_BLK = 4


def slot_dot(slot_vals: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """(Q, N, nnz) per-slot values, (N, nnz) doc frequencies -> (Q, N):
    pad slots (val == 0) contribute exactly 0, whatever their value. The
    reference's einsum, spelled as a product and a sum over the slot axis:
    a doc's bits then do not depend on Q or on its doc chunk (torch's
    einsum takes other paths at other shapes)."""
    masked = torch.where(vals[None] != 0.0, slot_vals, 0.0)
    return torch.sum(masked * vals[None], dim=-1)


def rwmd_bound_batch_plain(m_pad: torch.Tensor, cols: torch.Tensor,
                           vals: torch.Tensor) -> torch.Tensor:
    mg = m_pad.transpose(1, 2)[:, cols]            # (Q, N, nnz, v_r)
    return slot_dot(torch.amin(mg, dim=-1), vals)


def rwmd_bound_batch_dense_plain(m_pad: torch.Tensor, cols: torch.Tensor,
                                 vals: torch.Tensor) -> torch.Tensor:
    """The dense route's spelling: the column mins of all of M, then the
    LC sparse dot on them; bitwise `rwmd_bound_batch_plain` (the mins are
    exact, the slot sum is `slot_dot`)."""
    return slot_dot(torch.amin(m_pad, dim=1)[:, cols], vals)


def rwmd_route(n: int, nnz: int, vp1: int) -> str:
    """The route of `rwmd_bound_batch` for N documents of nnz ELL slots
    against M stripes of V+1 columns: "dense" once the slots reach
    `DENSE_SLOTS_PER_COLUMN` per column, else "gather"."""
    return "dense" if n * nnz >= DENSE_SLOTS_PER_COLUMN * vp1 else "gather"


def check_ell(name: str, ref: torch.Tensor, cols: torch.Tensor,
              vals: torch.Tensor, docs_blk: int) -> None:
    """The argument checks the two bound kernels share."""
    dev = ref.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"{dev}")
    for arg, t, want in (("cols", cols, torch.int32),
                         ("vals", vals, torch.float32),
                         ("bounds input", ref, torch.float32)):
        if t.device != dev:
            raise ValueError(f"{name}: {arg} on {t.device}, expected {dev}")
        if t.dtype != want:
            raise TypeError(f"{name}: {arg} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if cols.dim() != 2 or vals.shape != cols.shape:
        raise ValueError(f"{name}: cols {tuple(cols.shape)} / vals "
                         f"{tuple(vals.shape)} must be one (N, nnz) shape")
    if docs_blk <= 0:
        raise ValueError(f"{name}: docs_blk must be positive, got {docs_blk}")


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_ROUTES = ("dense", "gather")


def _check_m(name: str, m_pad: torch.Tensor) -> None:
    if m_pad.dim() != 3:
        raise ValueError(f"{name}: m_pad must be (Q, v_r, V+1), got "
                         f"{tuple(m_pad.shape)}")
    if not 0 < m_pad.shape[1] <= MAX_V_R:
        raise ValueError(f"{name}: v_r = {m_pad.shape[1]} outside "
                         f"(0, {MAX_V_R}]")


def rwmd_bound_batch_route(m_pad: torch.Tensor, cols: torch.Tensor,
                           vals: torch.Tensor, route: str, *,
                           docs_blk: int = BOUND_DOCS_BLK) -> torch.Tensor:
    """`rwmd_bound_batch` by the named route ("dense" or "gather"), whatever
    the shapes: the two routes give the same bits, so this only chooses
    the time (the A/B scripts and the card tests run both)."""
    name = "rwmd_bound_batch"
    if route not in _ROUTES:
        raise ValueError(f"{name}: route must be one of {_ROUTES}, got "
                         f"{route!r}")
    check_ell(name, m_pad, cols, vals, docs_blk)
    _check_m(name, m_pad)
    q, v_r, vp1 = m_pad.shape
    n, nnz = cols.shape
    lb = torch.empty((q, n), dtype=torch.float32, device=m_pad.device)
    if q and n:
        # the dense route's column mins, vocab-major (V+1, Q)
        minm_vm = (torch.empty((vp1, q), dtype=torch.float32,
                               device=m_pad.device)
                   if route == "dense" else None)
        fn = _build.function("rwmd", name, _ARGTYPES)
        err = fn(m_pad.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                 lb.data_ptr(), None if minm_vm is None else
                 minm_vm.data_ptr(), q, v_r, vp1, n, nnz, docs_blk,
                 _build.stream(name, *(t for t in (m_pad, cols, vals, lb,
                                                   minm_vm) if t is not None)))
        _build.check_launch(name, err)
    return lb


def rwmd_bound_batch(m_pad: torch.Tensor, cols: torch.Tensor,
                     vals: torch.Tensor, *, docs_blk: int = BOUND_DOCS_BLK,
                     q_blk: int | None = None, interpret: bool = False
                     ) -> torch.Tensor:
    """CUDA min-SDDMM. m_pad (Q, v_r, V+1) f32 with +inf pad query rows,
    cols int32 / vals f32 (N, nnz) with every col in [0, V]. Returns the raw
    (Q, N) bounds, by the route `rwmd_route` picks from the shapes (one
    counted launch either way: the dense route's two kernels run in one
    call). ``docs_blk`` documents per block of the walk, rounded up to a
    multiple of 4 (results do not depend on it). The reference's ``q_blk``
    is checked (None or a positive int), not followed; ``interpret``
    changes nothing (no interpret mode)."""
    check_tile("rwmd_bound_batch", "q_blk", q_blk, optional=True)
    route = rwmd_route(cols.shape[0], cols.shape[-1], m_pad.shape[-1])
    return rwmd_bound_batch_route(m_pad, cols, vals, route,
                                  docs_blk=docs_blk)


def column_min(m_pad: torch.Tensor) -> torch.Tensor:
    """CUDA column mins of M stripes (Q, v_r, V+1) -> (Q, V+1), laid out
    vocab-major (the transpose of a contiguous (V+1, Q) tensor, as
    `core.cascade.min_cost_vectors` lays out its minm): the dense route's
    first pass alone, bitwise ``torch.amin(m_pad, dim=1)``."""
    name = "column_min"
    if m_pad.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"{m_pad.device}")
    if m_pad.dtype != torch.float32 or not m_pad.is_contiguous():
        raise TypeError(f"{name}: m_pad must be contiguous float32, got "
                        f"{m_pad.dtype}")
    _check_m(name, m_pad)
    q, v_r, vp1 = m_pad.shape
    minm_vm = torch.empty((vp1, q), dtype=torch.float32, device=m_pad.device)
    if q:
        fn = _build.function("rwmd", "rwmd_column_min",
                             [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                             + [ctypes.c_void_p])
        _build.check_launch(name, fn(
            m_pad.data_ptr(), minm_vm.data_ptr(), q, v_r, vp1,
            _build.stream(name, m_pad, minm_vm)))
    return minm_vm.T
