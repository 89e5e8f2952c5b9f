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

`rwmd_bound_batch` launches ``csrc/rwmd.cu`` (CUDA tensors only);
`rwmd_bound_batch_plain` is the gather + masked min + slot sum spelling of
`core.rwmd`, used for CPU tensors and as the kernel's comparison on the
card. Its final contraction `slot_dot` is shared with the LC-RWMD plain
version (`kernels.lcrwmd`), so on every device the two plain bounds are
bitwise equal, as the two kernels are.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._pad import check_tile

# v_r rows a warp can hold (4 per lane); the kernel refuses larger buckets
MAX_V_R = 128


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


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def rwmd_bound_batch(m_pad: torch.Tensor, cols: torch.Tensor,
                     vals: torch.Tensor, *, docs_blk: int = 8,
                     q_blk: int | None = None, interpret: bool = False
                     ) -> torch.Tensor:
    """CUDA min-SDDMM. m_pad (Q, v_r, V+1) f32 with +inf pad query rows,
    cols int32 / vals f32 (N, nnz) with every col in [0, V]. Returns the raw
    (Q, N) bounds. ``docs_blk`` documents per block (results do not depend
    on it). The reference's ``q_blk`` is checked (None or a positive int),
    not followed; ``interpret`` changes nothing (no interpret mode)."""
    name = "rwmd_bound_batch"
    check_tile(name, "q_blk", q_blk, optional=True)
    check_ell(name, m_pad, cols, vals, docs_blk)
    if m_pad.dim() != 3:
        raise ValueError(f"{name}: m_pad must be (Q, v_r, V+1), got "
                         f"{tuple(m_pad.shape)}")
    q, v_r, vp1 = m_pad.shape
    if not 0 < v_r <= MAX_V_R:
        raise ValueError(f"{name}: v_r = {v_r} outside (0, {MAX_V_R}]")
    n, nnz = cols.shape
    lb = torch.empty((q, n), dtype=torch.float32, device=m_pad.device)
    if q and n:
        fn = _build.function("rwmd", "rwmd_bound_batch", _ARGTYPES)
        err = fn(m_pad.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                 lb.data_ptr(), q, v_r, vp1, n, nnz, docs_blk,
                 torch.cuda.current_stream().cuda_stream)
        _build.check_launch(name, err)
    return lb
