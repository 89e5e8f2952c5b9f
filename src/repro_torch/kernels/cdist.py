"""Euclidean cost-matrix rows: the CUDA kernel and its plain version.

Port of the Pallas kernel `repro.kernels.cdist.cdist`, the M-row compute of
the bound tiers (`core.rwmd._m_row_block`, `core.kcache.MCache`): for rows
a (m, w) against the vocabulary b (V, w),

    M = sqrt(max(|a|^2 + |b|^2 - 2ab, 0))      (m, V)
    squared=True: max(|a|^2 + |b|^2 - 2ab, 0)

`cdist` launches the distance epilogue of ``csrc/kexp.cu`` (CUDA tensors
only): the same tile, loop and epilogue function as
`kexp.cdist_kexp_rows`, so its M is bit for bit the M that the K-row kernel
exponentiates. It takes the reference's ``v_tile`` and ``interpret`` and
checks ``v_tile`` as the reference's padding does; the CUDA tile does not
follow it, and the result depends on tiling in neither package.
`cdist_plain` is the same expansion as one fp32 matmul, used for CPU
tensors and as the kernel's comparison on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, kexp
from repro_torch.kernels._pad import check_tile


def cdist_plain(a: torch.Tensor, b: torch.Tensor, *,
                squared: bool = False) -> torch.Tensor:
    a2 = torch.sum(a * a, dim=-1)[:, None]
    b2 = torch.sum(b * b, dim=-1)[None, :]
    d2 = torch.clamp(a2 + b2 - 2.0 * (a @ b.T), min=0.0)
    return d2 if squared else torch.sqrt(d2)


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def cdist(a: torch.Tensor, b: torch.Tensor, *, v_tile: int = 512,
          squared: bool = False, interpret: bool = False) -> torch.Tensor:
    """CUDA kernel: a (m, w), b (V, w) f32 contiguous -> M (m, V).
    ``v_tile`` is checked, not followed (the kernel's tile is 128 x 128);
    ``interpret`` changes nothing."""
    name = "cdist"
    check_tile(name, "v_tile", v_tile)
    m, w, v = kexp.check_rows(name, a, b)
    out = torch.empty((m, v), dtype=torch.float32, device=a.device)
    if m and v:
        fn = _build.function("kexp", "cdist_rows", _ARGTYPES)
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, v, w,
                 int(squared), _build.stream(name, a, b, out))
        _build.check_launch(name, err)
    return out
