"""Fused cdist -> (K, K.*M) row precompute: the CUDA kernel and its plain
version.

Port of the Pallas kernel `repro.kernels.kexp.cdist_kexp_rows`, the cache-
miss path of `core.kcache`: for miss rows a (m, w) against the vocabulary
b (V, w),

    M = sqrt(max(|a|^2 + |b|^2 - 2ab, 0))      never written
    K = exp(-lamb * M),  KM = K * M            (m, V) each

`cdist_kexp_rows` launches ``csrc/kexp.cu`` (CUDA tensors only);
`cdist_kexp_rows_plain` is the same expansion as one fp32 matmul
(`core.sinkhorn.precompute_rows` spelling), used for CPU tensors and as the
kernel's comparison on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def cdist_kexp_rows_plain(a: torch.Tensor, b: torch.Tensor, *,
                          lamb: float) -> tuple[torch.Tensor, torch.Tensor]:
    a2 = torch.sum(a * a, dim=-1)[:, None]
    b2 = torch.sum(b * b, dim=-1)[None, :]
    m = torch.sqrt(torch.clamp(a2 + b2 - 2.0 * (a @ b.T), min=0.0))
    k = torch.exp(-lamb * m)
    return k, k * m


_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
             + [ctypes.c_float, ctypes.c_void_p])


def cdist_kexp_rows(a: torch.Tensor, b: torch.Tensor, *,
                    lamb: float) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA kernel: a (m, w), b (V, w) f32 contiguous -> (K, K.*M) (m, V)."""
    name = "cdist_kexp_rows"
    for arg, t in (("a", a), ("b", b)):
        if t.device.type != "cuda" or t.device != a.device:
            raise ValueError(f"{name}: {arg} must be on a's CUDA device, got "
                             f"{t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous matrix")
    m, w = a.shape
    v = b.shape[0]
    if b.shape[1] != w:
        raise ValueError(f"{name}: widths differ, a {tuple(a.shape)} vs b "
                         f"{tuple(b.shape)}")
    k = torch.empty((m, v), dtype=torch.float32, device=a.device)
    km = torch.empty_like(k)
    if m and v:
        fn = _build.library("kexp").cdist_kexp_rows
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        err = fn(a.data_ptr(), b.data_ptr(), k.data_ptr(), km.data_ptr(),
                 m, v, w, float(lamb), torch.cuda.current_stream().cuda_stream)
        _build.check_launch(name, err)
    return k, km
