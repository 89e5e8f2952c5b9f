"""Fused cdist -> (K, K.*M) precompute: the CUDA kernels and their plain
version.

Port of the Pallas kernels `repro.kernels.kexp.cdist_kexp` (one query's
stripe, the per-query program's precompute, `core.distributed.masked_k`)
and `cdist_kexp_rows` (the cache-miss path of `core.kcache`): for rows
a (m, w) against the vocabulary b (V, w),

    M = sqrt(max(|a|^2 + |b|^2 - 2ab, 0))      never written
    K = exp(-lamb * M),  KM = K * M            (m, V) each

`cdist_kexp` and `cdist_kexp_rows` launch ``csrc/kexp.cu`` (CUDA tensors
only): the same tile loop and epilogue on 32 x 128 and 64 x 64 tiles, so a
query's stripe is bit for bit the K-cache rows of its words.
`cdist_kexp_plain` (= `cdist_kexp_rows_plain`) is the same expansion as one
fp32 matmul (`core.sinkhorn.precompute_rows` spelling), used for CPU
tensors and as the kernels' comparison on the card.
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


# one query's stripe is a block of rows
cdist_kexp_plain = cdist_kexp_rows_plain


def check_rows(name: str, a: torch.Tensor, b: torch.Tensor
               ) -> tuple[int, int, int]:
    """Refuse what the row kernels of ``csrc/kexp.cu`` do not take; returns
    (m, w, V)."""
    for arg, t in (("a", a), ("b", b)):
        if t.device.type != "cuda" or t.device != a.device:
            raise ValueError(f"{name}: {arg} must be on a's CUDA device, got "
                             f"{t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous matrix")
    m, w = a.shape
    if b.shape[1] != w:
        raise ValueError(f"{name}: widths differ, a {tuple(a.shape)} vs b "
                         f"{tuple(b.shape)}")
    return m, w, b.shape[0]


_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
             + [ctypes.c_float, ctypes.c_void_p])


def _kexp(name: str, a: torch.Tensor, b: torch.Tensor,
          lamb: float) -> tuple[torch.Tensor, torch.Tensor]:
    m, w, v = check_rows(name, a, b)
    k = torch.empty((m, v), dtype=torch.float32, device=a.device)
    km = torch.empty_like(k)
    if m and v:
        fn = _build.function("kexp", name, _ARGTYPES)
        err = fn(a.data_ptr(), b.data_ptr(), k.data_ptr(), km.data_ptr(),
                 m, v, w, float(lamb), torch.cuda.current_stream().cuda_stream)
        _build.check_launch(name, err)
    return k, km


def cdist_kexp_rows(a: torch.Tensor, b: torch.Tensor, *,
                    lamb: float) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA kernel: a (m, w), b (V, w) f32 contiguous -> (K, K.*M) (m, V)."""
    return _kexp("cdist_kexp_rows", a, b, lamb)


def cdist_kexp(a: torch.Tensor, b: torch.Tensor, *,
               lamb: float) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA kernel: one query's words a (v_r, w), b (V, w) f32 contiguous
    -> (K, K.*M) (v_r, V), each row bitwise `cdist_kexp_rows`'s."""
    return _kexp("cdist_kexp", a, b, lamb)
