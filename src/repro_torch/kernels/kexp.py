"""Fused cdist -> (K, K.*M) precompute: the CUDA kernels and their plain
version.

Port of the Pallas kernels `repro.kernels.kexp.cdist_kexp` (one query's
stripe, the per-query program's precompute, `core.distributed.masked_k`)
and `cdist_kexp_rows` (the cache-miss path of `core.kcache`): for rows
a (m, w) against the vocabulary b (V, w),

    M = sqrt(max(|a|^2 + |b|^2 - 2ab, 0))      never written
    K = exp(-lamb * M),  KM = K * M            (m, V) each

`cdist_kexp` and `cdist_kexp_rows` launch ``csrc/kexp.cu`` (CUDA tensors
only): the same pipelined tile loop and epilogue on 32 x 128 and
128 x 128 tiles, so a query's stripe is bit for bit the K-cache rows of its
words. They take the reference's tiling keywords (``v_tile``,
``rows_blk``, ``interpret``) and check them as the reference's padding
does; the CUDA tiles do not follow them, and the result depends on tiling
in neither package. `cost_rows_naive` is the tests' bitwise oracle of all
three epilogues (one thread an output, the kernels' chains, no tiling); no
path calls it. `cdist_kexp_plain` (= `cdist_kexp_rows_plain`) is the same
expansion as one fp32 matmul (`core.sinkhorn.precompute_rows` spelling),
used for CPU tensors and as the kernels' comparison on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._pad import check_tile


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
                 m, v, w, float(lamb), _build.stream(name, a, b, k, km))
        _build.check_launch(name, err)
    return k, km


def cdist_kexp_rows(a: torch.Tensor, b: torch.Tensor, *, lamb: float,
                    rows_blk: int = 8, v_tile: int = 512,
                    interpret: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA kernel: a (m, w), b (V, w) f32 contiguous -> (K, K.*M) (m, V).
    ``rows_blk`` and ``v_tile`` are checked, not followed (the kernel's
    tile is 128 x 128); the CUDA kernel has no interpret mode, so
    ``interpret`` changes nothing."""
    check_tile("cdist_kexp_rows", "rows_blk", rows_blk)
    check_tile("cdist_kexp_rows", "v_tile", v_tile)
    return _kexp("cdist_kexp_rows", a, b, lamb)


def cdist_kexp(a: torch.Tensor, b: torch.Tensor, *, lamb: float,
               v_tile: int = 512, interpret: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA kernel: one query's words a (v_r, w), b (V, w) f32 contiguous
    -> (K, K.*M) (v_r, V), each row bitwise `cdist_kexp_rows`'s. ``v_tile``
    is checked, not followed (the kernel's tile is 32 x 128); ``interpret``
    changes nothing."""
    check_tile("cdist_kexp", "v_tile", v_tile)
    return _kexp("cdist_kexp", a, b, lamb)


EPILOGUES = {"kexp": 0, "dist": 1, "dist_squared": 2}

_NAIVE_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])


def cost_rows_naive(a: torch.Tensor, b: torch.Tensor, *, epilogue: str,
                    lamb: float = 0.0) -> tuple[torch.Tensor, ...]:
    """The tests' bitwise oracle of ``csrc/kexp.cu``: one thread an output,
    the kernels' fma chains and epilogue, no tiling. ``epilogue`` "kexp"
    returns (K, K.*M) like `cdist_kexp_rows`; "dist" and "dist_squared"
    return (M,) like `cdist.cdist`. CUDA tensors, m <= 65,535."""
    name = "cost_rows_naive"
    m, w, v = check_rows(name, a, b)
    out = [torch.empty((m, v), dtype=torch.float32, device=a.device)
           for _ in range(2 if epilogue == "kexp" else 1)]
    if m and v:
        fn = _build.function("kexp", name, _NAIVE_ARGTYPES)
        err = fn(a.data_ptr(), b.data_ptr(), out[0].data_ptr(),
                 out[-1].data_ptr(), m, v, w, EPILOGUES[epilogue],
                 float(lamb), _build.stream(name, a, b, *out))
        _build.check_launch(name, err)
    return tuple(out)


def occupancy() -> dict[str, tuple[int, int]]:
    """(blocks an SM holds, dynamic shared bytes a block) of the kernels
    behind `cdist_kexp_rows`, `cdist_kexp` and `cdist.cdist`, from the CUDA
    occupancy calculator on the current card."""
    fn = _build.function("kexp", "kexp_occupancy",
                         [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    out = {}
    for which, name in enumerate(("cdist_kexp_rows", "cdist_kexp", "cdist")):
        blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
        err = fn(which, ctypes.byref(blocks), ctypes.byref(smem))
        if err != 0:
            raise RuntimeError(f"kexp_occupancy({name}) failed: cudaError "
                               f"{err}")
        out[name] = (blocks.value, smem.value)
    return out
