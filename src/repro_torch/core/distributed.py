"""Query padding and the solver programs (per query and batched), on one
device.

Port of the single-device part of `repro.core.distributed`. The reference
builds shard_map programs over a (data, model) mesh with one psum over the
vocab shards per iteration; this port runs on one GPU, so the vocab axis
has one shard (S = 1) and the psum is the identity. The argument shapes
are kept: ELL and stripes carry the leading S = 1 shard axis
(`core.formats.rebucket_for_vocab_shards(ell, 1)`, `core.kcache`).

Query padding is exact and mask-based: pad rows carry r = 1 and an
all-zero K row (`pad_query` + the row mask in `masked_k` /
`masked_k_batch`), so they contribute exactly zero to every w, x and WMD.

`build_wmd_fn` is the per-query program (`WMDService.query`): the query's
stripe precompute (``kexp_impl``), ``max_iter`` type1 iterations and the
type2 distance. With ``use_kernel`` and ``kexp_impl="kernel"`` on the card
it launches kernels #5, the vocab-major copy of the query's K stripe
(once), #1 (``max_iter`` times) and #2, and its distances are bit for bit
those the batched kernel route gives the same query.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core import sparse_sinkhorn as ss
from repro_torch.core.cost_matrix import cdist
from repro_torch.core.sparse_sinkhorn import pad_k, safe_recip


def pad_query(sel_idx: np.ndarray, r_sel: np.ndarray, v_r_target: int
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad a query to a bucket size. Returns (sel_idx, r_sel, row_mask).

    Pad rows point at word 0 with r = 1.0; the row mask zeroes their K rows
    so they contribute nothing anywhere.
    """
    v_r = sel_idx.shape[0]
    if v_r > v_r_target:
        raise ValueError(f"query v_r {v_r} exceeds bucket {v_r_target}")
    pad = v_r_target - v_r
    sel_p = np.concatenate([sel_idx, np.zeros(pad, sel_idx.dtype)])
    r_p = np.concatenate([r_sel.astype(np.float32), np.ones(pad, np.float32)])
    mask = np.concatenate([np.ones(v_r, np.float32), np.zeros(pad, np.float32)])
    return sel_p, r_p, mask


def pad_query_batch(sels: Sequence[np.ndarray], rs: Sequence[np.ndarray],
                    v_r_target: int
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bucket Q mixed-size queries to a common v_r. Returns (Q, v_r) arrays
    (sel_idx, r_sel, row_mask) -- each query padded by `pad_query`."""
    padded = [pad_query(s, r, v_r_target) for s, r in zip(sels, rs)]
    return (np.stack([p[0] for p in padded]),
            np.stack([p[1] for p in padded]),
            np.stack([p[2] for p in padded]))


def masked_k(vecs_sel: torch.Tensor, vecs_loc: torch.Tensor, lamb: float,
             row_mask: torch.Tensor, kexp_impl: str = "kernel"
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One query's stripes: (v_r, w) query words -> (v_r, Vloc) K, K.*M with
    pad query rows zeroed. ``kexp_impl="kernel"``: `kernels.ops.cdist_kexp`
    (the CUDA kernel on the card), then the row mask -- for a mask of 0 / 1
    (K.*M) * mask == (K * mask) * M, the reference's order; ``"jnp"``: the
    matmul spelling of `core.cost_matrix.cdist`, as the reference leaves
    it to XLA."""
    mask = row_mask[:, None]
    if kexp_impl == "kernel":
        from repro_torch.kernels import ops
        k, km = ops.cdist_kexp(vecs_sel, vecs_loc, lamb=lamb)
        return k * mask, km * mask
    if kexp_impl != "jnp":
        raise ValueError(f"kexp_impl must be 'jnp' or 'kernel', got "
                         f"{kexp_impl!r}")
    m = cdist(vecs_sel, vecs_loc)
    k = torch.exp(-lamb * m) * mask
    return k, k * m


def masked_k_batch(vecs_sel: torch.Tensor, vecs_loc: torch.Tensor,
                   lamb: float, row_mask: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched stripes: (Q, v_r, w) queries -> (Q, v_r, Vloc) K, K.*M, with
    pad query rows zeroed. A full-fp32 matmul outside any kernel, as the
    reference leaves it to XLA."""
    m = torch.stack([cdist(a, vecs_loc) for a in vecs_sel])
    k = torch.exp(-lamb * m) * row_mask[..., None]
    return k, k * m


def _local_solve(vecs_sel, r_sel, row_mask, vecs_loc, cols_loc, vals_loc, *,
                 lamb: float, max_iter: int, use_kernel: bool,
                 kexp_impl: str) -> torch.Tensor:
    """The per-query program on its doc slice and vocab stripe (here all of
    both). Returns the (N_local,) WMD. As in the reference, the type1
    contraction runs with r = 1 and the 1/r row scale follows it, where the
    vocab psum sits (the identity at S = 1); acc / 1 is exact, so this is
    bitwise the same as dividing inside."""
    k, km = masked_k(vecs_sel, vecs_loc, lamb, row_mask, kexp_impl)
    k_pad, km_pad = pad_k(k), pad_k(km)
    v_r = r_sel.shape[0]
    ones_r = torch.ones_like(r_sel)
    type1, type2 = ss.query_contractions(
        "kernel" if use_kernel else "fused", k_pad, km_pad)
    x = torch.full((v_r, cols_loc.shape[0]), 1.0 / v_r, dtype=k.dtype,
                   device=k.device)
    for _ in range(max_iter):
        x = type1(k_pad, ones_r, safe_recip(x), cols_loc, vals_loc) \
            / r_sel[:, None]
    return type2(k_pad, km_pad, safe_recip(x), cols_loc, vals_loc)


def build_wmd_fn(*, lamb: float, max_iter: int, use_kernel: bool = False,
                 kexp_impl: str = "kernel"):
    """The per-query WMD solver.

    The returned fn takes (vecs_sel, r_sel, row_mask, vecs, cols_b, vals_b):
      vecs_sel (v_r, w) query word embeddings (`pad_query` rows),
      r_sel (v_r,) (pad rows = 1.0), row_mask (v_r,) (pad rows = 0.0),
      vecs (V, w), cols_b / vals_b (1, N, nnz) -- the rebucketed ELL, S = 1
    and returns wmd (N,). ``use_kernel`` keeps the reference's name: the
    type1 / type2 contractions through `kernels.ops` (the CUDA kernels for
    CUDA tensors), else the fused plain spelling. ``kexp_impl`` chooses the
    stripe precompute (`masked_k`).
    """
    def fn(vecs_sel, r_sel, row_mask, vecs, cols_b, vals_b):
        return _local_solve(vecs_sel, r_sel, row_mask, vecs, cols_b[0],
                            vals_b[0], lamb=lamb, max_iter=max_iter,
                            use_kernel=use_kernel, kexp_impl=kexp_impl)

    return fn


def _check_placement(chunk_placement: str) -> None:
    if chunk_placement not in ("solve", "iteration"):
        raise ValueError(f"chunk_placement must be 'solve' or 'iteration', "
                         f"got {chunk_placement!r}")


def _local_batched_solve(k_pad, km_pad, r_sel, cols_loc, vals_loc, *,
                         max_iter: int, impl: str, docs_chunk: int | None,
                         chunk_placement: str, tol: float, vm=None):
    """Batched Sinkhorn solve on (Q, v_r, V+1) stripes. Returns (wmd,
    n_iter, delta). ``vm``: the kernel route's vocab-major copies of k_pad
    and km_pad when the caller made them (`vocab_major_stripes`); else they
    are made here, once for every chunk and iteration.

    ``chunk_placement="solve"`` runs the chunk loop outside the Sinkhorn
    loop (each (query, chunk) block freezes at its own convergence; n_iter
    and delta are per-query maxima over chunks); ``"iteration"`` chunks each
    contraction inside the iteration-major loop. As in the reference, the
    type1 contraction runs with r = 1 and the 1/r row scale follows it
    (where the reference's psum sits).
    """
    q, v_r = r_sel.shape
    ones_r = torch.ones_like(r_sel)
    type1, type2 = ss.batched_contractions(impl, k_pad, km_pad, vm)
    iter_chunk = docs_chunk if chunk_placement == "iteration" else None

    def solve_chunk(x0_c, cols_c, vals_c):
        def iteration(x):
            x_part = type1(k_pad, ones_r, safe_recip(x), cols_c, vals_c,
                           docs_chunk=iter_chunk)
            return x_part / r_sel[:, :, None]

        if tol:
            x, delta, n_iter = ss.batched_sinkhorn_loop(
                iteration, x0_c, max_iter=max_iter, tol=tol)
        else:
            x = x0_c
            for _ in range(max_iter):
                x = iteration(x)
            delta = torch.zeros((q,), dtype=x0_c.dtype, device=x0_c.device)
            n_iter = torch.full((q,), max_iter, dtype=torch.int32,
                                device=x0_c.device)
        wmd = type2(k_pad, km_pad, safe_recip(x), cols_c, vals_c,
                    docs_chunk=iter_chunk)
        return wmd, n_iter, delta

    n_loc = cols_loc.shape[0]
    x0 = torch.full((q, v_r, n_loc), 1.0 / v_r, dtype=k_pad.dtype,
                    device=k_pad.device)
    if chunk_placement == "solve" and docs_chunk and docs_chunk < n_loc:
        parts = [solve_chunk(x0[:, :, s:s + docs_chunk],
                             cols_loc[s:s + docs_chunk],
                             vals_loc[s:s + docs_chunk])
                 for s in range(0, n_loc, docs_chunk)]
        wmd = torch.cat([p[0] for p in parts], dim=-1)
        n_iter = torch.amax(torch.stack([p[1] for p in parts]), dim=0)
        delta = torch.amax(torch.stack([p[2] for p in parts]), dim=0)
        return wmd, n_iter, delta
    return solve_chunk(x0, cols_loc, vals_loc)


def build_wmd_batch_fn(*, lamb: float, max_iter: int, impl: str = "kernel",
                       docs_chunk: int | None = None,
                       chunk_placement: str = "solve", tol: float = 0.0,
                       with_info: bool = False):
    """The batched WMD solver with the precompute inside the program.

    The returned fn takes (vecs_sel, r_sel, row_mask, vecs, cols_b, vals_b):
      vecs_sel (Q, v_r, w), r_sel (Q, v_r) (pad rows = 1.0),
      row_mask (Q, v_r) (pad rows = 0.0), vecs (V, w),
      cols_b / vals_b (1, N, nnz) -- the rebucketed ELL, S = 1
    and returns wmd (Q, N), or (wmd, n_iter (Q,), delta (Q,)) with
    ``with_info=True``.
    """
    _check_placement(chunk_placement)

    def fn(vecs_sel, r_sel, row_mask, vecs, cols_b, vals_b):
        k, km = masked_k_batch(vecs_sel, vecs, lamb, row_mask)
        out = _local_batched_solve(
            pad_k(k), pad_k(km), r_sel, cols_b[0], vals_b[0],
            max_iter=max_iter, impl=impl, docs_chunk=docs_chunk,
            chunk_placement=chunk_placement, tol=tol)
        return out if with_info else out[0]

    return fn


def build_wmd_batch_fn_stripes(*, max_iter: int, impl: str = "kernel",
                               docs_chunk: int | None = None,
                               chunk_placement: str = "solve",
                               tol: float = 0.0, with_info: bool = False):
    """The batched WMD solver on preassembled stripes (`core.kcache`).

    The returned fn takes (k_b, km_b, r_sel, cols_b, vals_b, vm=None):
      k_b, km_b (1, Q, v_r, V+1) stripes (zero pad column, pad rows zeroed),
      r_sel (Q, v_r), cols_b / vals_b (1, N, nnz), vm the
      `vocab_major_stripes` of k_b, km_b (a caller that runs several
      programs on one stripe set makes them once; None: the program does)
    and returns wmd (Q, N) (plus (n_iter, delta) with ``with_info=True``).
    No ``lamb``: it is baked into the cached rows.
    """
    _check_placement(chunk_placement)

    def fn(k_b, km_b, r_sel, cols_b, vals_b, vm=None):
        out = _local_batched_solve(
            k_b[0], km_b[0], r_sel, cols_b[0], vals_b[0],
            max_iter=max_iter, impl=impl, docs_chunk=docs_chunk,
            chunk_placement=chunk_placement, tol=tol, vm=vm)
        return out if with_info else out[0]

    return fn


def vocab_major_stripes(k_b: torch.Tensor, km_b: torch.Tensor, impl: str):
    """The vocab-major copies (k_vm, km_vm), each (Q, V+1, v_r), of the
    (1, Q, v_r, V+1) K and K.*M stripes that the kernel route's type1 and
    type2 read, or None for the plain impls (they read the stripes as they
    are)."""
    if impl != "kernel":
        return None
    return ss.vocab_major_pair(k_b[0], km_b[0])
