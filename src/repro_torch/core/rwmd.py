"""RWMD lower bounds: the O(nnz)-per-doc prefilter of the retrieval cascade.

Port of `repro.core.rwmd`. Relaxing one marginal of the WMD transport
problem gives a per-word min over the cost matrix, a lower bound on the
distance. The bound must hold against what the engine *returns* at its
fixed iteration budget, and only the doc-side marginal is exact at every
iterate (``v`` is computed from the current ``u``), so the pruning bound is
the **doc-side RWMD**

    rwmd(q, d) = sum_s vals[d, s] * min_i M[sel_q[i], cols[d, s]]

which satisfies ``rwmd <= sinkhorn_wmd`` for every budget, impl and tol,
up to dot-product rounding that the service's ``prune_margin`` absorbs. The
classic query-side bound (`rwmd_query_side_bound`) bounds the converged
distance only; it is kept for converged-regime use and the tests.

M rows. The bound is sound only if its M is the M the engine's K.*M rows
encode. The reference has one spelling for both (`m_rows`); in the port
the K rows come from ``kexp_impl``, so `_m_row_block` takes the same value:
"kernel" computes M with `kernels.ops.cdist` (on the card the distance
epilogue of the K-row kernel, the same tile loop and M expression; on the
CPU the plain matmul spelling, which is also what the plain K rows use),
"jnp" with `core.sinkhorn.m_rows`, the spelling of `precompute_rows`.

Batched computation mirrors the K cache's word-id dedup: unique word ids
across the Q-batch, M rows once per id in fixed ``rows_bucket`` chunks (a
row's bits never depend on its chunk-mates), one slot-gather into the
(Q, v_r, V+1) stripes. Pad *query rows* gather a reserved +inf row (they
must never win the min; the K stripes' pad rows are zero instead), pad
*ELL slots* are masked by ``vals == 0``. The min-SDDMM has three
spellings: the plain one below ("fused"), the CUDA kernel
(`kernels.ops.rwmd_bound_batch`, ``impl="kernel"``) and the dense oracle
`kernels.ref.rwmd_bound_batch`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sinkhorn import m_rows
from repro_torch.core.sparse_sinkhorn import _chunk_over_docs, gather_k_batch
from repro_torch.kernels import ops
from repro_torch.kernels.rwmd import rwmd_bound_batch_plain

_BOUND_IMPLS = ("fused", "kernel")
_M_IMPLS = ("kernel", "jnp")


def _m_row_block(ids: torch.Tensor, vecs: torch.Tensor, b2: torch.Tensor,
                 *, impl: str = "kernel") -> torch.Tensor:
    """(m,) word ids -> (m, V+1) cost-matrix rows with a zero pad column,
    spelled like the service's K rows (``impl`` = its ``kexp_impl``, see
    the module docstring). Fixed-shape blocks (the caller pads to
    ``rows_bucket``) keep row bits independent of the other ids."""
    if impl not in _M_IMPLS:
        raise ValueError(f"impl must be one of {_M_IMPLS}, got {impl!r}")
    if impl == "kernel":
        m = ops.cdist(vecs[ids], vecs)
    else:
        m = m_rows(ids, vecs, b2=b2)
    return torch.nn.functional.pad(m, (0, 1))


def _gather_m_stripes(table: torch.Tensor, pos: np.ndarray) -> torch.Tensor:
    """(U+1, V+1) row table, (Q, v_r) positions -> (Q, v_r, V+1) stripes."""
    return table[torch.from_numpy(pos.astype(np.int64)).to(table.device)]


def assemble_m_stripes(sel_b: np.ndarray, row_mask: np.ndarray, vecs,
                       *, b2=None, rows_bucket: int = 128,
                       impl: str = "kernel") -> torch.Tensor:
    """Dedup a (Q, v_r) word-id batch and assemble its M stripes.

    Mirrors the K cache's transient path: unique ids once, rows in fixed
    ``rows_bucket`` chunks, one slot-gather. Pad query rows (row_mask == 0)
    gather a reserved +inf row. ``vecs`` is a (V, w) tensor (the stripes
    land on its device) or a numpy array (CPU). Returns (Q, v_r, V+1)."""
    vecs = torch.as_tensor(vecs, dtype=torch.float32)
    if b2 is None:
        b2 = torch.sum(vecs * vecs, dim=-1)
    sel_b = np.asarray(sel_b)
    ids = np.unique(sel_b)                          # sorted: stable dedup
    blocks = []
    for lo in range(0, len(ids), rows_bucket):
        chunk = ids[lo:lo + rows_bucket]
        ids_p = np.zeros(rows_bucket, np.int64)     # pad ids point at word 0
        ids_p[:len(chunk)] = chunk
        blocks.append(_m_row_block(torch.from_numpy(ids_p).to(vecs.device),
                                   vecs, b2, impl=impl))
    inf_row = torch.full((1, vecs.shape[0] + 1), float("inf"),
                         dtype=torch.float32, device=vecs.device)
    table = torch.cat(blocks + [inf_row], dim=0)
    # every block is exactly rows_bucket rows with ids packed front to back,
    # so an id's sorted position IS its table row
    pos = np.searchsorted(ids, sel_b)
    pos_b = np.where(np.asarray(row_mask) > 0, pos, table.shape[0] - 1)
    return _gather_m_stripes(table, pos_b)


def rwmd_bound_batch(m_pad: torch.Tensor, cols: torch.Tensor,
                     vals: torch.Tensor, impl: str = "kernel",
                     docs_chunk: int | None = None) -> torch.Tensor:
    """Batched doc-side RWMD lower bounds. Returns (Q, N).

    m_pad: (Q, v_r, V+1) stripes (pad query rows +inf), e.g. from
    `assemble_m_stripes`; cols / vals: the corpus ELL (N, nnz), pad col V,
    pad val 0. impl: "fused" (plain gather + masked min + slot sum) or
    "kernel" (`kernels.ops.rwmd_bound_batch`: the CUDA kernel on the card,
    the plain spelling on the CPU). docs_chunk: the plain path's doc chunks
    (bitwise equal to unchunked); the kernel sizes its own blocks (a warp a
    document, by the route its shapes pick), so the kernel route ignores
    it, as `core.cascade.lc_rwmd_bound_batch` does. Filler queries and
    empty docs score exactly 0."""
    if impl not in _BOUND_IMPLS:
        raise ValueError(f"impl must be one of {_BOUND_IMPLS}, got {impl!r}")
    if impl == "kernel":
        return ops.rwmd_bound_batch(m_pad, cols, vals)
    q, n = m_pad.shape[0], cols.shape[0]
    u_dummy = torch.zeros((q, 1, n), dtype=m_pad.dtype, device=m_pad.device)
    lb = _chunk_over_docs(
        lambda _, cols_c, vals_c: rwmd_bound_batch_plain(m_pad, cols_c,
                                                         vals_c),
        u_dummy, cols, vals, docs_chunk, pad_col=m_pad.shape[-1] - 1)
    return torch.where(torch.isfinite(lb), lb, 0.0)  # filler queries -> 0


def rwmd_query_side_bound(m_pad: torch.Tensor, r_sel: torch.Tensor,
                          cols: torch.Tensor, vals: torch.Tensor,
                          docs_chunk: int | None = None) -> torch.Tensor:
    """The classic query-side RWMD: sum_i r_i * min_{s in doc} M[i, c_s].

    A lower bound on the *converged* distance only (at a finite budget it
    can exceed the engine's output; see the module docstring). Empty docs
    score 0. Returns (Q, N)."""
    def chunk(_, cols_c, vals_c):
        mg = gather_k_batch(m_pad, cols_c)          # (Q, n_c, nnz, v_r)
        mg = torch.where(vals_c[None, :, :, None] != 0.0, mg, float("inf"))
        mins = torch.amin(mg, dim=2)                # (Q, n_c, v_r)
        mins = torch.where(torch.isfinite(mins), mins, 0.0)   # empty docs
        # the reference's einsum "qnv,qv->qn" as a product and a sum: a
        # doc's bits then do not depend on its chunk
        return torch.sum(mins * r_sel[:, None, :], dim=-1)

    q, n = m_pad.shape[0], cols.shape[0]
    u_dummy = torch.zeros((q, 1, n), dtype=m_pad.dtype, device=m_pad.device)
    lb = _chunk_over_docs(chunk, u_dummy, cols, vals, docs_chunk,
                          pad_col=m_pad.shape[-1] - 1)
    return torch.where(torch.isfinite(lb), lb, 0.0)


def rwmd_lower_bound(sel_b: np.ndarray, row_mask: np.ndarray,
                     cols: torch.Tensor, vals: torch.Tensor, vecs, *,
                     b2=None, rows_bucket: int = 128, impl: str = "kernel",
                     docs_chunk: int | None = None,
                     m_impl: str = "kernel") -> torch.Tensor:
    """Convenience composition: dedup + M stripes (``m_impl``) + batched
    bound (``impl``). Returns (Q, N) bounds on the device of ``vecs``."""
    m_pad = assemble_m_stripes(sel_b, row_mask, vecs, b2=b2,
                               rows_bucket=rows_bucket, impl=m_impl)
    return rwmd_bound_batch(m_pad, cols, vals, impl=impl,
                            docs_chunk=docs_chunk)
