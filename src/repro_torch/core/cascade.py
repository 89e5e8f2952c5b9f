"""Tier-0 centroid screen + LC-RWMD: the cheap front of the retrieval cascade.

Port of `repro.core.cascade`.

Tier 0 -- centroid screen (Werner & Laber). With ``z`` the r-weighted
query centroid, ``R = max_i ||x_i - z||`` over the query's real words and
the doc moments ``g_d = sum_s vals[d,s] * y_s``, ``m_d = sum_s vals[d,s]``,
the triangle inequality and Jensen give

    rwmd(q, d) >= || g_d - m_d z || - m_d R

so ``max(0, ||g_d - m_d z|| - m_d R)`` lower-bounds the doc-side RWMD, and
hence the engine's distance at every iteration budget. The norm expansion
makes the screen one (Q, dim) x (dim, N) fp32 matmul plus rank-1 terms. It
has no TPU kernel in the reference and stays PyTorch here.

Tier 1 -- LC-RWMD (Atasu et al.). The doc-side RWMD's inner min depends on
(query, vocab word) only: ``minm[q, c] = min_i m_pad[q, i, c]`` is taken
once per query, then every doc costs one sparse dot over its slots. The
value is the doc-side RWMD's, down to the bit (the same min over the same
floats, and the same accumulation in every spelling, see
`kernels.rwmd.slot_dot` and ``kernels/csrc/rwmd.cu``). Three spellings: the
plain one ("fused"), the CUDA kernel (`kernels.ops.lc_rwmd_bound_batch`,
``impl="kernel"``) and the dense oracle `kernels.ref.lc_rwmd_bound_batch`.

Pad conventions are those of `core.rwmd.assemble_m_stripes`: pad query rows
carry +inf (an all-pad filler query's minm is +inf and its bounds
finite-ize to 0), pad ELL slots are masked by ``vals == 0``, empty docs and
filler queries score exactly 0 -- a 0 bound never prunes them.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse_sinkhorn import _chunk_over_docs
from repro_torch.kernels import ops
from repro_torch.kernels.lcrwmd import lc_rwmd_bound_batch_plain

_LC_IMPLS = ("fused", "kernel")

TINY = 1e-30


def doc_centroids(cols: torch.Tensor, vals: torch.Tensor,
                  vecs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-doc moments for the tier-0 screen: (g, m) = (sum vals*y, sum vals).

    cols / vals: corpus ELL (N, nnz), pad col V, pad val 0. The vocab table
    gets a zero pad row, so pad slots add nothing to either moment.
    Accumulated slot by slot (O(N * dim) live memory, never the
    (N, nnz, dim) gather). Empty docs give g = 0, m = 0."""
    vp = torch.cat([vecs, torch.zeros((1, vecs.shape[1]), dtype=vecs.dtype,
                                      device=vecs.device)])
    n, nnz = cols.shape
    g = torch.zeros((n, vecs.shape[1]), dtype=vecs.dtype, device=vecs.device)
    for s in range(nnz):
        g = g + vp[cols[:, s]] * vals[:, s, None]
    return g, torch.sum(vals, dim=1)


def centroid_bound_batch(sel_b: torch.Tensor, r_b: torch.Tensor,
                         mask_b: torch.Tensor, vecs: torch.Tensor,
                         g: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Tier-0 centroid lower bounds. Returns (Q, N).

    sel_b / r_b / mask_b: the (Q, v_r) padded-query arrays of
    `core.distributed.pad_query_batch` (pad rows mask 0); g / m from
    `doc_centroids`. All-pad filler queries and empty docs score exactly
    0."""
    x = vecs[sel_b.long()]                              # (Q, v_r, dim)
    w = r_b * mask_b
    ws = torch.sum(w, dim=1)                            # (Q,)
    z = torch.sum(w[:, :, None] * x, dim=1) / torch.clamp(ws, min=TINY)[:, None]
    d2 = torch.sum((x - z[:, None, :]) ** 2, dim=-1)    # (Q, v_r)
    radius = torch.sqrt(torch.amax(torch.where(mask_b > 0, d2, 0.0), dim=1))
    g2 = torch.sum(g * g, dim=-1)                       # (N,)
    z2 = torch.sum(z * z, dim=-1)                       # (Q,)
    n2 = (g2[None, :] - 2.0 * m[None, :] * (z @ g.T)
          + (m[None, :] ** 2) * z2[:, None])            # ||g - m z||^2
    lb = torch.sqrt(torch.clamp(n2, min=0.0)) - m[None, :] * radius[:, None]
    lb = torch.clamp(lb, min=0.0)
    return torch.where(ws[:, None] > 0, lb, 0.0)        # filler queries -> 0


def min_cost_vectors(m_pad: torch.Tensor) -> torch.Tensor:
    """(Q, v_r, V+1) M stripes -> (Q, V+1) per-vocab-word min-cost vectors
    (pad query rows are +inf and never win; the min is exact). Laid out
    vocab-major in memory (the transpose of a contiguous (V+1, Q) tensor),
    the layout the LC kernel reads, so that it needs no copy of its own:
    the reduction runs along the stripes' rows, then one (Q, V+1) copy."""
    return torch.amin(m_pad, dim=1).T.contiguous().T


def lc_rwmd_bound_batch(minm: torch.Tensor, cols: torch.Tensor,
                        vals: torch.Tensor, impl: str = "kernel",
                        docs_chunk: int | None = None) -> torch.Tensor:
    """Batched LC-RWMD lower bounds: one sparse dot per doc. Returns (Q, N).

    minm: (Q, V+1) from `min_cost_vectors`; cols / vals: the corpus ELL.
    impl: "fused" (plain gather + slot sum) or "kernel"
    (`kernels.ops.lc_rwmd_bound_batch`: the CUDA kernel on the card, the
    plain spelling on the CPU). docs_chunk: the plain path's doc chunks
    (bitwise equal to unchunked); the kernel sizes its own blocks (a warp
    a document for up to 32 queries), so the kernel route ignores it."""
    if impl not in _LC_IMPLS:
        raise ValueError(f"impl must be one of {_LC_IMPLS}, got {impl!r}")
    if impl == "kernel":
        return ops.lc_rwmd_bound_batch(minm, cols, vals)
    q, n = minm.shape[0], cols.shape[0]
    u_dummy = torch.zeros((q, 1, n), dtype=minm.dtype, device=minm.device)
    lb = _chunk_over_docs(
        lambda _, cols_c, vals_c: lc_rwmd_bound_batch_plain(minm, cols_c,
                                                            vals_c),
        u_dummy, cols, vals, docs_chunk, pad_col=minm.shape[-1] - 1)
    return torch.where(torch.isfinite(lb), lb, 0.0)     # filler queries -> 0
