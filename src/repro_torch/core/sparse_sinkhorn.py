"""PASWD: the paper's sparse Sinkhorn-WMD with fused SDDMM-SpMM.

Port of `repro.core.sparse_sinkhorn`: the single-query solver
(`sinkhorn_wmd_sparse`) and the batched engine (`sinkhorn_wmd_sparse_batch`).
The document-frequency matrix is doc-major padded ELL (`core.formats`); the
SDDMM samples only the nnz dot products and the fusion reuses one gather of
K columns for both contractions:

    SDDMM : w[q,j,k] = sum_i K[q, i, cols[j,k]] * u[q,i,j]
            v[q,j,k] = vals[j,k] / w[q,j,k]
    SpMM  : x[q,i,j] = (1/r[q,i]) * sum_k K[q, i, cols[j,k]] * v[q,j,k]

type2 (final distance) swaps the SpMM operand to K.*M and reduces over i:
WMD[q,j] = sum_i u[q,i,j] * sum_k (K.*M)[q, i, cols[j,k]] * v[q,j,k].

Three execution paths, selected by ``impl`` (`_resolve_impl`, one table
for the single-query and the batched solvers):
  * "kernel"  -- `repro_torch.kernels.ops`: the CUDA kernels for CUDA
                 tensors, their plain versions for CPU tensors. The default.
  * "fused"   -- one gather per iteration, plain PyTorch (the paper's
                 fused baseline and the parity oracle of the kernel route).
  * "unfused" -- separate SDDMM / SpMM with independent gathers (the
                 paper's pre-fusion baseline).

The single-query plain spellings are the batched ones at Q = 1 (a (doc)
cell's bits do not depend on Q), so one query gives the same bits through
either solver on every device, as the kernels do on the card.

All paths consume K with one trailing zero column, so ELL pad slots
(col == V) contribute exactly zero. Mixed-size queries ride the exact
mask-based padding of `core.distributed`: pad rows carry r = 1 and a zeroed
K row, so they contribute exactly zero to every w, x and WMD.

``docs_chunk`` cache-blocks the solve over doc chunks: docs are independent
OT problems, so the chunk loop sits outside the whole Sinkhorn loop. Every
output element's reduction runs over one doc (v_r or nnz), never across
docs, so chunked results are bitwise equal to unchunked ones.

Early exit: `batched_sinkhorn_loop` freezes a query once its relative
iterate delta drops below ``tol``; with ``tol = 0.0`` no query ever freezes,
and the solvers run the plain fixed loop instead.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.cost_matrix import cdist
from repro_torch.core.sinkhorn import SinkhornPrecompute, precompute
from repro_torch.kernels._pad import pad_axis
# the reciprocal guard u = 1 / max(x, TINY) lives beside the kernels, which
# form it themselves when they read the iterate (``from_x``)
from repro_torch.kernels.sddmm_spmm import (TINY, safe_recip,  # noqa: F401
                                            slot_combine, slot_dots)

_IMPLS = ("fused", "unfused", "kernel")


def pad_k(k: torch.Tensor) -> torch.Tensor:
    """Append a zero column on the vocab (last) axis: gathers of the ELL pad
    id (== V) read zeros."""
    return torch.nn.functional.pad(k, (0, 1))


class BatchedSinkhornPrecompute(NamedTuple):
    """Per-query iteration-invariant stripes, stacked on a leading Q axis."""

    K: torch.Tensor   # (Q, v_r, V) exp(-lambda * M), pad rows zeroed
    KM: torch.Tensor  # (Q, v_r, V) K .* M
    r: torch.Tensor   # (Q, v_r) pad rows carry 1.0


def precompute_batch(sel_idx: torch.Tensor, r_sel: torch.Tensor,
                     vecs: torch.Tensor, lamb: float,
                     row_mask: torch.Tensor | None = None
                     ) -> BatchedSinkhornPrecompute:
    """Batched K / K.*M stripes for Q queries bucketed to a common v_r.
    sel_idx (Q, v_r) word ids (pad slots point at word 0), r_sel (Q, v_r),
    vecs (V, w), row_mask (Q, v_r) 1.0 real / 0.0 pad (None = all real)."""
    m = torch.stack([cdist(a, vecs) for a in vecs[sel_idx.long()]])
    k = torch.exp(-lamb * m)
    if row_mask is not None:
        k = k * row_mask[..., None]
    return BatchedSinkhornPrecompute(K=k, KM=k * m, r=r_sel)


def gather_k_batch(k_pad: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """One batched gather serving all Q queries: (Q, v_r, V+1), (N, nnz) ->
    (Q, N, nnz, v_r), batch dims (q, n) leading for both contractions."""
    return k_pad.transpose(1, 2)[:, cols]


def _chunk_over_docs(f, u: torch.Tensor, cols: torch.Tensor,
                     vals: torch.Tensor, docs_chunk: int | None,
                     pad_col: int) -> torch.Tensor:
    """Apply ``f(u_c, cols_c, vals_c)`` over N-chunks of ``docs_chunk`` docs.

    ``f`` maps a doc slice to an output whose LAST axis is the doc axis. A
    non-dividing N is padded with ELL pad slots (col = pad_col -> zero K
    column, val = 0) and the pad docs are sliced off the output.
    """
    n = cols.shape[0]
    if not docs_chunk or docs_chunk >= n:   # None and 0 both mean unchunked
        return f(u, cols, vals)
    cols = pad_axis(cols, 0, docs_chunk, value=pad_col)
    vals = pad_axis(vals, 0, docs_chunk)
    u = pad_axis(u, 2, docs_chunk)
    outs = [f(u[:, :, s:s + docs_chunk], cols[s:s + docs_chunk],
              vals[s:s + docs_chunk])
            for s in range(0, cols.shape[0], docs_chunk)]
    return torch.cat(outs, dim=-1)[..., :n]


def sddmm_batch(k_pad, u, cols, vals):
    """Batched sampled dense-dense matmul with its own gather (unfused)."""
    kg = gather_k_batch(k_pad, cols)                 # gather #1
    w = slot_dots(kg, u)
    return torch.where(vals[None] != 0.0, vals[None] * safe_recip(w), 0.0)


def spmm_batch(kor_pad, v, cols):
    """Batched SpMM -- re-gathers K (the unfused baseline's second gather)."""
    kg = gather_k_batch(kor_pad, cols)               # gather #2
    return slot_combine(kg, v)


def sddmm_spmm_type1_batch(k_pad, r_sel, u, cols, vals, *,
                           docs_chunk: int | None = None,
                           from_x: bool = False) -> torch.Tensor:
    """Batched fused iteration body: (Q, v_r, N) <- one gather, two
    contractions (`kernels.sddmm_spmm.slot_dots` / `slot_combine`: a
    (q, doc) cell's bits do not depend on Q).

    k_pad (Q, v_r, V+1), r_sel (Q, v_r), u (Q, v_r, N), cols/vals (N, nnz).
    ``from_x``: u is the iterate x, and u = `safe_recip`(x) first.
    """
    u = safe_recip(u) if from_x else u

    def chunk(u_c, cols_c, vals_c):
        kg = gather_k_batch(k_pad, cols_c)           # the ONLY gather
        w = slot_dots(kg, u_c)
        v = torch.where(vals_c[None] != 0.0,
                        vals_c[None] * safe_recip(w), 0.0)
        x = slot_combine(kg, v)
        return x / r_sel[:, :, None]

    return _chunk_over_docs(chunk, u, cols, vals, docs_chunk,
                            pad_col=k_pad.shape[-1] - 1)


def sddmm_spmm_type2_batch(k_pad, km_pad, u, cols, vals, *,
                           docs_chunk: int | None = None,
                           from_x: bool = False) -> torch.Tensor:
    """Batched fused final distance: (Q, N) WMD, reduced as
    sum_k v * <(K.*M) col, u> (the reference's order). ``from_x`` as in
    `sddmm_spmm_type1_batch`."""
    u = safe_recip(u) if from_x else u

    def chunk(u_c, cols_c, vals_c):
        kg = gather_k_batch(k_pad, cols_c)
        kmg = gather_k_batch(km_pad, cols_c)
        w = slot_dots(kg, u_c)
        v = torch.where(vals_c[None] != 0.0,
                        vals_c[None] * safe_recip(w), 0.0)
        wm = slot_dots(kmg, u_c)
        return torch.sum(wm * v, dim=-1)             # (Q, docs)

    return _chunk_over_docs(chunk, u, cols, vals, docs_chunk,
                            pad_col=k_pad.shape[-1] - 1)


# -- the single-query half: the batched spellings at Q = 1 -------------------

def gather_k(k_pad: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Gather K columns per ELL slot: (v_r, V+1), (N, nnz) -> (N, nnz, v_r)."""
    return gather_k_batch(k_pad[None], cols)[0]


def sddmm(k_pad, u, cols, vals):
    """Sampled dense-dense matmul: v[j,k] = vals[j,k] / (K^T u)[cols[j,k], j],
    with its own gather (unfused)."""
    return sddmm_batch(k_pad[None], u[None], cols, vals)[0]


def spmm(kor_pad, v, cols):
    """x[i,j] = sum_k K_over_r[i, cols[j,k]] * v[j,k] -- re-gathers K."""
    return spmm_batch(kor_pad[None], v[None], cols)[0]


def sddmm_spmm_type1(k_pad, r_sel, u, cols, vals, *,
                     from_x: bool = False) -> torch.Tensor:
    """Fused iteration body of one query: one gather feeds both
    contractions. k_pad (v_r, V+1), r_sel (v_r,), u (v_r, N) -> (v_r, N)."""
    return sddmm_spmm_type1_batch(k_pad[None], r_sel[None], u[None], cols,
                                  vals, from_x=from_x)[0]


def sddmm_spmm_type2(k_pad, km_pad, u, cols, vals, *,
                     from_x: bool = False) -> torch.Tensor:
    """Fused final distance of one query: (N,) WMD."""
    return sddmm_spmm_type2_batch(k_pad[None], km_pad[None], u[None], cols,
                                  vals, from_x=from_x)[0]


def _type1_unfused(k_pad, r_sel, u, cols, vals, *, from_x=False
                   ) -> torch.Tensor:
    # independent gathers: the paper's pre-fusion baseline
    v = sddmm(k_pad, safe_recip(u) if from_x else u, cols, vals)
    return spmm(k_pad / r_sel[:, None], v, cols)


def _unfused_batch(k_pad, r_sel, u, cols, vals, *, docs_chunk=None,
                   from_x=False):
    del docs_chunk  # the baseline stays deliberately unblocked
    v = sddmm_batch(k_pad, safe_recip(u) if from_x else u, cols, vals)
    return spmm_batch(k_pad / r_sel[..., None], v, cols)


def _unfused_final_batch(k_pad, km_pad, u, cols, vals, *, docs_chunk=None,
                         from_x=False):
    # the unfused baseline shares the fused final distance, unblocked
    del docs_chunk
    return sddmm_spmm_type2_batch(k_pad, km_pad, u, cols, vals,
                                  from_x=from_x)


def _kernel_type1_batch(k_pad, r_sel, u, cols, vals, *, docs_chunk=None,
                        k_vm=None, from_x=False):
    # the kernel's native cache blocking IS its doc tile: docs_chunk maps
    # onto docs_blk instead of an outer loop (None/0 = default tile). k_vm:
    # the vocab-major copy of k_pad (`batched_contractions` makes it once
    # per stripe set); without it this call makes its own. from_x: u is
    # the iterate x (`kernels.ops`)
    from repro_torch.kernels import ops
    kw = {} if not docs_chunk else {"docs_blk": docs_chunk}
    if k_vm is None:
        return ops.sddmm_spmm_type1_batch(k_pad, r_sel, u, cols, vals,
                                          from_x=from_x, **kw)
    return ops.sddmm_spmm_type1_batch_vm(k_vm, r_sel, u, cols, vals,
                                         from_x=from_x, **kw)


def _kernel_type2_batch(k_pad, km_pad, u, cols, vals, *, docs_chunk=None,
                        vm=None, from_x=False):
    # vm: the vocab-major copies (k_vm, km_vm) of k_pad and km_pad
    # (`batched_contractions`); without them this call makes its own
    from repro_torch.kernels import ops
    kw = {} if not docs_chunk else {"docs_blk": docs_chunk}
    if vm is None:
        return ops.sddmm_spmm_type2_batch(k_pad, km_pad, u, cols, vals,
                                          from_x=from_x, **kw)
    return ops.sddmm_spmm_type2_batch_vm(*vm, u, cols, vals, from_x=from_x,
                                         **kw)


def _resolve_impl(kind: str, impl: str, batched: bool = True):
    """The ONE impl dispatch table, shared by the single-query and batched
    solvers (and `core.distributed`). kind: "type1" (signature (k_pad,
    r_sel, u, cols, vals)) or "type2" ((k_pad, km_pad, u, cols, vals));
    the batched ones also accept ``docs_chunk=``. The batched ones and the
    plain impls' single-query ones take ``from_x=True`` too (as do
    `query_contractions`' kernel pair): u is then the iterate x, and u =
    `safe_recip`(x) is formed inside, the kernel route's as the kernel
    loads it."""
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS}, got {impl!r}")
    if impl == "kernel":
        from repro_torch.kernels import ops
        table = {("type1", False): ops.sddmm_spmm_type1,
                 ("type2", False): ops.sddmm_spmm_type2,
                 ("type1", True): _kernel_type1_batch,
                 ("type2", True): _kernel_type2_batch}
    elif impl == "fused":
        table = {("type1", False): sddmm_spmm_type1,
                 ("type2", False): sddmm_spmm_type2,
                 ("type1", True): sddmm_spmm_type1_batch,
                 ("type2", True): sddmm_spmm_type2_batch}
    else:
        # the unfused baseline shares the fused final distance
        table = {("type1", False): _type1_unfused,
                 ("type2", False): sddmm_spmm_type2,
                 ("type1", True): _unfused_batch,
                 ("type2", True): _unfused_final_batch}
    return table[(kind, batched)]


def vocab_major_pair(k_pad: torch.Tensor, km_pad: torch.Tensor):
    """The vocab-major copies (k_vm, km_vm), each (Q, V+1, v_r), of K and
    K.*M stripes (Q, v_r, V+1) that the kernel route's batched type1 and
    type2 read."""
    from repro_torch.kernels import ops
    return ops.k_vocab_major(k_pad), ops.k_vocab_major(km_pad)


def batched_contractions(impl: str, k_pad: torch.Tensor,
                         km_pad: torch.Tensor, vm=None):
    """The batched (type1, type2) of ``impl`` for a loop over one stripe
    set k_pad, km_pad (Q, v_r, V+1). The kernel route reads the
    vocab-major copies of both, made here once (or ``vm``, the
    `vocab_major_pair` the caller already made), never once per launch;
    the plain impls read the stripes as they are."""
    type1 = _resolve_impl("type1", impl, True)
    type2 = _resolve_impl("type2", impl, True)
    if impl != "kernel":
        return type1, type2
    if vm is None:
        vm = vocab_major_pair(k_pad, km_pad)
    return (functools.partial(type1, k_vm=vm[0]),
            functools.partial(type2, vm=vm))


def query_contractions(impl: str, k_pad: torch.Tensor,
                       km_pad: torch.Tensor):
    """The single-query (type1, type2) of ``impl`` for one query's loop on
    its stripes k_pad, km_pad (v_r, V+1). The kernel route's type1 (#1)
    and type2 (#2) read the vocab-major copies of both (`vocab_major_pair`),
    made here once a query, never once per launch; the plain impls read the
    stripes as they are."""
    type1 = _resolve_impl("type1", impl, False)
    type2 = _resolve_impl("type2", impl, False)
    if impl != "kernel":
        return type1, type2
    from repro_torch.kernels import ops
    k_vm, km_vm = (c[0] for c in vocab_major_pair(k_pad[None], km_pad[None]))

    def type1_on_copy(k_pad, r_sel, u, cols, vals, *, from_x=False):
        return ops.sddmm_spmm_type1_vm(k_vm, r_sel, u, cols, vals,
                                       from_x=from_x)

    def type2_on_copies(k_pad, km_pad, u, cols, vals, *, from_x=False):
        return ops.sddmm_spmm_type2_vm(k_vm, km_vm, u, cols, vals,
                                       from_x=from_x)

    return type1_on_copy, type2_on_copies


def sinkhorn_wmd_sparse(sel_idx: torch.Tensor, r_sel: torch.Tensor,
                        cols: torch.Tensor, vals: torch.Tensor,
                        vecs: torch.Tensor, lamb: float, max_iter: int,
                        impl: str = "kernel") -> torch.Tensor:
    """Sparse PASWD Sinkhorn-WMD of one query. Returns (N,) distances.

    sel_idx (v_r,) nonzero-word ids of the query (`core.sinkhorn.
    select_query`), r_sel (v_r,) its frequencies, cols/vals (N, nnz) ELL
    (pad id == V, pad val 0), vecs (V, w); ``impl`` as in the module
    docstring.
    """
    pre = precompute(sel_idx, r_sel, vecs, lamb)
    return sinkhorn_wmd_sparse_pre(pre, cols, vals, max_iter, impl)


def sinkhorn_wmd_sparse_pre(pre: SinkhornPrecompute, cols: torch.Tensor,
                            vals: torch.Tensor, max_iter: int,
                            impl: str = "kernel") -> torch.Tensor:
    """Single-query solver core on precomputed matrices."""
    k_pad = pad_k(pre.K)
    km_pad = pad_k(pre.KM)
    v_r = pre.r.shape[0]
    type1, type2 = query_contractions(impl, k_pad, km_pad)
    x = torch.full((v_r, cols.shape[0]), 1.0 / v_r, dtype=pre.K.dtype,
                   device=pre.K.device)
    for _ in range(max_iter):
        x = type1(k_pad, pre.r, safe_recip(x), cols, vals)
    return type2(k_pad, km_pad, safe_recip(x), cols, vals)


def batched_sinkhorn_loop(iteration, x0, *, max_iter: int,
                          tol: float = 0.0, delta_all_reduce=None):
    """Early-exit Sinkhorn loop with per-query freeze masks.

    ``iteration`` maps x -> x_new for the whole (Q, v_r, N) batch. A query
    whose relative iterate delta drops below ``tol`` is frozen (its x block
    stops being written); the loop ends when every query has converged or
    at ``max_iter``. With ``tol = 0.0`` no query ever freezes, so the
    result equals the fixed-``max_iter`` loop exactly.

    ``delta_all_reduce`` (the mesh hook, the reference's argument): x0 is
    then the list of the doc shards' iterates, each (Q, v_r, N_d) on its
    device, ``iteration`` maps such a list to the next, and the hook maps
    the shards' (Q,) local deltas to the global one (the mesh programs
    pass their max: the all-shards vote), so every shard freezes the same
    queries. The loop still syncs the host once an iteration, for all
    shards. None (the default): x0 is one tensor, as before.

    Returns (x, delta, n_iter): final iterate (a list on the mesh),
    per-query relative |dx|_inf, and per-query executed iteration counts
    (Q,) int32.
    """
    shards = delta_all_reduce is not None
    xs = list(x0) if shards else [x0]
    q = xs[0].shape[0]
    delta = torch.full((q,), float("inf"), dtype=xs[0].dtype,
                       device=xs[0].device)
    n_iter = torch.zeros((q,), dtype=torch.int32, device=xs[0].device)
    for _ in range(max_iter):
        active = delta >= tol                              # (Q,)
        if not bool(active.any()):
            break
        new = iteration(xs) if shards else [iteration(xs[0])]
        # relative delta: x spans a huge dynamic range, so an absolute
        # norm would never cross tol for strongly regularized K
        rels = [torch.amax(torch.abs(x_new - x) / (torch.abs(x) + 1e-30),
                           dim=(1, 2)) for x_new, x in zip(new, xs)]
        rel = delta_all_reduce(rels).to(delta.device) if shards else rels[0]
        xs = [torch.where(active.to(x.device)[:, None, None], x_new, x)
              for x_new, x in zip(new, xs)]
        delta = torch.where(active, rel, delta)
        n_iter = n_iter + active.to(n_iter.dtype)
    return (xs if shards else xs[0]), delta, n_iter


def sinkhorn_wmd_sparse_batch(sel_idx: torch.Tensor, r_sel: torch.Tensor,
                              cols: torch.Tensor, vals: torch.Tensor,
                              vecs: torch.Tensor, lamb: float, max_iter: int,
                              row_mask: torch.Tensor | None = None,
                              impl: str = "kernel",
                              docs_chunk: int | None = None,
                              tol: float = 0.0) -> torch.Tensor:
    """Multi-query sparse PASWD Sinkhorn-WMD. Returns (Q, N) distances.

    sel_idx/r_sel/row_mask (Q, v_r) bucketed queries (`core.distributed.
    pad_query_batch`), cols/vals (N, nnz) ELL, vecs (V, w). ``impl``,
    ``docs_chunk`` and ``tol`` as in the module docstring.
    """
    pre = precompute_batch(sel_idx, r_sel, vecs, lamb, row_mask)
    return _solve_batch_stripes(pad_k(pre.K), pad_k(pre.KM), pre.r,
                                cols, vals, max_iter=max_iter, impl=impl,
                                docs_chunk=docs_chunk, tol=tol)


def _solve_batch_stripes(k_pad, km_pad, r_sel, cols, vals, *, max_iter: int,
                         impl: str, docs_chunk: int | None,
                         tol: float) -> torch.Tensor:
    """Shared solver core on preassembled (Q, v_r, V+1) stripes (zero pad
    column already appended)."""
    q, v_r = r_sel.shape
    n = cols.shape[0]
    type1, type2 = batched_contractions(impl, k_pad, km_pad)
    x0 = torch.full((q, v_r, n), 1.0 / v_r, dtype=k_pad.dtype,
                    device=k_pad.device)

    def solve_chunk(x0_c, cols_c, vals_c):
        def iteration(x):
            return type1(k_pad, r_sel, safe_recip(x), cols_c, vals_c)

        if tol:
            x, _, _ = batched_sinkhorn_loop(iteration, x0_c,
                                            max_iter=max_iter, tol=tol)
        else:
            x = x0_c
            for _ in range(max_iter):
                x = iteration(x)
        return type2(k_pad, km_pad, safe_recip(x), cols_c, vals_c)

    return _chunk_over_docs(solve_chunk, x0, cols, vals, docs_chunk,
                            pad_col=k_pad.shape[-1] - 1)


def sinkhorn_wmd_sparse_batch_stripes(k_pad: torch.Tensor,
                                      km_pad: torch.Tensor,
                                      r_sel: torch.Tensor, cols: torch.Tensor,
                                      vals: torch.Tensor, max_iter: int,
                                      impl: str = "kernel",
                                      docs_chunk: int | None = None,
                                      tol: float = 0.0) -> torch.Tensor:
    """Batched solver on preassembled stripes k_pad / km_pad (Q, v_r, V+1)
    (zero pad column in place, pad query rows zeroed) and r_sel (Q, v_r).
    Returns (Q, N); same math as `sinkhorn_wmd_sparse_batch`."""
    return _solve_batch_stripes(k_pad, km_pad, r_sel, cols, vals,
                                max_iter=max_iter, impl=impl,
                                docs_chunk=docs_chunk, tol=tol)
