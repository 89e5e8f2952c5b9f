"""Public entry points of the ported kernels: dispatch by device.

Port of `repro.kernels.ops`: the single-query and batched SDDMM-SpMM, the
vocab-chunked one-device driver `sddmm_spmm_chunked`, the stripe and row
kexp, cdist and the two RWMD bounds. A CUDA tensor goes to the
hand-written kernel, which launches or raises; a CPU tensor goes to the
kernel's plain PyTorch version. Nothing catches a build or launch failure
and falls back.

Padding rules differ from the TPU wrappers on purpose: the CUDA kernels
mask their own ragged edges (any v_r up to 128, any Q, N and nnz), so v_r,
Q and docs are not padded to tile multiples here and no (Q, v_r, V+1)
stripe is ever copied for alignment. Copies are made for layout: the
batched and the single-query type1 and type2 read K (and K.*M)
vocab-major (`k_vocab_major`, the ``*_vm`` entry points), and the solve
loops and reranks make those copies once per stripe set (the per-query
program once a query), on both devices (on the CPU they feed the same
gather as the reference layout). What remains of the reference's rules
is the caller's: K carries its zero pad column (ELL pad slots gather it),
pad query rows carry r = 1 and an all-zero K row, and Q-filler queries an
all-zero K, all of which the kernels turn into exact zeros. The bound wrappers keep
the reference's other sign: pad query rows of M carry +inf (a pad row must
never win the min), and an all-pad filler query's +inf bounds are
finite-ized to 0 here, on both devices (its engine distance is exactly 0,
so a 0 bound can never prune it).

Each entry that launches one kernel declares its cost
(`repro_torch._count.declared`, the formulas of `kernels.costs`): under an
active count a call adds it once, whichever route runs, and nothing
inside the entry is counted; the composite entries (the reference-layout
``sddmm_spmm_*``, ``sddmm_spmm_chunked``) count the entries they call.

Every entry that carries a reference name takes the reference's keywords
with its defaults (``v_tile=512``, ``rows_blk=8``, ``q_blk=None``) and
refuses what the reference's padding refuses (a non-int, zero or a
negative), on both devices. Neither the CUDA kernels nor the plain versions
follow them: the kernels choose their own tiles, and the result depends on
tiling in neither package.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cdist as _cdist
from repro_torch.kernels import costs as _costs
from repro_torch.kernels import kexp as _kexp
from repro_torch.kernels import lcrwmd as _lcrwmd
from repro_torch.kernels import rwmd as _rwmd
from repro_torch.kernels import sddmm_spmm as _sddmm_spmm
from repro_torch.kernels._pad import check_tile
from repro_torch._count import declared


def _with_recip(got, u, from_x: bool):
    # from_x: one reciprocal a (row, doc) inside the kernel
    if got is None or not from_x:
        return got
    return got[0], got[1] + u.numel()


def _type1_cost(k_vm, r_sel, u, cols, vals, from_x=False, **_):
    q = 1 if u.dim() == 2 else u.shape[0]
    vp1 = k_vm.shape[-2]
    return _with_recip(_costs.type1(q, u.shape[-2], u.shape[-1],
                                    cols.shape[1],
                                    *_costs.slots(cols, vals, vp1)),
                       u, from_x)


def _type2_cost(k_vm, km_vm, u, cols, vals, from_x=False, **_):
    q = 1 if u.dim() == 2 else u.shape[0]
    vp1 = k_vm.shape[-2]
    return _with_recip(_costs.type2(q, u.shape[-2], u.shape[-1],
                                    cols.shape[1],
                                    *_costs.slots(cols, vals, vp1)),
                       u, from_x)


def _rows_cost(outputs):
    return lambda a, b, **_: _costs.cost_rows(a.shape[0], b.shape[0],
                                              a.shape[1], outputs)


def _rwmd_cost(m_pad, cols, vals, **_):
    q, v_r, vp1 = m_pad.shape
    return _costs.rwmd(q, v_r, cols.shape[0], cols.shape[1],
                       *_costs.slots(cols, vals, vp1))


def _lc_cost(minm, cols, vals, **_):
    return _costs.lc_rwmd(minm.shape[0], cols.shape[0], cols.shape[1],
                          *_costs.slots(cols, vals, minm.shape[1]))


@declared("sddmm_spmm_type1", _type1_cost)
def sddmm_spmm_type1_vm(k_vm: torch.Tensor, r_sel: torch.Tensor,
                        u: torch.Tensor, cols: torch.Tensor,
                        vals: torch.Tensor, *,
                        docs_blk: int = _sddmm_spmm.QUERY_DOCS_BLK,
                        from_x: bool = False) -> torch.Tensor:
    """Fused Sinkhorn iteration body of one query on its vocab-major copy
    k_vm (V+1, v_r) (`k_vocab_major` of the stripe); otherwise
    `sddmm_spmm_type1`, bit for bit. ``from_x``: u is the iterate x, and
    the kernel forms `safe_recip`(x) itself (the same bits)."""
    if k_vm.is_cuda:
        return _sddmm_spmm.sddmm_spmm_type1_vm(
            k_vm.contiguous(), r_sel.contiguous(), u.contiguous(),
            cols.contiguous(), vals.contiguous(), docs_blk=docs_blk,
            from_x=from_x)
    return _sddmm_spmm.sddmm_spmm_type1_vm_plain(k_vm, r_sel, u, cols, vals,
                                                 from_x=from_x)


def sddmm_spmm_type1(k_pad: torch.Tensor, r_sel: torch.Tensor,
                     u: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                     *, docs_blk: int = _sddmm_spmm.QUERY_DOCS_BLK
                     ) -> torch.Tensor:
    """Fused Sinkhorn iteration body of one query: k_pad (v_r, V+1) with
    the zero pad column, r_sel (v_r,), u (v_r, N), cols/vals (N, nnz) ->
    x (v_r, N). Makes the vocab-major copy of k_pad for this one call: a
    loop takes `k_vocab_major` once and calls `sddmm_spmm_type1_vm`."""
    return sddmm_spmm_type1_vm(k_vocab_major(k_pad[None])[0], r_sel, u,
                               cols, vals, docs_blk=docs_blk)


@declared("sddmm_spmm_type2", _type2_cost)
def sddmm_spmm_type2_vm(k_vm: torch.Tensor, km_vm: torch.Tensor,
                        u: torch.Tensor, cols: torch.Tensor,
                        vals: torch.Tensor, *,
                        docs_blk: int = _sddmm_spmm.QUERY_DOCS_BLK,
                        from_x: bool = False) -> torch.Tensor:
    """Fused final distance of one query on its vocab-major copies k_vm,
    km_vm (V+1, v_r) (`k_vocab_major` of the stripes); otherwise
    `sddmm_spmm_type2`, bit for bit. ``from_x``: u is the iterate x."""
    if k_vm.is_cuda:
        return _sddmm_spmm.sddmm_spmm_type2_vm(
            k_vm.contiguous(), km_vm.contiguous(), u.contiguous(),
            cols.contiguous(), vals.contiguous(), docs_blk=docs_blk,
            from_x=from_x)
    return _sddmm_spmm.sddmm_spmm_type2_vm_plain(k_vm, km_vm, u, cols, vals,
                                                 from_x=from_x)


def sddmm_spmm_type2(k_pad: torch.Tensor, km_pad: torch.Tensor,
                     u: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                     *, docs_blk: int = _sddmm_spmm.QUERY_DOCS_BLK
                     ) -> torch.Tensor:
    """Fused final distance of one query: k_pad, km_pad (v_r, V+1), u
    (v_r, N), cols/vals (N, nnz) -> (N,) WMD. Makes the vocab-major copies
    of k_pad and km_pad for this one call: a loop takes `k_vocab_major` of
    each once and calls `sddmm_spmm_type2_vm`."""
    return sddmm_spmm_type2_vm(k_vocab_major(k_pad[None])[0],
                               k_vocab_major(km_pad[None])[0], u, cols, vals,
                               docs_blk=docs_blk)


def sddmm_spmm_chunked(k_chunks: torch.Tensor, r_sel: torch.Tensor,
                       u: torch.Tensor, cols_chunks: torch.Tensor,
                       vals_chunks: torch.Tensor, *,
                       docs_blk: int = 8) -> torch.Tensor:
    """Vocab-chunked type1 on one device, the layout of the vocab-sharded
    engine (`core.formats.rebucket_for_vocab_shards`): k_chunks
    (S, v_r, Vc+1), cols_chunks / vals_chunks (S, N, nnz_c) with ids local
    to the chunk. The S partial x's (type1 with r = 1) are summed in chunk
    order and divided by r once, as the reference's scan does; the sum is
    reordered against the monolithic type1 (rtol 1e-4, not bitwise)."""
    ones_r = torch.ones_like(r_sel)
    x = torch.zeros_like(u)
    for k_c, cols_c, vals_c in zip(k_chunks, cols_chunks, vals_chunks):
        x = x + sddmm_spmm_type1(k_c, ones_r, u, cols_c, vals_c,
                                 docs_blk=docs_blk)
    return x / r_sel[:, None]


@declared("k_vocab_major", lambda k_pad: _costs.vocab_major(
    *k_pad.shape))
def k_vocab_major(k_pad: torch.Tensor) -> torch.Tensor:
    """The vocab-major copy (Q, V+1, v_r) of K (or K.*M) stripes
    (Q, v_r, V+1) that the ``*_vm`` entry points read: a caller that runs
    several launches on one stripe set (a Sinkhorn loop, a rerank) makes
    it once."""
    if k_pad.is_cuda:
        return _sddmm_spmm.k_vocab_major(k_pad.contiguous())
    return _sddmm_spmm.k_vocab_major_plain(k_pad)


@declared("sddmm_spmm_type1_batch", _type1_cost)
def sddmm_spmm_type1_batch_vm(k_vm: torch.Tensor, r_sel: torch.Tensor,
                              u: torch.Tensor, cols: torch.Tensor,
                              vals: torch.Tensor, *, docs_blk: int = 8,
                              from_x: bool = False) -> torch.Tensor:
    """Batched fused iteration body on the vocab-major copy k_vm
    (Q, V+1, v_r) of `k_vocab_major`; otherwise `sddmm_spmm_type1_batch`,
    bit for bit. ``from_x``: u is the iterate x, and the kernel forms
    `safe_recip`(x) itself (the same bits)."""
    if k_vm.is_cuda:
        return _sddmm_spmm.sddmm_spmm_type1_batch_vm(
            k_vm.contiguous(), r_sel.contiguous(), u.contiguous(),
            cols.contiguous(), vals.contiguous(), docs_blk=docs_blk,
            from_x=from_x)
    return _sddmm_spmm.sddmm_spmm_type1_batch_vm_plain(k_vm, r_sel, u, cols,
                                                       vals, from_x=from_x)


def sddmm_spmm_type1_batch(k_pad: torch.Tensor, r_sel: torch.Tensor,
                           u: torch.Tensor, cols: torch.Tensor,
                           vals: torch.Tensor, *, docs_blk: int = 8,
                           q_blk: int | None = None,
                           from_x: bool = False) -> torch.Tensor:
    """Batched fused iteration body: k_pad (Q, v_r, V+1), r_sel (Q, v_r),
    u (Q, v_r, N), cols/vals (N, nnz) -> x (Q, v_r, N). ``docs_blk`` is the
    kernel's doc tile (results do not depend on it). Makes the vocab-major
    copy of k_pad for this one call: loops take `k_vocab_major` once and
    call `sddmm_spmm_type1_batch_vm`. ``from_x``: u is the iterate x."""
    check_tile("sddmm_spmm_type1_batch", "q_blk", q_blk, optional=True)
    return sddmm_spmm_type1_batch_vm(k_vocab_major(k_pad), r_sel, u, cols,
                                     vals, docs_blk=docs_blk, from_x=from_x)


@declared("sddmm_spmm_type2_batch", _type2_cost)
def sddmm_spmm_type2_batch_vm(k_vm: torch.Tensor, km_vm: torch.Tensor,
                              u: torch.Tensor, cols: torch.Tensor,
                              vals: torch.Tensor, *, docs_blk: int = 8,
                              from_x: bool = False) -> torch.Tensor:
    """Batched fused final distance on the vocab-major copies k_vm, km_vm
    (Q, V+1, v_r) of `k_vocab_major`; otherwise `sddmm_spmm_type2_batch`,
    bit for bit. ``from_x``: u is the iterate x."""
    if k_vm.is_cuda:
        return _sddmm_spmm.sddmm_spmm_type2_batch_vm(
            k_vm.contiguous(), km_vm.contiguous(), u.contiguous(),
            cols.contiguous(), vals.contiguous(), docs_blk=docs_blk,
            from_x=from_x)
    return _sddmm_spmm.sddmm_spmm_type2_batch_vm_plain(k_vm, km_vm, u, cols,
                                                       vals, from_x=from_x)


def sddmm_spmm_type2_batch(k_pad: torch.Tensor, km_pad: torch.Tensor,
                           u: torch.Tensor, cols: torch.Tensor,
                           vals: torch.Tensor, *, docs_blk: int = 8,
                           q_blk: int | None = None,
                           from_x: bool = False) -> torch.Tensor:
    """Batched fused final distance: k_pad, km_pad (Q, v_r, V+1), u
    (Q, v_r, N), cols/vals (N, nnz) -> (Q, N) WMD. Makes the vocab-major
    copies of k_pad and km_pad for this one call: loops take
    `k_vocab_major` of each once and call `sddmm_spmm_type2_batch_vm`.
    ``from_x``: u is the iterate x."""
    check_tile("sddmm_spmm_type2_batch", "q_blk", q_blk, optional=True)
    return sddmm_spmm_type2_batch_vm(k_vocab_major(k_pad),
                                     k_vocab_major(km_pad), u, cols, vals,
                                     docs_blk=docs_blk, from_x=from_x)


@declared("cdist_kexp", _rows_cost(2))
def cdist_kexp(a: torch.Tensor, b: torch.Tensor, *, lamb: float,
               v_tile: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused precompute of one query's stripe: a (v_r, w) query words,
    b (V, w) -> (K, K.*M), each (v_r, V)."""
    check_tile("cdist_kexp", "v_tile", v_tile)
    if a.is_cuda:
        return _kexp.cdist_kexp(a.contiguous(), b.contiguous(), lamb=lamb)
    return _kexp.cdist_kexp_plain(a, b, lamb=lamb)


@declared("cdist_kexp_rows", _rows_cost(2))
def cdist_kexp_rows(a: torch.Tensor, b: torch.Tensor, *, lamb: float,
                    rows_blk: int = 8, v_tile: int = 512
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-subset fused precompute (the cache-miss path of `core.kcache`):
    a (m, w) miss-row embeddings, b (V, w) -> (K, K.*M), each (m, V)."""
    check_tile("cdist_kexp_rows", "rows_blk", rows_blk)
    check_tile("cdist_kexp_rows", "v_tile", v_tile)
    if a.is_cuda:
        return _kexp.cdist_kexp_rows(a.contiguous(), b.contiguous(),
                                     lamb=lamb)
    return _kexp.cdist_kexp_rows_plain(a, b, lamb=lamb)


@declared("cdist", _rows_cost(1))
def cdist(a: torch.Tensor, b: torch.Tensor, *, v_tile: int = 512,
          squared: bool = False) -> torch.Tensor:
    """Euclidean cost rows a (m, w) against b (V, w) -> (m, V) (the M-row
    compute of the bound tiers); ``squared`` skips the sqrt."""
    check_tile("cdist", "v_tile", v_tile)
    if a.is_cuda:
        return _cdist.cdist(a.contiguous(), b.contiguous(), squared=squared)
    return _cdist.cdist_plain(a, b, squared=squared)


def _finite(lb: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(lb), lb, 0.0)


@declared("rwmd_bound_batch", _rwmd_cost)
def rwmd_bound_batch(m_pad: torch.Tensor, cols: torch.Tensor,
                     vals: torch.Tensor, *,
                     docs_blk: int = _rwmd.BOUND_DOCS_BLK,
                     q_blk: int | None = None) -> torch.Tensor:
    """Batched doc-side RWMD min-SDDMM: m_pad (Q, v_r, V+1) with +inf pad
    query rows, cols/vals (N, nnz) -> (Q, N) bounds, filler queries 0. On
    the card the shapes pick the kernel's route (`kernels.rwmd.rwmd_route`:
    the column mins of all of M for large document sets, a gather of each
    slot's column for small ones; the same bits). ``docs_blk`` is the
    kernel's doc tile (results do not depend on it)."""
    check_tile("rwmd_bound_batch", "q_blk", q_blk, optional=True)
    if m_pad.is_cuda:
        return _finite(_rwmd.rwmd_bound_batch(
            m_pad.contiguous(), cols.contiguous(), vals.contiguous(),
            docs_blk=docs_blk))
    return _finite(_rwmd.rwmd_bound_batch_plain(m_pad, cols, vals))


@declared("lc_rwmd_bound_batch", _lc_cost)
def lc_rwmd_bound_batch(minm: torch.Tensor, cols: torch.Tensor,
                        vals: torch.Tensor, *, docs_blk: int | None = None,
                        q_blk: int | None = None) -> torch.Tensor:
    """Batched LC-RWMD sparse dot: minm (Q, V+1), cols/vals (N, nnz) ->
    (Q, N) bounds, filler queries 0; bitwise equal to `rwmd_bound_batch`
    on the M stripes minm was reduced from. The kernel reads minm
    vocab-major (see `kernels.lcrwmd`); ``docs_blk`` does not change the
    result."""
    check_tile("lc_rwmd_bound_batch", "q_blk", q_blk, optional=True)
    if minm.is_cuda:
        return _finite(_lcrwmd.lc_rwmd_bound_batch(
            minm, cols.contiguous(), vals.contiguous(), docs_blk=docs_blk))
    return _finite(_lcrwmd.lc_rwmd_bound_batch_plain(minm, cols, vals))
