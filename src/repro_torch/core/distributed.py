"""Query padding and the solver programs (per query and batched), on one
device or on a single-controller mesh.

Port of `repro.core.distributed`. The reference builds shard_map programs
over a (data, model) mesh: docs (N) shard over the doc axes (``data``, and
``pod`` where the mesh has one) with no communication, the vocabulary (V)
over ``model`` (each shard holds its stripe of K and exactly the ELL
nonzeros whose word falls in it, `formats.rebucket_for_vocab_shards`), and
the only collectives are one psum over ``model`` per iteration and one
scalar-per-doc psum for the distances.

One program body serves every layout. With a `launch.mesh.Mesh`, one
Python process runs every shard in lockstep: one loop over iterations and
inside it a loop over the (doc shard, model shard) positions, each
launching on its own device (`launch.mesh.shard_grid`). ``mesh=None`` (the
default of every ``build_*``) runs the same body on the (1, 1) grid of
the device the inputs lie on: the one-device ELL's leading S = 1 axis
becomes the one model shard, and every collective is the identity. The
collectives are written out:
  * the model-axis sum copies each model shard's partial to the first
    model shard's device and sums them as a left fold in shard order,
    ``((p0 + p1) + p2) + ...``; the sum goes back to every model shard as
    the next iterate (no float atomics, no `torch.distributed`);
  * with ``tol > 0`` the convergence vote is the max of the per-doc-shard
    deltas (max is exact in any order), so the freeze mask is the same on
    every shard, as the reference's pmax over (model, *doc_axes);
  * the outputs come back on the mesh's first device, in doc order.
Each reports its bytes to an active count (`repro_torch._count`: an
all-reduce, the vote an all-reduce, the doc gather an all-gather).
Every copy a program makes from one device to another goes through `_to`,
which adds the bytes of those between distinct cards to ``peer_copies``
(by what was copied: stripes, queries, r, iterate, partials, vote,
distances, and the doc-sharded program's embeddings and docs; a caller
takes `peer_bytes_total` around a call).
At S = 1 each doc's reduction is the one-device one, so a (d, 1) mesh is
bit for bit the one-device program -- except where ``tol > 0`` meets
``chunk_placement="solve"`` with chunks smaller than a doc shard: there a
chunk iterates until every doc shard's chunk of its group has converged
(`_batched_solve`), as the reference's vote over the doc axes does. At
S > 1 a doc's slots split over the stripes and the sum differs by
rounding. Doc shards on one device share one vocab-major copy (and one K
stripe, in the per-query program) per model shard.

The programs hand the contractions the iterate x itself (``from_x``),
which form u = 1 / max(x, TINY) from it (the kernel route's kernels as
they load it), and on one model shard type1 applies the 1/r row scale in
its epilogue (`_row_scale`): on the kernel route no element-wise pass runs
over the (Q, v_r, N) iterate, and the bits are those of `safe_recip`
before the contraction and the divide by r after it.

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

import collections
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import sparse_sinkhorn as ss
from repro_torch.core.cost_matrix import cdist
from repro_torch.core.sparse_sinkhorn import pad_k, safe_recip
from repro_torch._count import collective as _counted
from repro_torch.launch.mesh import check_placement, on_device, shard_grid


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


# -- the mesh layout ----------------------------------------------------------

def _one(x) -> np.ndarray:
    """A (1, 1) object array holding ``x``: one device's tensor (or the
    device itself) in the mesh layout."""
    out = np.empty((1, 1), object)
    out[0, 0] = x
    return out


def _grids(mesh, doc_axes: Sequence[str], model_axis: str):
    """``grid_for(device)``: a program's (D, S) device grid -- ``mesh``'s
    (`shard_grid`), or without a mesh the (1, 1) grid of the device its
    inputs lie on."""
    if mesh is None:
        return _one
    grid = shard_grid(mesh, doc_axes, model_axis)
    return lambda dev: grid


def _doc_bounds(n: int, parts: int) -> list[tuple[int, int]]:
    """Contiguous (lo, hi) doc ranges of ``parts`` doc shards, in order
    (the first ``n % parts`` shards hold one doc more)."""
    edges = np.cumsum([0] + [n // parts + (i < n % parts)
                             for i in range(parts)])
    return [(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:])]


def shard_docs(mesh, blocks: Sequence[torch.Tensor], *,
               doc_axes: Sequence[str] = ("data",),
               model_axis: str = "model") -> np.ndarray:
    """Split each model shard's (N, ...) block (``blocks[s]``, on any
    device) over the doc shards, contiguous docs in doc order, and move
    each part to its position's device. Returns the (D, S) object array of
    parts."""
    grid = shard_grid(mesh, doc_axes, model_axis)
    if len(blocks) != grid.shape[1]:
        raise ValueError(f"{len(blocks)} model-shard blocks for "
                         f"{grid.shape[1]} model shards")
    out = np.empty(grid.shape, object)
    for s, blk in enumerate(blocks):
        for d, (lo, hi) in enumerate(_doc_bounds(blk.shape[0],
                                                 grid.shape[0])):
            out[d, s] = blk[lo:hi].to(grid[d, s])
    return out


def shard_wmd_inputs(mesh, vecs, cols_b: np.ndarray, vals_b: np.ndarray, *,
                     doc_axes: Sequence[str] = ("data",),
                     model_axis: str = "model"):
    """Place the embeddings and the rebucketed ELL on the mesh with the
    layouts the mesh programs expect.

    vecs (V, w) (numpy or a tensor) is striped over the model axis;
    cols_b / vals_b (S, N, nnz_loc) is the host rebucketed ELL
    (`formats.rebucket_for_vocab_shards(ell, S)`), its docs split over the
    doc shards. Returns (vecs_d, cols_d, vals_d), each a (D, S) object
    array (`shard_grid`): position (d, s) holds stripe s of vecs and doc
    shard d of model shard s's ELL, on its device. Positions on one device
    share one stripe tensor."""
    grid = shard_grid(mesh, doc_axes, model_axis)
    n_doc, n_model = grid.shape
    if cols_b.shape[0] != n_model or vals_b.shape != cols_b.shape:
        raise ValueError(f"ELL of shape {cols_b.shape} / {vals_b.shape} for "
                         f"{n_model} model shards")
    vecs_t = torch.as_tensor(vecs, dtype=torch.float32)
    if vecs_t.shape[0] % n_model:
        raise ValueError(f"vocab {vecs_t.shape[0]} not divisible by model "
                         f"shards {n_model}")
    vs = vecs_t.shape[0] // n_model
    stripes: dict = {}
    vecs_d = np.empty(grid.shape, object)
    for d in range(n_doc):
        for s in range(n_model):
            key = (s, grid[d, s])
            if key not in stripes:
                stripes[key] = vecs_t[s * vs:(s + 1) * vs].to(
                    grid[d, s]).contiguous()
            vecs_d[d, s] = stripes[key]
    kw = dict(doc_axes=doc_axes, model_axis=model_axis)
    cols_d = shard_docs(mesh, [torch.from_numpy(np.ascontiguousarray(c))
                               for c in cols_b], **kw)
    vals_d = shard_docs(mesh, [torch.from_numpy(np.ascontiguousarray(v))
                               for v in vals_b], **kw)
    return vecs_d, cols_d, vals_d


# -- copies between cards -------------------------------------------------------

# bytes the programs have copied between distinct cards, by what was copied
peer_copies: collections.Counter = collections.Counter()


def peer_bytes_total() -> int:
    """All the bytes ``peer_copies`` has counted."""
    return sum(peer_copies.values())


def _between_cards(src: torch.device, dst: torch.device) -> bool:
    """A copy from ``src`` to ``dst`` crosses between two distinct cards
    (logical shards of one card, and the CPU, copy nothing)."""
    return src.type == dst.type == "cuda" and src.index != dst.index


def _to(t: torch.Tensor, dev: torch.device, what: str) -> torch.Tensor:
    """``t`` on ``dev``; a copy between two distinct cards adds its bytes
    to ``peer_copies[what]`` (on the host, with no sync)."""
    if _between_cards(t.device, dev):
        peer_copies[what] += t.nbytes
    return t.to(dev)


def _model_sum(parts: Sequence[torch.Tensor], dev: torch.device
               ) -> torch.Tensor:
    """The model-axis sum: each model shard's partial copied to ``dev``
    (the first model shard's), summed as a left fold in shard order."""
    if len(parts) == 1:
        return parts[0]
    with _counted("model_axis_sum", "all-reduce", parts[0], len(parts),
                  len(parts)):
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + _to(p, dev, "partials")
        return acc


def _vote(deltas: Sequence[torch.Tensor]) -> torch.Tensor:
    """The all-shards convergence vote: the max of the per-doc-shard (Q,)
    deltas, on the first one's device (max is exact in any order)."""
    acc = deltas[0]
    if len(deltas) == 1:
        return acc
    with _counted("vote", "all-reduce", acc, len(deltas), len(deltas)):
        for x in deltas[1:]:
            acc = torch.maximum(acc, _to(x, acc.device, "vote"))
    return acc


def _gather_docs(pieces: Sequence[torch.Tensor], dev: torch.device
                 ) -> torch.Tensor:
    """Doc-sharded outputs (last axis = docs) back on ``dev``, in doc
    order."""
    if len(pieces) == 1:
        return pieces[0]
    nbytes = sum(p.numel() * p.element_size() for p in pieces)
    with _counted("doc_gather", "all-gather", nbytes, len(pieces),
                  len(pieces)):
        return torch.cat([_to(p, dev, "distances") for p in pieces],
                         dim=-1)


def _per_device(grid: np.ndarray, fn) -> dict:
    """``fn(s, device)`` once for each (model shard, device) pair of the
    grid: doc shards on one device share the result."""
    out: dict = {}
    for d in range(grid.shape[0]):
        for s in range(grid.shape[1]):
            key = (s, grid[d, s])
            if key not in out:
                with on_device(grid[d, s]):
                    out[key] = fn(*key)
    return out


def _plan(grid, d, st, r_in, cols_d, vals_d, lo=0, hi=None) -> list:
    """What doc shard ``d``'s contractions read, one entry a model shard:
    (device, k_pad, km_pad, r, type1, type2, cols, vals), with r the row
    scale type1 divides by on that device (``r_in``, `_row_scale`) and the
    ELL rows ``lo:hi``. Made once a solve, not once an iteration."""
    out = []
    for s in range(grid.shape[1]):
        dev = grid[d, s]
        k_pad, km_pad, type1, type2 = st[(s, dev)]
        out.append((dev, k_pad, km_pad, r_in[dev], type1, type2,
                    cols_d[d, s][lo:hi], vals_d[d, s][lo:hi]))
    return out


def _row_scale(grid, r_sel: torch.Tensor):
    """(r_in, scale_in): the r type1 divides by on each device, and whether
    that is the row scale itself. On one model shard (``scale_in``) type1
    takes the real r and divides by it in its epilogue: acc / 1 / r ==
    acc / r, so the bits are those of the row scale after the sum. With
    several model shards the row scale must follow the model-axis sum:
    type1 takes ones and the program divides by r after `_model_sum`, as
    the reference does."""
    scale_in = grid.shape[1] == 1
    r_in = {dev: _to(r_sel, dev, "r") if scale_in else
            torch.ones_like(r_sel, device=dev) for dev in set(grid.flat)}
    return r_in, scale_in


def _contract(plan, home: torch.device, x: torch.Tensor, call
              ) -> torch.Tensor:
    """One doc shard's contraction: ``call(entry, x)`` for each model
    shard's ``plan`` entry, on the shard's device with the iterate ``x``
    copied there, then the model-axis sum on ``home`` (the doc shard's
    first device, the current one)."""
    parts = []
    for entry in plan:
        dev = entry[0]
        if dev == home:
            parts.append(call(entry, x))
        else:
            with on_device(dev):
                parts.append(call(entry, _to(x, dev, "iterate")))
    return _model_sum(parts, home)


# -- the per-query program ----------------------------------------------------

def _solve(grid, vecs_sel, r_sel, row_mask, vecs_d, cols_d, vals_d, *,
           lamb: float, max_iter: int, use_kernel: bool, kexp_impl: str,
           check: bool) -> torch.Tensor:
    """The per-query program, the shards in lockstep: a query stripe per
    (model shard, device), ``max_iter`` type1 contractions and the type2
    distance, each followed by one model-axis sum. As in the reference,
    type1 runs with r = 1 and the 1/r row scale follows the sum; acc / 1 is
    exact, so on one shard this is bitwise the same as dividing inside,
    which type1 does there (`_row_scale`); the contractions read x itself.
    Returns (N,) on ``grid[0, 0]``."""
    impl = "kernel" if use_kernel else "fused"
    n_doc = grid.shape[0]
    homes = list(grid[:, 0])

    def stripe(s, dev):
        k, km = masked_k(_to(vecs_sel, dev, "queries"),
                         vecs_d[_first_on(grid, s, dev), s], lamb,
                         _to(row_mask, dev, "queries"), kexp_impl)
        k_pad, km_pad = pad_k(k), pad_k(km)
        return (k_pad, km_pad, *ss.query_contractions(impl, k_pad, km_pad))

    st = _per_device(grid, stripe)
    r_in, scale_in = _row_scale(grid, r_sel)
    r_col = {dev: _to(r_sel, dev, "r")[:, None] for dev in set(homes)}
    v_r = r_sel.shape[0]
    xs = []
    for d, home in enumerate(homes):
        with on_device(home):
            xs.append(torch.full((v_r, cols_d[d, 0].shape[0]), 1.0 / v_r,
                                 dtype=torch.float32, device=home))
    plans = [_plan(grid, d, st, r_in, cols_d, vals_d) for d in range(n_doc)]
    if check:
        check_placement(grid, cols_d, "ELL cols")
        check_placement(grid, vals_d, "ELL vals")
        check_placement(grid, {k: v[:2] for k, v in st.items()},
                        "query stripes")
        check_placement(grid[:, :1], _one_column(xs), "iterates")

    def type1(entry, x):
        _, k_pad, _, r_e, t1, _, cols, vals = entry
        return t1(k_pad, r_e, x, cols, vals, from_x=True)

    def type2(entry, x):
        _, k_pad, km_pad, _, _, t2, cols, vals = entry
        return t2(k_pad, km_pad, x, cols, vals, from_x=True)

    for _ in range(max_iter):
        for d, home in enumerate(homes):
            with on_device(home):
                y = _contract(plans[d], home, xs[d], type1)
                xs[d] = y if scale_in else y / r_col[home]
    out = []
    for d, home in enumerate(homes):
        with on_device(home):
            out.append(_contract(plans[d], home, xs[d], type2))
    return _gather_docs(out, grid[0, 0])


def _first_on(grid, s, dev) -> int:
    """The first doc shard whose model shard ``s`` lies on ``dev``."""
    return next(d for d in range(grid.shape[0]) if grid[d, s] == dev)


def _one_column(tensors) -> np.ndarray:
    """A (n, 1) object array of tensors (one doc shard a row)."""
    out = np.empty((len(tensors), 1), object)
    for i, t in enumerate(tensors):
        out[i, 0] = t
    return out


def build_wmd_fn(mesh=None, *, lamb: float, max_iter: int,
                 doc_axes: Sequence[str] = ("data",),
                 model_axis: str = "model", use_kernel: bool = False,
                 kexp_impl: str = "kernel"):
    """The per-query WMD solver, on ``mesh`` or (``mesh=None``) on the
    device its inputs lie on.

    The returned fn takes (vecs_sel, r_sel, row_mask, vecs, cols_b, vals_b):
      vecs_sel (v_r, w) query word embeddings (`pad_query` rows),
      r_sel (v_r,) (pad rows = 1.0), row_mask (v_r,) (pad rows = 0.0);
      without a mesh: vecs (V, w), cols_b / vals_b (1, N, nnz) -- the
      rebucketed ELL, S = 1; on a mesh: vecs, cols_b, vals_b as
      `shard_wmd_inputs` places them
    and returns wmd (N,) (on the mesh's first device). ``use_kernel``
    keeps the reference's name: the type1 / type2 contractions through
    `kernels.ops` (the CUDA kernels for CUDA tensors), else the fused plain
    spelling. ``kexp_impl`` chooses the stripe precompute (`masked_k`).
    Without a mesh the inputs run as the (1, 1) mesh's: one program body.
    """
    grid_for = _grids(mesh, doc_axes, model_axis)
    checked = []

    def fn(vecs_sel, r_sel, row_mask, vecs, cols_b, vals_b):
        if mesh is None:
            vecs, cols_b, vals_b = _one(vecs), _one(cols_b[0]), \
                _one(vals_b[0])
        out = _solve(grid_for(vecs_sel.device), vecs_sel, r_sel, row_mask,
                     vecs, cols_b, vals_b, lamb=lamb, max_iter=max_iter,
                     use_kernel=use_kernel, kexp_impl=kexp_impl,
                     check=not checked)
        checked.append(True)
        return out

    return fn


# -- the batched programs -----------------------------------------------------

def _check_chunk_placement(chunk_placement: str) -> None:
    if chunk_placement not in ("solve", "iteration"):
        raise ValueError(f"chunk_placement must be 'solve' or 'iteration', "
                         f"got {chunk_placement!r}")


def _batched_solve(grid, st, r_sel, cols_d, vals_d, *, max_iter: int,
                   docs_chunk: int | None, chunk_placement: str, tol: float,
                   check: bool):
    """The batched Sinkhorn solve, the shards in lockstep. ``st``:
    {(model shard, device): (k_pad, km_pad, type1, type2)}, the stripes and
    contractions each (model shard, device) pair runs. One model-axis sum
    of the type1 partials an iteration and one of the distances; with
    ``tol`` one vote an iteration. As in the reference, type1 runs with
    r = 1 and the 1/r row scale follows the sum, except on one model shard,
    where type1 divides by r itself with the same bits (`_row_scale`); the
    contractions read the iterate x itself.

    ``chunk_placement="solve"`` runs the chunk loop outside the Sinkhorn
    loop: the doc shards solve their c-th chunks together (the reference's
    unrolled chunk loop under shard_map), each group of chunks with its own
    vote, and n_iter / delta are per-query maxima over the groups. On one
    doc shard each chunk freezes at its own convergence; on several, a
    chunk that has converged iterates on until its group has, so with
    ``tol > 0`` its bits differ from the one-doc-shard run's (n_iter, the
    maximum, does not). ``"iteration"`` chunks each contraction inside the
    iteration-major loop (one vote over every doc). Returns
    (wmd (Q, N), n_iter, delta) on ``grid[0, 0]``."""
    q, v_r = r_sel.shape
    n_doc = grid.shape[0]
    first = grid[0, 0]
    homes = list(grid[:, 0])
    iter_chunk = docs_chunk if chunk_placement == "iteration" else None
    r_col = {dev: _to(r_sel, dev, "r")[:, :, None] for dev in set(homes)}
    r_in, scale_in = _row_scale(grid, r_sel)
    n_d = [cols_d[d, 0].shape[0] for d in range(n_doc)]
    if check:
        check_placement(grid, cols_d, "ELL cols")
        check_placement(grid, vals_d, "ELL vals")
        check_placement(grid, {k: v[:2] for k, v in st.items()},
                        "K / K.*M stripes")

    def type1(entry, x):
        _, k_pad, _, r_e, t1, _, cols, vals = entry
        return t1(k_pad, r_e, x, cols, vals, docs_chunk=iter_chunk,
                  from_x=True)

    def type2(entry, x):
        _, k_pad, km_pad, _, _, t2, cols, vals = entry
        return t2(k_pad, km_pad, x, cols, vals, docs_chunk=iter_chunk,
                  from_x=True)

    def solve(spans):
        """One lockstep solve of the doc ranges ``spans`` [(d, lo, hi)]."""
        x0 = []
        for d, lo, hi in spans:
            with on_device(homes[d]):
                x0.append(torch.full((q, v_r, hi - lo), 1.0 / v_r,
                                     dtype=torch.float32, device=homes[d]))
        if check:
            check_placement(grid[[d for d, _, _ in spans], :1],
                            _one_column(x0), "iterates")
        plans = [(homes[d], _plan(grid, d, st, r_in, cols_d, vals_d, lo, hi))
                 for d, lo, hi in spans]

        def iteration(xs):
            out = []
            for (home, plan), x in zip(plans, xs):
                with on_device(home):
                    y = _contract(plan, home, x, type1)
                    out.append(y if scale_in else y / r_col[home])
            return out

        if tol:
            xs, delta, n_iter = ss.batched_sinkhorn_loop(
                iteration, x0, max_iter=max_iter, tol=tol,
                delta_all_reduce=_vote)
        else:
            xs = x0
            for _ in range(max_iter):
                xs = iteration(xs)
            delta = torch.zeros((q,), dtype=torch.float32, device=first)
            n_iter = torch.full((q,), max_iter, dtype=torch.int32,
                                device=first)
        wmd = []
        for (home, plan), x in zip(plans, xs):
            with on_device(home):
                wmd.append(_contract(plan, home, x, type2))
        return wmd, _to(n_iter, first, "vote"), _to(delta, first, "vote")

    if chunk_placement == "solve" and docs_chunk and docs_chunk < max(n_d):
        pieces = [[] for _ in range(n_doc)]
        iters, deltas = [], []
        for lo in range(0, max(n_d), docs_chunk):
            spans = [(d, lo, min(lo + docs_chunk, n_d[d]))
                     for d in range(n_doc) if lo < n_d[d]]
            wmd, n_iter, delta = solve(spans)
            for (d, _, _), w in zip(spans, wmd):
                pieces[d].append(w)
            iters.append(n_iter)
            deltas.append(delta)
        wmd = [_gather_docs(p, homes[d]) for d, p in enumerate(pieces)]
        return (_gather_docs(wmd, first),
                torch.amax(torch.stack(iters), dim=0),
                torch.amax(torch.stack(deltas), dim=0))
    wmd, n_iter, delta = solve([(d, 0, n_d[d]) for d in range(n_doc)])
    return _gather_docs(wmd, first), n_iter, delta


def _contractions(grid, impl, stripes, vm=None) -> dict:
    """{(model shard, device): (k_pad, km_pad, type1, type2)}: each pair's
    stripes (``stripes(s, device)``) and the batched contractions that
    read them; the kernel route's vocab-major copies come from ``vm`` (the
    `vocab_major_stripes` of the stripes) or are made here, once a pair."""
    def one(s, dev):
        k_pad, km_pad = stripes(s, dev)
        return (k_pad, km_pad, *ss.batched_contractions(
            impl, k_pad, km_pad, None if vm is None else vm[(s, dev)]))
    return _per_device(grid, one)


def build_wmd_batch_fn(mesh=None, *, lamb: float, max_iter: int,
                       doc_axes: Sequence[str] = ("data",),
                       model_axis: str = "model", impl: str = "kernel",
                       docs_chunk: int | None = None,
                       chunk_placement: str = "solve", tol: float = 0.0,
                       with_info: bool = False):
    """The batched WMD solver with the precompute inside the program, on
    ``mesh`` or (``mesh=None``) on the device its inputs lie on.

    The returned fn takes (vecs_sel, r_sel, row_mask, vecs, cols_b, vals_b):
      vecs_sel (Q, v_r, w), r_sel (Q, v_r) (pad rows = 1.0),
      row_mask (Q, v_r) (pad rows = 0.0); without a mesh: vecs (V, w),
      cols_b / vals_b (1, N, nnz) -- the rebucketed ELL, S = 1; on a mesh:
      vecs, cols_b, vals_b as `shard_wmd_inputs` places them
    and returns wmd (Q, N), or (wmd, n_iter (Q,), delta (Q,)) with
    ``with_info=True`` (on the mesh's first device). ``tol > 0`` votes over
    every shard each iteration (see `_batched_solve` for the chunks).
    """
    _check_chunk_placement(chunk_placement)
    grid_for = _grids(mesh, doc_axes, model_axis)
    checked = []

    def fn(vecs_sel, r_sel, row_mask, vecs, cols_b, vals_b):
        if mesh is None:
            vecs, cols_b, vals_b = _one(vecs), _one(cols_b[0]), \
                _one(vals_b[0])
        grid = grid_for(vecs_sel.device)

        def stripes(s, dev):
            k, km = masked_k_batch(_to(vecs_sel, dev, "queries"),
                                   vecs[_first_on(grid, s, dev), s], lamb,
                                   _to(row_mask, dev, "queries"))
            return pad_k(k), pad_k(km)

        out = _batched_solve(
            grid, _contractions(grid, impl, stripes), r_sel, cols_b, vals_b,
            max_iter=max_iter, docs_chunk=docs_chunk,
            chunk_placement=chunk_placement, tol=tol, check=not checked)
        checked.append(True)
        return out if with_info else out[0]

    return fn


def build_wmd_batch_fn_stripes(mesh=None, *, max_iter: int,
                               doc_axes: Sequence[str] = ("data",),
                               model_axis: str = "model",
                               impl: str = "kernel",
                               docs_chunk: int | None = None,
                               chunk_placement: str = "solve",
                               tol: float = 0.0, with_info: bool = False):
    """The batched WMD solver on preassembled stripes (`core.kcache`), on
    ``mesh`` or (``mesh=None``) on the device its inputs lie on.

    The returned fn takes (k_b, km_b, r_sel, cols_b, vals_b, vm=None):
      k_b, km_b the S model shards' (Q, v_r, Vloc+1) stripes (zero pad
      column, pad rows zeroed; `KCache.stripes_for_batch`), indexed by
      shard -- a list, or a (S, Q, v_r, Vloc+1) tensor; without a mesh
      cols_b / vals_b (1, N, nnz), on a mesh as `shard_wmd_inputs` places
      them; r_sel (Q, v_r); vm the `vocab_major_stripes` of k_b, km_b (a
      caller that runs several programs on one stripe set makes them once;
      None: the program does)
    and returns wmd (Q, N) (plus (n_iter, delta) with ``with_info=True``).
    No ``lamb``: it is baked into the cached rows.
    """
    _check_chunk_placement(chunk_placement)
    grid_for = _grids(mesh, doc_axes, model_axis)
    checked = []

    def fn(k_b, km_b, r_sel, cols_b, vals_b, vm=None):
        if mesh is None:
            cols_b, vals_b = _one(cols_b[0]), _one(vals_b[0])
        grid = grid_for(k_b[0].device)
        if not checked:
            check_placement(grid, list(k_b), "K stripes")
            check_placement(grid, list(km_b), "K.*M stripes")
        placed = _placed(grid, k_b, km_b)
        if vm is None and impl == "kernel":
            vm = _vocab_major(grid, placed)
        if not checked and vm is not None:
            check_placement(grid, vm, "vocab-major copies")
        st = _contractions(grid, impl, lambda s, dev: placed[(s, dev)], vm)
        out = _batched_solve(
            grid, st, r_sel, cols_b, vals_b, max_iter=max_iter,
            docs_chunk=docs_chunk, chunk_placement=chunk_placement, tol=tol,
            check=not checked)
        checked.append(True)
        return out if with_info else out[0]

    return fn


def _placed(grid, k_b, km_b) -> dict:
    """{(model shard, device): (k, km)}: each model shard's stripes copied
    once to each device its doc shards use (none where they lie there)."""
    return _per_device(grid, lambda s, dev: (_to(k_b[s], dev, "stripes"),
                                             _to(km_b[s], dev, "stripes")))


def _vocab_major(grid, placed: dict) -> dict:
    """The kernel route's vocab-major copies of the `_placed` stripes, on
    their devices."""
    return _per_device(grid, lambda s, dev: ss.vocab_major_pair(
        *placed[(s, dev)]))


def vocab_major_stripes(k_b, km_b, impl: str, mesh=None, *,
                        doc_axes: Sequence[str] = ("data",),
                        model_axis: str = "model"):
    """The vocab-major copies that the kernel route's type1 and type2 read,
    or None for the plain impls (they read the stripes as they are):
    {(model shard, device): (k_vm, km_vm)}, each (Q, Vloc+1, v_r), one pair
    for each model shard on each device its doc shards use (doc shards on
    one device share it), of the model shards' stripes ``k_b[s]``,
    ``km_b[s]``. Without a mesh: the one pair, keyed (0, the stripes'
    device)."""
    if impl != "kernel":
        return None
    grid = _grids(mesh, doc_axes, model_axis)(k_b[0].device)
    return _vocab_major(grid, _placed(grid, k_b, km_b))


# -- the doc-sharded program --------------------------------------------------

def build_wmd_fn_docsharded(mesh, *, lamb: float, max_iter: int,
                            use_kernel: bool = False):
    """Doc-sharded / K-replicated layout: every device keeps the whole
    query stripe and docs shard over ALL mesh axes, so the Sinkhorn loop
    has no collective at all (the vocab-sharded `build_wmd_fn` has one sum
    an iteration). The stripe is computed once a device (``masked_k``, the
    plain spelling, as the reference's).

    The returned fn takes (vecs_sel, r_sel, row_mask, vecs, cols, vals):
      vecs (V, w) (replicated: copied to each device of the mesh that
      lacks it), cols / vals (N, nnz) the corpus ELL (split over every
      position of the mesh, row major, contiguous docs)
    and returns wmd (N,) on the mesh's first device.
    """
    devs = list(mesh.devices.flat)
    impl = "kernel" if use_kernel else "fused"

    def fn(vecs_sel, r_sel, row_mask, vecs, cols, vals):
        def stripe(dev):
            with on_device(dev):
                k, km = masked_k(_to(vecs_sel, dev, "queries"),
                                 _to(vecs, dev, "embeddings"), lamb,
                                 _to(row_mask, dev, "queries"), "jnp")
                k_pad, km_pad = pad_k(k), pad_k(km)
                return (k_pad, km_pad, _to(r_sel, dev, "r"),
                        *ss.query_contractions(impl, k_pad, km_pad))

        st = {dev: stripe(dev) for dev in dict.fromkeys(devs)}
        out = []
        for dev, (lo, hi) in zip(devs, _doc_bounds(cols.shape[0],
                                                   len(devs))):
            k_pad, km_pad, r_d, type1, type2 = st[dev]
            with on_device(dev):
                cols_p = _to(cols[lo:hi], dev, "docs")
                vals_p = _to(vals[lo:hi], dev, "docs")
                x = torch.full((r_d.shape[0], hi - lo), 1.0 / r_d.shape[0],
                               dtype=torch.float32, device=dev)
                for _ in range(max_iter):
                    x = type1(k_pad, r_d, safe_recip(x), cols_p, vals_p)
                out.append(type2(k_pad, km_pad, safe_recip(x), cols_p,
                                 vals_p))
        return _gather_docs(out, devs[0])

    return fn
