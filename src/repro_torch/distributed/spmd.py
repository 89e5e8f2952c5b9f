"""Lockstep collectives of the language-model mesh program.

The port's own module: the reference has no counterpart. There GSPMD
compiles one program for every device of a mesh and inserts the
collectives that the parameters' and activations' shardings imply. The
port has no SPMD compiler: one Python thread builds one autograd graph
across all positions of a `launch.mesh.Mesh` and computes each position's
share on that position's device, as `core.distributed` does for the WMD
program. The points where positions meet are the collectives below, each
one `torch.autograd.Function` over all its positions, whose forward and
backward both sum in a fixed shard order: autograd's own accumulation
order never decides a bit, and there are no float atomics, threads, NCCL
or `torch.distributed`. The copies between positions are device-to-device
copies (on one card with several logical shards, copies in its memory).

The program's layout (`Layout`): the mesh axes are ``("data", "model")``
or ``("pod", "data", "model")``; position ``i`` (row major) is batch group
``g = i // M`` (``pod`` x ``data``, row major, the batch rows the batch
spec gives it) and model shard ``m = i % M``. Activations that the model
axis replicates live once a group, on the group's first position (its
*owner*); per-position tensors hold one model shard's share.

* `replicate` -- a group's activation to each of its model shards (the
  entry of a tensor-parallel region); backward: the shards' gradients
  folded in model order.
* `model_sum` -- the row-parallel partial outputs of a group's model
  shards, folded in model order (attention / MLP / expert ``wo``, the
  vocab-parallel embedding lookup and the cross-entropy's terms);
  backward: the gradient to each shard.
* `gather` -- a weight at its point of use: each user's region of the
  logical leaf assembled from the blocks of the positions that hold it
  (the FSDP gather over ``data``, and over ``model`` where a split is not
  a whole unit); backward: each block's gradient folded over its users in
  user order (the reduce-scatter). The caller casts the blocks first, so
  the gather moves compute-dtype bytes.
* `model_gather` -- a group's channel-split shares concatenated on each
  of its model shards (the mLSTM's up and conv outputs, which its q / k /
  v read whole); backward: each share's gradient folded over the shards
  in model order.
* `model_sum_scatter` -- the row-parallel partials of a layer whose
  outputs stay channel-split (the RG-LRU's gate pre-activations), each
  shard's slice of the group's sum folded in model order; backward: the
  slices' gradients concatenated to each shard. `model_allsum` is
  `replicate` of `model_sum` (a norm's statistic over split channels).
* `gather_rows` -- every group's rows to every group (the MoE router's
  logits); backward: each group's rows folded over the users in group
  order.
* `batch_fold` -- the groups' partial scalars (loss terms, the router's
  aux loss) folded in group order onto the first device.
* `replica_sum` -- not autograd: after the backward, the gradients of the
  replicas of one block (``pod`` always, and ``data`` / ``model`` for a
  leaf they replicate) summed in row-major order and written to each
  replica, so replicas stay bitwise equal.

On a one-position mesh every collective is the identity on its input: the
one-device program is the mesh program, op for op.

Each collective reports its bytes and group to an active count
(`repro_torch._count.collective`; the kinds each maps to are tabled in
`launch.costmodel`), in its forward and its backward; the ops inside it
are not counted as compute. ``meta`` blocks hold shapes and no data, so
`gather` makes each user's tensor and each block's gradient of them by
shape alone: there is nothing to copy.

Decode caches (no autograd): `state_specs`, `place_rows`, `place_blocks`
and `place_state` place a cache entry's tensors as blocks per
`partitioning.cache_shardings` (a cache's ``pos`` stays a Python int);
`group_rows` assembles a batch group's rows from its blocks at use and
`write_rows` writes a group's new rows (or one position's token) back
into the blocks that hold them.
"""
from __future__ import annotations

import functools
import itertools
import math

import numpy as np
import torch

from repro_torch.distributed.partitioning import (P, Placed, _axes,
                                                  block_slices)
from repro_torch._count import collective as _counted

_F32 = torch.float32


class Layout:
    """Groups and model shards of a mesh's positions (module docstring)."""

    def __init__(self, mesh):
        names = tuple(mesh.axis_names)
        if names not in (("data", "model"), ("pod", "data", "model")):
            raise ValueError(f"a language-model mesh has axes (data, model) "
                             f"or (pod, data, model), not {names}")
        self.mesh = mesh
        self.coords = list(np.ndindex(mesh.devices.shape))
        self.devices = [mesh.devices[c] for c in self.coords]
        self.size = len(self.coords)
        self.n_model = mesh.shape["model"]
        self.n_data = mesh.shape["data"]
        self.n_groups = self.size // self.n_model
        self.index = {c: i for i, c in enumerate(self.coords)}

    @property
    def single(self) -> bool:
        return self.size == 1

    def pos(self, g: int, m: int) -> int:
        return g * self.n_model + m

    def dev(self, i: int) -> torch.device:
        return self.devices[i]

    def group_dev(self, g: int) -> torch.device:
        return self.devices[g * self.n_model]

    def owners(self) -> list:
        return [g * self.n_model for g in range(self.n_groups)]

    def positions(self) -> list:
        return list(range(self.size))


@functools.lru_cache(maxsize=64)
def _layout(mesh) -> Layout:
    return Layout(mesh)


def layout(mesh) -> Layout:
    """The (cached) layout of ``mesh``."""
    return _layout(mesh)


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def fold(parts, dev, dtype):
    """Left fold of ``parts`` (None skipped) in list order on ``dev``,
    accumulated in float32 and cast to ``dtype`` once; None if all are."""
    acc = None
    for p in parts:
        if p is None:
            continue
        p = p.to(dev, _F32)
        acc = p if acc is None else acc + p
    return None if acc is None else acc.to(dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lay, *xs):
        ctx.lay = lay
        ctx.dtypes = [x.dtype for x in xs]
        ctx.nbytes = _bytes(xs[0])
        with _counted("replicate", "all-gather", xs[0], lay.n_model,
                      lay.size):
            return tuple(x.to(lay.dev(lay.pos(g, m)), copy=True)
                         for g, x in enumerate(xs)
                         for m in range(lay.n_model))

    @staticmethod
    def backward(ctx, *gs):
        lay, m = ctx.lay, ctx.lay.n_model
        with _counted("replicate", "reduce-scatter", ctx.nbytes, m,
                      lay.size):
            return (None, *[fold(gs[g * m:(g + 1) * m], lay.group_dev(g),
                                 ctx.dtypes[g])
                            for g in range(lay.n_groups)])


def replicate(lay: Layout, xs: list) -> list:
    """One tensor a group -> one a position (its model shards' copies)."""
    if lay.n_model == 1:
        return list(xs)
    return list(_Replicate.apply(lay, *xs))


class _ModelSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lay, *parts):
        ctx.lay = lay
        ctx.nbytes = _bytes(parts[0])
        m = lay.n_model
        with _counted("model_sum", "reduce-scatter", parts[0], m, lay.size):
            return tuple(fold(parts[g * m:(g + 1) * m], lay.group_dev(g),
                              parts[g * m].dtype)
                         for g in range(lay.n_groups))

    @staticmethod
    def backward(ctx, *gs):
        lay = ctx.lay
        with _counted("model_sum", "all-gather", ctx.nbytes, lay.n_model,
                      lay.size):
            return (None, *[gs[g].to(lay.dev(lay.pos(g, m)))
                            for g in range(lay.n_groups)
                            for m in range(lay.n_model)])


def model_sum(lay: Layout, parts: list) -> list:
    """One partial a position -> one sum a group (model order)."""
    if lay.n_model == 1:
        return list(parts)
    return list(_ModelSum.apply(lay, *parts))


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lay, *xs):
        ctx.lay = lay
        ctx.sizes = [x.shape[0] for x in xs]
        ctx.dtype = xs[0].dtype
        ctx.nbytes = sum(_bytes(x) for x in xs)
        with _counted("gather_rows", "all-gather", ctx.nbytes, lay.n_groups,
                      lay.n_groups):
            full = torch.cat([x.to(lay.group_dev(0)) for x in xs])
            return tuple(full.to(lay.group_dev(g), copy=True)
                         for g in range(lay.n_groups))

    @staticmethod
    def backward(ctx, *gs):
        lay = ctx.lay
        out, lo = [], 0
        with _counted("gather_rows", "reduce-scatter", ctx.nbytes,
                      lay.n_groups, lay.n_groups):
            for s, n in enumerate(ctx.sizes):
                out.append(fold([g[lo:lo + n] if g is not None else None
                                 for g in gs], lay.group_dev(s), ctx.dtype))
                lo += n
        return (None, *out)


def gather_rows(lay: Layout, xs: list) -> list:
    """One (T_g, ...) tensor a group -> the (T, ...) concatenation of all
    groups' rows, on every group."""
    if lay.n_groups == 1:
        return list(xs)
    return list(_GatherRows.apply(lay, *xs))


class _BatchFold(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lay, *xs):
        ctx.lay = lay
        ctx.nbytes = _bytes(xs[0])
        with _counted("batch_fold", "all-reduce", xs[0], lay.n_groups,
                      lay.n_groups):
            return fold(xs, lay.group_dev(0), xs[0].dtype)

    @staticmethod
    def backward(ctx, g):
        lay = ctx.lay
        with _counted("batch_fold", "all-gather", ctx.nbytes, lay.n_groups,
                      lay.n_groups):
            return (None, *[g.to(lay.group_dev(k))
                            for k in range(lay.n_groups)])


def batch_fold(lay: Layout, xs: list) -> torch.Tensor:
    """One partial a group -> their sum (group order), on the first
    device."""
    if lay.n_groups == 1:
        return xs[0]
    return _BatchFold.apply(lay, *xs)


class _ModelGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lay, dim, *parts):
        ctx.lay, ctx.dim = lay, dim
        ctx.dtype = parts[0].dtype
        ctx.n = parts[0].shape[dim]
        m = lay.n_model
        ctx.nbytes = _bytes(parts[0]) * m
        with _counted("model_gather", "all-gather", ctx.nbytes, m,
                      lay.size):
            return tuple(torch.cat([p.to(lay.dev(i))
                                    for p in parts[g * m:(g + 1) * m]], dim)
                         for g in range(lay.n_groups)
                         for i in range(g * m, (g + 1) * m))

    @staticmethod
    def backward(ctx, *gs):
        lay, m, n, dim = ctx.lay, ctx.lay.n_model, ctx.n, ctx.dim
        with _counted("model_gather", "reduce-scatter", ctx.nbytes, m,
                      lay.size):
            return (None, None, *[
                fold([None if gs[g * m + k] is None
                      else gs[g * m + k].narrow(dim, j * n, n)
                      for k in range(m)], lay.dev(g * m + j), ctx.dtype)
                for g in range(lay.n_groups) for j in range(m)])


def model_gather(lay: Layout, parts: list, dim: int) -> list:
    """One channel-split share a position -> the group's shares
    concatenated along ``dim`` in model order, on every position of the
    group (an all-gather over ``model``); backward: each share's gradient
    folded over the group's positions in model order."""
    if lay.n_model == 1:
        return list(parts)
    return list(_ModelGather.apply(lay, dim % parts[0].ndim, *parts))


class _ModelSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lay, dim, *parts):
        ctx.lay, ctx.dim = lay, dim
        m = lay.n_model
        n = parts[0].shape[dim] // m
        ctx.piece = parts[0].narrow(dim, 0, n).shape
        ctx.dtype = parts[0].dtype
        ctx.nbytes = _bytes(parts[0])
        with _counted("model_sum_scatter", "reduce-scatter", parts[0], m,
                      lay.size):
            return tuple(fold([parts[g * m + k].narrow(dim, j * n, n)
                               for k in range(m)], lay.dev(g * m + j),
                              parts[0].dtype)
                         for g in range(lay.n_groups) for j in range(m))

    @staticmethod
    def backward(ctx, *gs):
        lay, m = ctx.lay, ctx.lay.n_model
        with _counted("model_sum_scatter", "all-gather", ctx.nbytes, m,
                      lay.size):
            gs = [torch.zeros(ctx.piece, dtype=ctx.dtype, device=lay.dev(i))
                  if x is None else x
                  for i, x in enumerate(gs)]
            return (None, None, *[
                torch.cat([gs[g * m + j].to(lay.dev(g * m + k))
                           for j in range(m)], ctx.dim)
                for g in range(lay.n_groups) for k in range(m)])


def model_sum_scatter(lay: Layout, parts: list, dim: int) -> list:
    """One full-width partial a position -> position j of each group gets
    the j-th of M equal slices along ``dim`` of its group's sum, folded in
    model order (a reduce-scatter over ``model``: the row-parallel
    partials of a layer whose outputs stay channel-split); backward: the
    slices' gradients concatenated, to every position."""
    if lay.n_model == 1:
        return list(parts)
    return list(_ModelSumScatter.apply(lay, dim % parts[0].ndim, *parts))


def model_allsum(lay: Layout, parts: list) -> list:
    """One partial a position -> its group's sum (model order) on every
    position of the group (a norm's statistic over split channels)."""
    return replicate(lay, model_sum(lay, parts))


def max_over_model(lay: Layout, parts: list) -> list:
    """The element-wise max of a group's model shards' (detached)
    tensors, one a group (no gradient: a stabiliser)."""
    m = lay.n_model
    out = []
    for g in range(lay.n_groups):
        acc = None
        for p in parts[g * m:(g + 1) * m]:
            p = p.detach().to(lay.group_dev(g))
            acc = p if acc is None else torch.maximum(acc, p)
        out.append(acc)
    return out


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4096)
def _use_plan(lay: Layout, spec, shape: tuple, keep: tuple, users: tuple):
    """(plan, own) of a leaf of ``spec`` and logical ``shape`` on
    ``lay``'s mesh. The plan, for each user position: (device, shape,
    [(source position, slices of the user's tensor)]). The user's tensor
    is the leaf's region under the use spec (the leaf's spec with only the
    ``model`` entries of the dims in ``keep`` left; a user reads the blocks
    of the positions that share its coordinates on every axis the gathered
    dims do not name). ``own``: each user's tensor is its own whole block
    (nothing to gather). Cached: a mesh program gathers the same leaves
    every step."""
    mesh = lay.mesh
    names = mesh.axis_names
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    use = tuple(e if (d in keep and _axes(e) == ("model",)) else None
                for d, e in enumerate(spec))
    gathered = [d for d, e in enumerate(spec) if e is not None
                and use[d] is None]
    plan = []
    for u in users:
        cu = lay.coords[u]
        region = block_slices(mesh, P(*use), shape, cu)
        ushape = tuple(s.stop - s.start for s in region)
        pieces = []
        ranges = []
        for d in gathered:
            axes = _axes(spec[d])
            ranges.append([(d, axes, idx) for idx in np.ndindex(
                *[mesh.shape[a] for a in axes])])
        for combo in itertools.product(*ranges):
            at = dict(zip(names, cu))
            for _, axes, idx in combo:
                at.update(zip(axes, idx))
            src = tuple(int(at[a]) for a in names)
            bsl = block_slices(mesh, spec, shape, src)
            sl = tuple(slice(b.start - r.start, b.stop - r.start)
                       for b, r in zip(bsl, region))
            pieces.append((lay.index[src], sl))
        plan.append((lay.dev(u), ushape, tuple(pieces)))
    own = all(len(p) == 1 and p[0][0] == u
              and all(s == slice(0, n) for s, n in zip(p[0][1], ushape))
              for u, (_, ushape, p) in zip(users, plan)) \
        and len(set(users)) == len(users)
    return tuple(plan), own


def _use_bytes(plan, dtype) -> tuple[float, int]:
    """(bytes of one user's tensor, blocks a user assembles) of a plan."""
    _, shape, pieces = plan[0]
    return math.prod(shape) * dtype.itemsize, len(pieces)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, *blocks):
        ctx.plan = plan
        ctx.src = [(b.device, b.dtype, b.shape) for b in blocks]
        ctx.meta = blocks[0].device.type == "meta"
        nbytes, group = _use_bytes(plan, blocks[0].dtype)
        with _counted("gather", "all-gather", nbytes, group, len(plan)):
            outs = []
            for dev, shape, pieces in plan:
                out = torch.empty(shape, dtype=blocks[0].dtype, device=dev)
                if not ctx.meta:
                    for src, sl in pieces:
                        out[sl] = blocks[src].to(dev)
                outs.append(out)
            return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        nbytes, group = _use_bytes(ctx.plan, ctx.src[0][1])
        with _counted("gather", "reduce-scatter", nbytes, group,
                      len(ctx.plan)):
            readers = [[] for _ in ctx.src]
            for g, (_, _, pieces) in zip(gs, ctx.plan):
                for src, sl in pieces:
                    readers[src].append(None if g is None else
                                        g if ctx.meta else g[sl])
            if ctx.meta:                 # shapes only: nothing to sum
                return (None, *[
                    torch.empty(shape, dtype=dt, device=dev)
                    if any(x is not None for x in r) else None
                    for r, (dev, dt, shape) in zip(readers, ctx.src)])
            return (None, *[fold(r, dev, dt) if r else None
                            for r, (dev, dt, _) in zip(readers, ctx.src)])


def gather(lay: Layout, leaf, *, dtype=None, keep: tuple = (),
           users=None) -> list:
    """A weight at its point of use, one tensor a user (the positions in
    ``users``; default every position): the leaf's blocks cast to
    ``dtype``, then assembled so that a user holds the leaf's region under
    its use spec, which keeps only the ``model`` split of the dims in
    ``keep`` (the whole units a shard computes with) and gathers every
    other split. A plain tensor (one position) is returned as it is: the
    layer casts it at use."""
    if not isinstance(leaf, Placed):
        return [leaf]
    users = lay.positions() if users is None else users
    blocks = [leaf.blocks[c] for c in lay.coords]
    if dtype is not None:
        blocks = [b.to(dtype) for b in blocks]
    plan, own = _use_plan(lay, P(*leaf.spec), tuple(leaf.shape),
                          tuple(keep), tuple(users))
    if own:
        return [blocks[u] for u in users]        # each user's own block
    return list(_Gather.apply(plan, *blocks))


def gather_tree(lay: Layout, tree: dict, *, dtype=None, keep=None,
                users=None) -> list:
    """`gather` of every leaf of a dict of leaves, one dict a user;
    ``keep``: leaf name -> dims whose model split stays."""
    keep = keep or {}
    users = lay.positions() if users is None else users
    per = {k: gather_tree(lay, v, dtype=dtype, keep=keep, users=users)
           if isinstance(v, dict) else
           gather(lay, v, dtype=dtype, keep=keep.get(k, ()), users=users)
           for k, v in tree.items()}
    return [{k: per[k][i] for k in tree} for i in range(len(users))]


def splits_model(leaf, dim: int) -> bool:
    """Whether a leaf's dim ``dim`` is split over ``model`` alone."""
    if not isinstance(leaf, Placed):
        return False
    spec = tuple(leaf.spec) + (None,) * (leaf.ndim - len(leaf.spec))
    return _axes(spec[dim]) == ("model",)


def replica_sum(leaf: Placed, grads: dict) -> dict:
    """``grads`` (coords -> gradient or None) of one placed leaf with each
    block's replicas' gradients summed in row-major order and the sum
    written to every replica (zeros where no replica has one)."""
    out = {}
    for group in leaf.replica_sets():
        dev = leaf.blocks[group[0]].device
        parts = [grads[c] for c in group]
        if len(group) > 1:
            with _counted("replica_sum", "all-reduce",
                          leaf.blocks[group[0]].numel() * 4, len(group),
                          len(group)):
                tot = fold(parts, dev, _F32)
        else:
            tot = parts[0]
        if tot is None:
            tot = torch.zeros_like(leaf.blocks[group[0]], dtype=_F32)
        for c in group:
            out[c] = tot.to(leaf.blocks[c].device)
    return out


def rows_of(lay: Layout, x, g: int) -> torch.Tensor:
    """Group ``g``'s rows of a batch leaf on its owner's device: the
    owner's block of a `Placed` leaf, else the slice of a numpy array or
    tensor that the batch spec gives the group."""
    rows = x.shape[0] if hasattr(x, "shape") else len(x)
    if rows % lay.n_groups:
        raise ValueError(f"a batch of {rows} rows does not split over "
                         f"{lay.n_groups} batch groups")
    if isinstance(x, Placed):
        return x.blocks[lay.coords[g * lay.n_model]]
    x = torch.as_tensor(x)
    n = rows // lay.n_groups
    if lay.n_groups > 1:
        x = x[g * n:(g + 1) * n]
    return x.to(lay.group_dev(g))


def sq_sum(leaf) -> torch.Tensor:
    """The float32 sum of squares of a leaf: of a tensor, or of a placed
    leaf's distinct blocks folded in row-major order (on the first)."""
    if not isinstance(leaf, Placed):
        return torch.sum(torch.square(leaf.to(_F32)))
    parts = [torch.sum(torch.square(leaf.blocks[c].to(_F32)))
             for c in leaf.unique()]
    return fold(parts, parts[0].device, _F32)


# ---------------------------------------------------------------------------
# decode caches: blocks per `partitioning.cache_shardings` (no autograd)
# ---------------------------------------------------------------------------

def state_specs(lay: Layout, template):
    """The `cache_shardings` specs of a cache entry (a NamedTuple of
    tensors and an int ``pos``) from ``template``, an entry (meta tensors
    will do) that holds one batch group's rows: the NamedTuple with each
    tensor field's spec, for the logical tensor of all groups' rows."""
    from repro_torch.distributed.partitioning import cache_shardings
    meta = type(template)(*[
        torch.empty((v.shape[0] * lay.n_groups, *v.shape[1:]),
                    device="meta") if isinstance(v, torch.Tensor) else v
        for v in template])
    sh = cache_shardings(lay.mesh, meta)
    return type(template)(*[s.spec if isinstance(v, torch.Tensor) else v
                            for s, v in zip(sh, template)])


def place_blocks(lay: Layout, spec, shape, blocks: list) -> Placed:
    """A `Placed` of logical ``shape`` under ``spec`` from one block a
    position (position order), each already its region on its device."""
    arr = np.empty(lay.mesh.devices.shape, dtype=object)
    for c, b in zip(lay.coords, blocks):
        arr[c] = b
    return Placed(lay.mesh, spec, shape, arr)


def place_rows(lay: Layout, spec, rows: list) -> Placed:
    """A cache leaf placed as ``spec`` cuts it, from each batch group's
    rows (``rows[g]``, (B_g, ...)): each position's block a copy of its
    region, on its device."""
    b_g = rows[0].shape[0]
    shape = (b_g * lay.n_groups, *rows[0].shape[1:])
    blocks = []
    for i, c in enumerate(lay.coords):
        g = i // lay.n_model
        r = block_slices(lay.mesh, spec, shape, c)
        rel = (slice(r[0].start - g * b_g, r[0].stop - g * b_g), *r[1:])
        blocks.append(rows[g][rel].to(lay.dev(i), copy=True,
                                      memory_format=torch.contiguous_format))
    return place_blocks(lay, spec, shape, blocks)


def place_state(lay: Layout, states: list):
    """A cache entry from one entry a batch group (each holding its
    group's rows; ``pos`` from the first), its tensors placed by
    `state_specs` (`place_rows`); on one position the group's entry
    itself."""
    if lay.single:
        return states[0]
    specs = state_specs(lay, states[0])
    return type(states[0])(*[
        place_rows(lay, spec, [s[k] for s in states])
        if isinstance(v, torch.Tensor) else v
        for k, (spec, v) in enumerate(zip(specs, states[0]))])


def group_rows(lay: Layout, leaf, g: int, dev=None) -> torch.Tensor:
    """Batch group ``g``'s rows of a cache leaf, (B_g, ...) on ``dev``
    (the group's owner by default), assembled from the group's blocks:
    the owner's block itself where it holds them all on ``dev``, and the
    tensor itself on one position."""
    if not isinstance(leaf, Placed):
        return leaf if dev is None else leaf.to(dev)
    dev = lay.group_dev(g) if dev is None else dev
    m = lay.n_model
    b_g = leaf.shape[0] // lay.n_groups
    own = leaf.blocks[lay.coords[g * m]]
    if tuple(own.shape[1:]) == tuple(leaf.shape[1:]):
        return own.to(dev)
    out = torch.empty((b_g, *leaf.shape[1:]), dtype=own.dtype, device=dev)
    for j in range(m):
        c = lay.coords[g * m + j]
        r = block_slices(lay.mesh, leaf.spec, leaf.shape, c)
        out[(slice(None), *r[1:])] = leaf.blocks[c].to(dev)
    return out


def write_rows(lay: Layout, leaf, g: int, value: torch.Tensor,
               dim: int = 0, index: int | None = None) -> None:
    """Write batch group ``g``'s rows ``value`` into its blocks of a cache
    leaf, in place. With ``index``: ``value`` is the rows at ``index`` of
    dim ``dim`` (that dim dropped), written into the blocks whose region
    holds ``index``. On one position the tensor itself is written."""
    if not isinstance(leaf, Placed):
        dst = leaf if index is None else leaf.select(dim, index)
        if dst.data_ptr() != value.data_ptr():
            dst.copy_(value)
        return
    m = lay.n_model
    for j in range(m):
        c = lay.coords[g * m + j]
        r = block_slices(lay.mesh, leaf.spec, leaf.shape, c)
        blk = leaf.blocks[c]
        src = (slice(None), *r[1:])
        if index is not None:
            if not r[dim].start <= index < r[dim].stop:
                continue
            blk = blk.select(dim, index - r[dim].start)
            src = src[:dim] + src[dim + 1:]
        part = value[src]
        if blk.data_ptr() != part.data_ptr() or blk.device != part.device:
            blk.copy_(part)
