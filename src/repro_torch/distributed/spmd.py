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
"""
from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from repro_torch.distributed.partitioning import (P, Placed, _axes,
                                                  block_slices)

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
        return tuple(x.to(lay.dev(lay.pos(g, m)), copy=True)
                     for g, x in enumerate(xs) for m in range(lay.n_model))

    @staticmethod
    def backward(ctx, *gs):
        lay, m = ctx.lay, ctx.lay.n_model
        return (None, *[fold(gs[g * m:(g + 1) * m], lay.group_dev(g),
                             ctx.dtypes[g]) for g in range(lay.n_groups)])


def replicate(lay: Layout, xs: list) -> list:
    """One tensor a group -> one a position (its model shards' copies)."""
    if lay.n_model == 1:
        return list(xs)
    return list(_Replicate.apply(lay, *xs))


class _ModelSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lay, *parts):
        ctx.lay = lay
        m = lay.n_model
        return tuple(fold(parts[g * m:(g + 1) * m], lay.group_dev(g),
                          parts[g * m].dtype) for g in range(lay.n_groups))

    @staticmethod
    def backward(ctx, *gs):
        lay = ctx.lay
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
        full = torch.cat([x.to(lay.group_dev(0)) for x in xs])
        return tuple(full.to(lay.group_dev(g), copy=True)
                     for g in range(lay.n_groups))

    @staticmethod
    def backward(ctx, *gs):
        lay = ctx.lay
        out, lo = [], 0
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
        return fold(xs, lay.group_dev(0), xs[0].dtype)

    @staticmethod
    def backward(ctx, g):
        lay = ctx.lay
        return (None, *[g.to(lay.group_dev(k))
                        for k in range(lay.n_groups)])


def batch_fold(lay: Layout, xs: list) -> torch.Tensor:
    """One partial a group -> their sum (group order), on the first
    device."""
    if lay.n_groups == 1:
        return xs[0]
    return _BatchFold.apply(lay, *xs)


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

def _use_plan(leaf: Placed, keep: tuple, users: list, lay: Layout):
    """For each user position: (device, shape, [(source position, slices
    of the user's tensor)]). The user's tensor is the leaf's region under
    the use spec (the leaf's spec with only the ``model`` entries of the
    dims in ``keep`` left; a user reads the blocks of the positions that
    share its coordinates on every axis the gathered dims do not name)."""
    mesh, spec, shape = leaf.mesh, leaf.spec, leaf.shape
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
        plan.append((lay.dev(u), ushape, pieces))
    return plan


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, *blocks):
        ctx.plan = plan
        ctx.src = [(b.device, b.dtype) for b in blocks]
        outs = []
        for dev, shape, pieces in plan:
            out = torch.empty(shape, dtype=blocks[0].dtype, device=dev)
            for src, sl in pieces:
                out[sl] = blocks[src].to(dev)
            outs.append(out)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        readers = [[] for _ in ctx.src]
        for g, (_, _, pieces) in zip(gs, ctx.plan):
            for src, sl in pieces:
                readers[src].append(None if g is None else g[sl])
        return (None, *[fold(r, dev, dt) if r else None
                              for r, (dev, dt) in zip(readers, ctx.src)])


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
    plan = _use_plan(leaf, keep, users, lay)
    if all(len(p) == 1 and p[0][0] == u
           and all(s == slice(0, n) for s, n in zip(p[0][1], shape))
           for u, (_, shape, p) in zip(users, plan)) \
            and len(set(users)) == len(users):
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
        tot = fold(parts, dev, _F32) if len(group) > 1 else parts[0]
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
