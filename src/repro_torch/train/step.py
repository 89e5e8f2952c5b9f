"""Training step builder: loss + grad + AdamW, with microbatch gradient
accumulation and optional int8 gradient compression.

Port of `repro.train.step`. ``build_train_step`` returns a function
(state, batch) -> (state, metrics): the gradient comes from
`torch.autograd` on leaf tensors that share the parameters' storage,
remat is already applied inside the model stack, and ``donate`` (the
reference's ``donate_argnums``) updates the state's parameters and
moments in place. The reference jits the step with explicit in/out
shardings over its mesh; the port computes the same shardings
(`state_shardings`, `batch_shardings`) and places the state by them
(`place`): on a mesh of more than one position each parameter and moment
is a `partitioning.Placed` leaf, every block an autograd leaf of the one
graph the mesh program (`models.lm`, `distributed.spmd`) builds. After
the backward each block's replicas' gradients are summed in row-major
order and written to every replica (`spmd.replica_sum`: the ``pod``
gradient sum, and the ``model`` / ``data`` sums of the leaves those axes
replicate), so replicas stay bitwise equal; AdamW then updates each block
(it is element-wise). Grad compression quantizes the logical gradient
(the blocks of the int8 codec are runs of the logical row-major leaf):
the gradients are gathered for the round trip and re-split.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.distributed import partitioning, spmd
from repro_torch.distributed.partitioning import NamedSharding, P, Placed
from repro_torch.models.registry import ModelAPI
from repro_torch.optim import AdamW, AdamWState
from repro_torch.optim import compression as comp


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    comp: Optional[comp.CompressionState]


class _MetaKey(torch.Generator):
    """A generator whose ``device`` is ``meta``: an init drawn from it makes
    tensors of the parameters' shapes and dtypes with no storage (the
    reference's ``jax.eval_shape`` of the init)."""

    @property
    def device(self):
        return torch.device("meta")


def init_state(model: ModelAPI, optimizer: AdamW, key,
               *, grad_compression: bool = False) -> TrainState:
    """``key``: an int seed or a `torch.Generator` (the model's ``init``)."""
    params = model.init(key)
    opt = optimizer.init(params)
    cstate = comp.init_state(params) if grad_compression else None
    return TrainState(params=params, opt=opt, comp=cstate)


def state_struct(model: ModelAPI, optimizer: AdamW, *,
                 grad_compression: bool = False) -> TrainState:
    """The state's structure, shapes and dtypes, on the ``meta`` device."""
    return init_state(model, optimizer, _MetaKey(),
                      grad_compression=grad_compression)


def state_shardings(mesh, state: TrainState) -> TrainState:
    pshard = partitioning.param_shardings(mesh, state.params)
    rep = NamedSharding(mesh, P())
    opt = AdamWState(step=rep,
                     mu=partitioning.param_shardings(mesh, state.opt.mu),
                     nu=partitioning.param_shardings(mesh, state.opt.nu))
    cshard = None
    if state.comp is not None:
        cshard = comp.CompressionState(residual=partitioning.param_shardings(
            mesh, state.comp.residual))
    return TrainState(params=pshard, opt=opt, comp=cshard)


def place(tree, shardings):
    """Each leaf of ``tree`` (tensors or numpy arrays) placed by its
    sharding: on a one-position mesh a tensor on its device (a tensor
    already there is returned as it is), else a `Placed` of contiguous
    block copies (the step updates them in place)."""
    return _tree.tree_map(lambda x, s: s.shard(x, copy=s.mesh.size > 1),
                          tree, shardings)


def _own_blocks(x):
    """A `Placed` leaf whose blocks alias one another (`Placed.aliased`)
    with each block copied, so that the donated update writes every
    replica once; any other leaf as it is."""
    if isinstance(x, Placed) and x.aliased():
        return x.map(lambda b: b.clone(memory_format=torch.contiguous_format))
    return x


def _blockwise(fn, *leaves):
    """``fn`` on tensors, or on every block of `Placed` leaves (at the
    same coordinates), giving a `Placed` like the first."""
    if not isinstance(leaves[0], Placed):
        return fn(*leaves)
    first = leaves[0]
    out = np.empty(first.blocks.shape, dtype=object)
    for c in np.ndindex(out.shape):
        out[c] = fn(*[x.blocks[c] for x in leaves])
    return Placed(first.mesh, first.spec, first.shape, out)


def _logical(x):
    """A batch leaf as one tensor (a placed one unsharded)."""
    return x.unshard() if isinstance(x, Placed) else torch.as_tensor(x)


def build_train_step(model: ModelAPI, optimizer: AdamW, mesh, *,
                     microbatches: int = 1, grad_compression: bool = False,
                     donate: bool = True):
    """Returns (state, batch) -> (state, metrics). ``mesh``: None or a
    `launch.mesh.Mesh`; on more than one position the state is expected
    placed by `state_shardings` (`place`; a state that is not is placed on
    the first call, and a placed leaf whose replicas are views of one
    tensor gets its own blocks before a donated step) and the batch may be host arrays, tensors or placed by
    `batch_shardings`. ``donate``: the returned state's parameters and
    moments are the given state's tensors, updated in place, and the
    gradients are freed once applied; otherwise the given state is left
    as it was. Both give the same bits."""
    multi = mesh is not None and mesh.size > 1

    def grads_of(params, batch):
        """(loss, metrics, float gradients in flatten order) of one batch;
        a placed leaf's gradient is placed, its replicas summed."""
        leaves = _tree.leaves(params)
        new, flat = [], []
        for p in leaves:
            if isinstance(p, Placed):
                q = p.map(lambda b: b.detach().requires_grad_(True))
                flat.extend(q.blocks[c] for c in np.ndindex(q.blocks.shape))
            else:
                q = p.detach().requires_grad_(True)
                flat.append(q)
            new.append(q)
        loss, metrics = model.loss(_tree.unflatten(params, new), batch)
        grads = list(torch.autograd.grad(loss, flat, allow_unused=multi))
        out = []
        for q in new:
            if isinstance(q, Placed):
                coords = list(np.ndindex(q.blocks.shape))
                got = spmd.replica_sum(q, dict(zip(coords, grads[:len(
                    coords)])))
                del grads[:len(coords)]
                arr = np.empty(q.blocks.shape, dtype=object)
                for c in coords:
                    arr[c] = got[c]
                out.append(Placed(q.mesh, q.spec, q.shape, arr))
            else:
                out.append(grads.pop(0))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                out)

    def step(state: TrainState, batch):
        if multi and not isinstance(
                state.params["embedding"]["embed"], Placed):
            state = place(state, state_shardings(mesh, state))
        elif multi and donate:
            state = _tree.tree_map(_own_blocks, state)
        if microbatches > 1:
            # gradient accumulation over microbatch slices of the global
            # batch, in order (on a mesh each slice is cut into the batch
            # groups' rows again)
            def split(x, i):
                x = _logical(x)
                n = x.shape[0] // microbatches
                return x.reshape(microbatches, n, *x.shape[1:])[i]

            gsum, lsum = None, 0.0
            for i in range(microbatches):
                mbatch = {k: split(v, i) for k, v in batch.items()}
                loss_i, _, g = grads_of(state.params, mbatch)
                if gsum is None:
                    gsum = [_blockwise(lambda x: torch.zeros_like(
                        x, dtype=torch.float32) + x, x) for x in g]
                else:
                    gsum = [_blockwise(torch.add, a, x)
                            for a, x in zip(gsum, g)]
                del g
                lsum = lsum + loss_i
            grads = [_blockwise(lambda x: x / microbatches, x)
                     for x in gsum]
            del gsum
            loss = lsum / microbatches
            metrics = {}
        else:
            loss, metrics, grads = grads_of(state.params, batch)
        grads = _tree.unflatten(state.params, grads)

        cstate = state.comp
        if grad_compression and cstate is not None:
            if multi:
                shards = partitioning.param_shardings(mesh, grads)
                grads, cstate = comp.compress_grads(
                    partitioning.unshard(grads),
                    comp.CompressionState(residual=partitioning.unshard(
                        cstate.residual)))
                grads = place(grads, shards)
                cstate = comp.CompressionState(
                    residual=place(cstate.residual, shards))
            else:
                grads, cstate = comp.compress_grads(grads, cstate)

        grad_norm = 0.0
        for g in _tree.leaves(grads):
            grad_norm = grad_norm + spmd.sq_sum(g)
        grad_norm = grad_norm ** 0.5
        params, opt = optimizer.update(grads, state.opt, state.params,
                                       donate=donate)
        del grads
        out_metrics = {"loss": loss, "grad_norm": grad_norm}
        out_metrics.update({k: v for k, v in metrics.items()})
        return TrainState(params=params, opt=opt, comp=cstate), out_metrics

    return step


def batch_shardings(mesh, batch_struct: Any):
    return partitioning.batch_shardings(mesh, batch_struct)
