"""Training step builder: loss + grad + AdamW, with microbatch gradient
accumulation and optional int8 gradient compression.

Port of `repro.train.step`. ``build_train_step`` returns a function
(state, batch) -> (state, metrics) on one device: the gradient comes from
`torch.autograd` on leaf tensors that share the parameters' storage,
remat is already applied inside the model stack, and ``donate`` (the
reference's ``donate_argnums``) updates the state's parameters and
moments in place. The reference jits the step with explicit in/out
shardings over its mesh; the port computes the same shardings
(`state_shardings`, `batch_shardings`) and places nothing over more than
one position (ROADMAP Queue 1 item 5d): a larger mesh is refused.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch import _tree
from repro_torch.distributed import partitioning
from repro_torch.distributed.partitioning import P, NamedSharding
from repro_torch.models.registry import ModelAPI
from repro_torch.models.sharding_hints import check_one_device
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
    """Each leaf of ``tree`` (tensors or numpy arrays) as a tensor on its
    sharding's device; a tensor already there is returned as it is."""
    return _tree.tree_map(lambda x, s: torch.as_tensor(x).to(s.device()),
                          tree, shardings)


def build_train_step(model: ModelAPI, optimizer: AdamW, mesh, *,
                     microbatches: int = 1, grad_compression: bool = False,
                     donate: bool = True):
    """Returns (state, batch) -> (state, metrics). ``mesh``: None or a
    one-position `launch.mesh.Mesh`. ``donate``: the returned state's
    parameters and moments are the given state's tensors, updated in place,
    and the gradients are freed once applied; otherwise the given state is
    left as it was. Both give the same bits."""
    check_one_device(mesh, "build_train_step")

    def grads_of(params, batch):
        """(loss, metrics, float gradients in flatten order) of one batch."""
        leaves = [p.detach().requires_grad_(True)
                  for p in _tree.leaves(params)]
        loss, metrics = model.loss(_tree.unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                list(grads))

    def step(state: TrainState, batch):
        if microbatches > 1:
            # gradient accumulation over microbatch slices, in order
            def split(x, i):
                x = torch.as_tensor(x)
                n = x.shape[0] // microbatches
                return x.reshape(microbatches, n, *x.shape[1:])[i]

            gsum, lsum = None, 0.0
            for i in range(microbatches):
                mbatch = {k: split(v, i) for k, v in batch.items()}
                loss_i, _, g = grads_of(state.params, mbatch)
                if gsum is None:
                    gsum = [torch.zeros_like(x, dtype=torch.float32) + x
                            for x in g]
                else:
                    gsum = [a + x for a, x in zip(gsum, g)]
                del g
                lsum = lsum + loss_i
            grads = [x / microbatches for x in gsum]
            del gsum
            loss = lsum / microbatches
            metrics = {}
        else:
            loss, metrics, grads = grads_of(state.params, batch)
        grads = _tree.unflatten(state.params, grads)

        cstate = state.comp
        if grad_compression and cstate is not None:
            grads, cstate = comp.compress_grads(grads, cstate)

        grad_norm = 0.0
        for g in _tree.leaves(grads):
            grad_norm = grad_norm + torch.sum(torch.square(
                g.to(torch.float32)))
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
