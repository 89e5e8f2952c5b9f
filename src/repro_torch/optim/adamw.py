"""AdamW with decoupled weight decay + global-norm clipping (trees of tensors).

Port of `repro.optim.adamw`. No `torch.optim`: its AdamW (and its fused
and foreach paths) decays the weights before the moment update and
orders the operations differently; this one keeps the reference's
sequence, leaf by leaf. The state is a plain tree, so the sharding rules
(`distributed.partitioning`) apply verbatim to the moments (same shapes
as the parameters). On a mesh the leaves are `partitioning.Placed`: the
global norm folds each leaf's distinct blocks, and the update, being
element-wise, runs block by block, each block's bits the logical
update's.

``update(..., donate=True)`` writes the new parameters and moments into
the given tensors' buffers (the reference's donated buffers) and returns
those tensors; ``donate=False`` returns new tensors and leaves its inputs
as they were. Both compute the same bits.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.distributed import spmd
from repro_torch.distributed.partitioning import Placed

_F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any       # first moment, same tree as params
    nu: Any       # second moment


class AdamW(NamedTuple):
    init: Callable[[Any], AdamWState]
    update: Callable[..., tuple[Any, AdamWState]]


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the leaves' float32 squared sums, added in flatten order (a
    placed leaf's distinct blocks folded in row-major order first)."""
    total = sum(spmd.sq_sum(x) for x in _tree.leaves(tree))
    return torch.sqrt(torch.as_tensor(total, dtype=_F32))


def _near(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return t if t.device == dev else t.to(dev)


def adamw(lr: float | Callable[[torch.Tensor], torch.Tensor], *,
          b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip_norm: float = 1.0) -> AdamW:
    def lr_fn(step):
        if callable(lr):
            return lr(step)
        return torch.full((), lr, dtype=_F32, device=step.device)

    def init(params: Any) -> AdamWState:
        leaves = _tree.leaves(params)
        dev = None
        if leaves:
            dev = leaves[0].mesh.device() if isinstance(leaves[0], Placed) \
                else leaves[0].device

        def zeros(p):
            if isinstance(p, Placed):
                return p.map(lambda b: torch.zeros_like(b, dtype=_F32))
            return torch.zeros_like(p, dtype=_F32)

        return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                           device=dev),
                          mu=_tree.tree_map(zeros, params),
                          nu=_tree.tree_map(zeros, params))

    def update(grads: Any, state: AdamWState, params: Any, *,
               donate: bool = False) -> tuple[Any, AdamWState]:
        step = state.step + 1
        gnorm = global_norm(grads)
        # a tensor numerator: ``float / tensor`` multiplies by a reciprocal
        scale = torch.clamp_max(
            torch.full((), clip_norm, dtype=_F32, device=gnorm.device)
            / torch.clamp_min(gnorm, 1e-9), 1.0)
        lr_t = lr_fn(step)
        c1 = 1.0 - b1 ** step.to(_F32)
        c2 = 1.0 - b2 ** step.to(_F32)

        def upd(g, m, v, p):
            if isinstance(p, Placed):         # element-wise: block by block
                outs = {c: upd(g.blocks[c], m.blocks[c], v.blocks[c],
                               p.blocks[c])
                        for c in np.ndindex(p.blocks.shape)}
                res = []
                for k, like in enumerate((p, m, v)):
                    arr = np.empty(p.blocks.shape, dtype=object)
                    for c, o in outs.items():
                        arr[c] = o[k]
                    res.append(Placed(like.mesh, like.spec, like.shape, arr))
                return tuple(res)
            dev = p.device
            g = g.to(_F32) * _near(scale, dev)
            m = torch.add(b1 * m, (1.0 - b1) * g, out=m if donate else None)
            v = torch.add(b2 * v, (1.0 - b2) * g * g,
                          out=v if donate else None)
            mh = m / _near(c1, dev)
            denom = torch.sqrt(v / _near(c2, dev)).add_(eps)
            step_val = mh.div_(denom).add_(weight_decay * p.to(_F32))
            p = torch.sub(p, _near(lr_t, dev) * step_val.to(p.dtype),
                          out=p if donate else None).to(p.dtype)
            return p, m, v

        out = [upd(*leaves) for leaves in zip(
            _tree.leaves(grads), _tree.leaves(state.mu),
            _tree.leaves(state.nu), _tree.leaves(params), strict=True)]
        new_params = _tree.unflatten(params, [o[0] for o in out])
        new_mu = _tree.unflatten(state.mu, [o[1] for o in out])
        new_nu = _tree.unflatten(state.nu, [o[2] for o in out])
        return new_params, AdamWState(step=step, mu=new_mu, nu=new_nu)

    return AdamW(init=init, update=update)
