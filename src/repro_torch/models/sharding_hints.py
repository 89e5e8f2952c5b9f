"""Activation-sharding hints and the mesh context of the language models.

Port of `repro.models.sharding_hints`. The reference anchors GSPMD's
sharding of a few activations and of each weight at its point of use,
under a mesh set by ``activation_sharding(mesh, mode)``. The port has no
GSPMD: its mesh program (`models.lm` on `distributed.spmd`) places every
activation itself -- the batch over the (pod, data) groups, the logits'
vocabulary and the heads / channels / hidden units over the model
shards -- and
gathers each weight at its point of use (`spmd.gather`, cast first, then
gathered over ``data``: the reference's FSDP gather). So here:

* `activation_sharding` sets the mesh for the calls inside it
  (`current`), and the program refuses parameters placed on another
  mesh. The mode is accepted for the reference's signature and checked,
  but not read: the decode step itself tells the MoE layer to keep its
  3-D expert weights in place (`moe.mesh_apply`'s ``decode``), as the
  reference's `fsdp_use` does in decode mode;
* the hints check where their activation lies (a device of the context's
  mesh) and return it;
* `fsdp_use` is what remains of the gather point inside a layer: the cast
  of the weight to the compute dtype (a weight the program has gathered
  is in that dtype already, and the cast returns it as it is).
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Optional

import torch

_CTX: ContextVar[Optional[tuple]] = ContextVar("repro_torch_lm_mesh",
                                               default=None)


@contextlib.contextmanager
def activation_sharding(mesh, mode: str = "train"):
    """The reference's sharding context: ``mesh`` (None or a
    `launch.mesh.Mesh`) and ``mode`` ("train", "prefill" or "decode") for
    the model calls inside it."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    token = _CTX.set(None if mesh is None else (mesh, mode))
    try:
        yield
    finally:
        _CTX.reset(token)


def current() -> Optional[tuple]:
    """(mesh, mode) of the innermost `activation_sharding`, or None."""
    return _CTX.get()


def _check(x: torch.Tensor, what: str) -> torch.Tensor:
    ctx = _CTX.get()
    if ctx is not None and x.device.type != "meta":
        devs = set(ctx[0].devices.flat)
        if x.device not in devs:
            raise RuntimeError(f"{what} on {x.device}, outside {ctx[0]}")
    return x


def hint_logits(x: torch.Tensor) -> torch.Tensor:
    """(..., S, V): a batch group's rows, a model shard's vocabulary."""
    return _check(x, "logits")


def hint_activations(x: torch.Tensor) -> torch.Tensor:
    """(B, S, D): a batch group's rows, on its position's device."""
    return _check(x, "activations")


def fsdp_use(w: torch.Tensor, name: str, dtype=None) -> torch.Tensor:
    """A weight at its point of use: cast to ``dtype`` (a new tensor each
    call, as the reference's cast before its FSDP gather), or ``w`` itself
    when ``dtype`` is None or already ``w``'s."""
    del name                      # the partitioning rule's key
    return w if dtype is None else w.to(dtype)


def hint_moe_tokens(x: torch.Tensor, replicate_at_decode: bool = True
                    ) -> torch.Tensor:
    """MoE dispatch / output buffers (B, E, C, D): a batch group's."""
    return _check(x, "MoE tokens")


def hint_moe_hidden(x: torch.Tensor, replicate_at_decode: bool = True
                    ) -> torch.Tensor:
    """MoE expert hidden (B, E, C, F): a model shard's hidden units."""
    return _check(x, "MoE hidden")
