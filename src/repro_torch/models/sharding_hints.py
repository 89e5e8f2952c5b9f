"""Activation-sharding hints, on one device.

Port of `repro.models.sharding_hints`. The reference anchors GSPMD's
sharding of a few activations and of each weight at its point of use,
under a mesh set by ``activation_sharding(mesh)``. The port serves a
language model on one device: every hint is the identity, and
`fsdp_use` is what remains of the reference's FSDP gather point, the
cast of the (float32) weight to the compute dtype at every use.

A mesh of more than one position is refused: the sharding rules are
ported (`distributed/partitioning.py`), but placing a language model over
devices is not yet (ROADMAP Queue 1 item 5d, the multi-device LM mesh).
"""
from __future__ import annotations

import contextlib

import torch


def check_one_device(mesh, what: str) -> None:
    """Raise unless ``mesh`` is None or has one position."""
    if mesh is not None and mesh.size != 1:
        raise NotImplementedError(
            f"{what} on {mesh}: a language model runs on one device in the "
            f"port; its sharding rules are ported (distributed/"
            f"partitioning.py), placing it over a mesh is ROADMAP Queue 1 "
            f"item 5d, the multi-device LM mesh")


@contextlib.contextmanager
def activation_sharding(mesh, mode: str = "train"):
    """The reference's sharding context. ``mesh`` is None or the port's
    one-position `launch.mesh.Mesh`; ``mode`` ("train", "prefill" or
    "decode") changes nothing on one device."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    check_one_device(mesh, "activation_sharding")
    yield


def hint_logits(x: torch.Tensor) -> torch.Tensor:
    """(..., S, V): the identity on one device."""
    return x


def hint_activations(x: torch.Tensor) -> torch.Tensor:
    """(B, S, D): the identity on one device."""
    return x


def fsdp_use(w: torch.Tensor, name: str, dtype=None) -> torch.Tensor:
    """A weight at its point of use: cast to ``dtype`` (a new tensor each
    call, as the reference's cast before its FSDP gather), or ``w`` itself
    when ``dtype`` is None or already ``w``'s."""
    del name                      # the partitioning rule's key; one device
    return w if dtype is None else w.to(dtype)


def hint_moe_tokens(x: torch.Tensor, replicate_at_decode: bool = True
                    ) -> torch.Tensor:
    """MoE dispatch / output buffers (B, E, C, D): the identity."""
    return x


def hint_moe_hidden(x: torch.Tensor, replicate_at_decode: bool = True
                    ) -> torch.Tensor:
    """MoE expert hidden (B, E, C, F): the identity."""
    return x
