"""Elastic mesh derivation: pick a (pod, data, model) factoring for whatever
device count survives.

Port of `repro.distributed.elastic`. `mesh_shape` is the reference's pure
factoring rule, copied verbatim; `remesh` builds it as a
`launch.mesh.Mesh` over the visible cards, or over ``devices`` (which may
repeat a device, see `launch.mesh.make_mesh`).
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.launch.mesh import Mesh, make_mesh


def mesh_shape(num_devices: int, *, model_parallelism: int = 16,
               pod_size: int = 256) -> tuple[tuple[int, ...],
                                             tuple[str, ...]]:
    """The factoring rule of `remesh`, device-free: (shape, axis names).

    pods = devices // pod_size (multi-pod if >= 2), model = requested TP
    halved until it divides the device count, data = the rest. Remainder
    devices are dropped (hot spares). ``num_devices`` must
    be >= 1; a non-positive ``model_parallelism`` is clamped to 1 (no
    tensor parallelism) instead of dividing by zero."""
    if num_devices < 1:
        raise ValueError(
            f"cannot mesh {num_devices} devices (need at least 1)")
    model = max(int(model_parallelism), 1)
    while model > 1 and num_devices % model:
        model //= 2
    usable = num_devices - (num_devices % model)
    chips = usable
    pods = max(chips // pod_size, 1) if chips >= 2 * pod_size else 1
    while pods > 1 and (chips % pods or (chips // pods) % model):
        pods -= 1
    data = chips // (pods * model)
    if pods > 1:
        return (pods, data, model), ("pod", "data", "model")
    return (data, model), ("data", "model")


def remesh(num_devices: int, *, model_parallelism: int = 16,
           pod_size: int = 256, devices: Sequence | None = None) -> Mesh:
    """Largest usable mesh for ``num_devices`` (see `mesh_shape` for the
    factoring rule) over the first visible cards, or over the first of
    ``devices``."""
    shape, names = mesh_shape(num_devices,
                              model_parallelism=model_parallelism,
                              pod_size=pod_size)
    n = 1
    for s in shape:
        n *= s
    return make_mesh(shape, names,
                     devices=None if devices is None else list(devices)[:n])
