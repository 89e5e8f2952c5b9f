"""Device meshes for the single-controller multi-device service.

Port of `repro.launch.mesh`. The reference builds a `jax.sharding.Mesh`
and runs shard_map programs on it; the port has no SPMD compiler, so a
mesh is a plain object: named axes and an array of `torch.device`, one a
position. One Python process owns every position and runs the shards in
lockstep (`core.distributed`), the collectives written as device-to-device
copies and fixed-order sums.

A dry run (`launch.dryrun`) builds meshes of ``meta:i`` devices: card i
of a production mesh, holding shapes and no data. A meta tensor reports no
index, so it lies on every meta position (`check_placement`); positions
stay distinct devices, so nothing is shared between them as logical
shards of one card share it.

A position's device may repeat: ``make_mesh((4, 1), ("data", "model"),
devices=[torch.device("cuda:0")] * 4)`` puts four logical shards on one
card (the port's counterpart of the reference's forced host device
count), ``[torch.device("cpu")] * 4`` four on the CPU. A repeated device is
built only when the caller lists it; ``devices=None`` takes distinct
visible cards and raises when there are too few.

The layout of a mesh program lives here too: `shard_grid` maps (doc
shard, model shard) to a device, `on_device` makes a position's device
current for its launches and `check_placement` holds per-shard tensors to
their positions. A one-device caller runs on `one_device_mesh`, the
(1, 1) mesh of its device.

Single-pod production shape: (data=16, model=16) = 256 cards; multi-pod:
(pod=2, data=16, model=16) = 512.
"""
from __future__ import annotations

import contextlib
import math
import types
from typing import Sequence

import numpy as np
import torch


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current device>`` and ``cpu:0`` -> ``cpu``: a
    position's device must compare equal to its tensors' devices, and
    tensors report their card's index and no CPU index."""
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device()
                            if torch.cuda.is_available() else 0)
    return dev


class Mesh:
    """Named axes over an object array of `torch.device`.

    ``axis_names``: the axes, in order; ``shape``: axis name -> size (a
    read-only mapping, ``mesh.shape["model"]`` as in the reference);
    ``devices``: the (*sizes) object ndarray of devices; ``size``: the
    number of positions. `device` gives the device of one position.
    """

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"devices of shape {devices.shape} do not "
                             f"match axes {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names repeat: {axis_names}")
        self.devices = np.empty(devices.shape, dtype=object)
        for pos in np.ndindex(devices.shape):
            self.devices[pos] = _indexed(torch.device(devices[pos]))
        self.axis_names = axis_names
        self.shape = types.MappingProxyType(
            dict(zip(axis_names, devices.shape)))
        self.size = int(devices.size)

    def device(self, *index: int) -> torch.device:
        """The device of the position ``index`` (one int an axis, in
        ``axis_names`` order; no index: the first position)."""
        if not index:
            return self.devices.flat[0]
        return self.devices[tuple(index)]

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({dims}; {sorted({str(d) for d in self.devices.flat})})"


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Sequence | None = None) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes``.

    ``devices=None``: the first ``prod(shape)`` visible CUDA devices,
    distinct; fewer visible cards raise. An explicit ``devices`` list (row
    major over ``shape``) may repeat a device (several shards on one card,
    or all on the CPU)."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(tuple(axes)) or any(s < 1 for s in shape):
        raise ValueError(f"bad mesh shape {shape} for axes {tuple(axes)}")
    n = math.prod(shape)
    if devices is None:
        visible = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if visible < n:
            raise RuntimeError(
                f"a mesh of {shape} needs {n} CUDA devices, {visible} are "
                f"visible; pass devices= to place several shards on one "
                f"device")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = list(devices)
    if len(devices) != n:
        raise ValueError(f"a mesh of {shape} needs {n} devices, got "
                         f"{len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return Mesh(arr.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Sequence | None = None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices=devices)


def one_device_mesh(device) -> Mesh:
    """The (1, 1) ("data", "model") mesh of one device: the layout of
    every caller that passes no mesh."""
    return make_mesh((1, 1), ("data", "model"), devices=[device])


def resolve_device(name) -> torch.device:
    """``name`` (a launcher's or an example's ``--device``) as a torch
    device; a card that is not there raises: nothing falls back to the
    CPU unless the caller asks for it."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs an NVIDIA GPU; pass "
                           "--device cpu for the plain PyTorch versions")
    return dev


def logical_devices(device="cuda", n: int = 0) -> list[torch.device]:
    """``n`` logical devices of ``device``'s type, for a mesh: placed
    round-robin on the visible cards (several shards on one card where
    ``n`` exceeds them), or ``n`` times the CPU; ``n = 0``: one a visible
    card (the CPU: one). Raises as `resolve_device` does."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        visible = torch.cuda.device_count()
        return [torch.device("cuda", i % visible)
                for i in range(n or visible)]
    return [dev] * (n or 1)


def shard_grid(mesh: Mesh, doc_axes: Sequence[str] = ("data",),
               model_axis: str = "model") -> np.ndarray:
    """The (D, S) object array of devices of a mesh program: position
    (d, s) is doc shard ``d`` (row major over ``doc_axes``) and model shard
    ``s``. Every other axis of the mesh is replicated; its first position
    stands for it."""
    names = mesh.axis_names
    for a in (*doc_axes, model_axis):
        if a not in names:
            raise ValueError(f"mesh axes {names} lack {a!r}")
    doc_sizes = [mesh.shape[a] for a in doc_axes]
    grid = np.empty((math.prod(doc_sizes), mesh.shape[model_axis]), object)
    for d in range(grid.shape[0]):
        at = dict(zip(doc_axes, np.unravel_index(d, doc_sizes)))
        for s in range(grid.shape[1]):
            at[model_axis] = s
            grid[d, s] = mesh.devices[tuple(int(at.get(a, 0))
                                            for a in names)]
    return grid


_CURRENT = contextlib.nullcontext()


def on_device(dev: torch.device):
    """Make ``dev`` the current CUDA device for the launches of one shard
    (the kernels launch on the current device's stream); nothing to do
    where it is current already."""
    if dev.type == "cuda" and dev.index != torch.cuda.current_device():
        return torch.cuda.device(dev)
    return _CURRENT


def _lies_on(t: torch.Tensor, dev: torch.device) -> bool:
    """A tensor on a position's device; a meta tensor (no index) on any
    meta position."""
    return t.device == dev or (t.device.type == dev.type == "meta"
                               and t.device.index is None)


def check_placement(grid: np.ndarray, blocks, what: str) -> None:
    """Raise unless every per-shard tensor lies on its position's device.

    ``blocks``: a (D, S) object array like ``grid`` (one tensor a
    position), a sequence of S model-shard tensors (they belong on the
    first doc shard's devices, ``grid[0, s]``), or a dict keyed by
    (model shard, device) whose values are tensors or tuples of them."""
    wrong = []
    if isinstance(blocks, dict):
        for (s, dev), val in blocks.items():
            for t in (val if isinstance(val, tuple) else (val,)):
                if not _lies_on(t, dev):
                    wrong.append(f"shard {s} for {dev}: on {t.device}")
    elif isinstance(blocks, np.ndarray):
        for pos in np.ndindex(grid.shape):
            if not _lies_on(blocks[pos], grid[pos]):
                wrong.append(f"{pos}: on {blocks[pos].device}, "
                             f"position on {grid[pos]}")
    else:
        for s, t in enumerate(blocks):
            if not _lies_on(t, grid[0, s]):
                wrong.append(f"model shard {s}: on {t.device}, position on "
                             f"{grid[0, s]}")
    if wrong:
        raise RuntimeError(f"{what} misplaced on the mesh: "
                           + "; ".join(wrong))
