"""Parameter / activation sharding rules (named axes only).

Port of `repro.distributed.partitioning`. Scheme:
  * ``model`` axis: tensor parallelism -- attention heads, FFN hidden, MoE
    expert hidden, vocab dim of the embedding table.
  * ``data`` axis: FSDP -- the non-TP axis of every large matrix is sharded
    over data too (params + AdamW moments).
  * ``pod`` axis: pure DP across pods -- params are NOT sharded over pod, so
    the only cross-pod traffic is the gradient all-reduce (int8
    compression hooks in `optim.compression`).

Rules are by leaf *name* and rank; stacked-unit leaves (extra leading
axes) get their spec left-padded with None. The specs are pure functions
of names, ranks, shapes and the mesh's axis sizes, equal to the
reference's on any mesh shape. The port has no GSPMD: `P` is a tuple of
per-dimension entries (canonicalized as ``jax.sharding.PartitionSpec``
canonicalizes them) and `NamedSharding` pairs a spec with a
`launch.mesh.Mesh`.

Placement: `NamedSharding.shard` cuts a logical tensor by its (sanitized)
spec into one block a mesh position, on that position's device, and
returns a `Placed` record (mesh, spec, logical shape, the object array of
blocks); a replicated axis (``pod`` always) holds one copy a position. On
a one-position mesh the single block is the tensor itself, on its device:
no record, no copy. A 0-d leaf (the optimizer's step) is one number, held
once on the mesh's first device. `shard` / `unshard` do the same for
trees. The mesh program that computes on the blocks is
`distributed.spmd`.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import _tree


def _canonical(entry):
    """None, an axis name, or a tuple of two or more axis names (a
    one-name tuple is the name, an empty one None)."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        if not entry:
            return None
        return entry[0] if len(entry) == 1 else entry
    return entry


class P(tuple):
    """A partition spec: one entry a dimension (None, an axis name or a
    tuple of axis names)."""

    def __new__(cls, *partitions):
        return super().__new__(cls, tuple(_canonical(p) for p in partitions))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _axes(entry) -> tuple:
    """The mesh axes of one spec entry, in order."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def block_slices(mesh, spec, shape, coords) -> tuple:
    """The slices of a logical tensor of ``shape`` that the position at
    ``coords`` (one index an axis of ``mesh``) holds under ``spec``: a dim
    split over axes (a0, a1, ...) is cut into prod(sizes) equal blocks,
    indexed row major over those axes' coordinates."""
    at = dict(zip(mesh.axis_names, coords))
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        k, b = 1, 0
        for a in _axes(entry):
            b = b * mesh.shape[a] + int(at[a])
            k *= mesh.shape[a]
        out.append(slice(b * (n // k), (b + 1) * (n // k)))
    return tuple(out)


class Placed:
    """A logical tensor placed on a mesh of more than one position.

    ``mesh``, ``spec`` (sanitized against ``shape``), ``shape`` (the
    logical shape) and ``blocks``: an object ndarray of the mesh's shape,
    one tensor a position, on that position's device, holding
    `block_slices` of the logical tensor. Positions that differ only on
    axes the spec does not name hold equal blocks (replicas)."""

    __slots__ = ("mesh", "spec", "shape", "blocks")

    def __init__(self, mesh, spec: P, shape, blocks: np.ndarray):
        self.mesh = mesh
        self.spec = spec
        self.shape = torch.Size(shape)
        self.blocks = blocks

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks.flat[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def block(self, coords) -> torch.Tensor:
        return self.blocks[tuple(coords)]

    def map(self, fn) -> "Placed":
        """``fn`` on every block (a shape-preserving op)."""
        out = np.empty(self.blocks.shape, dtype=object)
        for c in np.ndindex(self.blocks.shape):
            out[c] = fn(self.blocks[c])
        return Placed(self.mesh, self.spec, self.shape, out)

    def unbind0(self) -> list:
        """The leaf's slices along an unsharded leading axis (the stacked
        units), as views of the blocks, from one ``unbind`` a block."""
        if self.spec and self.spec[0] is not None:
            raise ValueError(f"leading axis sharded: {self.spec}")
        n = self.shape[0]
        parts = {c: self.blocks[c].unbind(0)
                 for c in np.ndindex(self.blocks.shape)}
        out = []
        for u in range(n):
            arr = np.empty(self.blocks.shape, dtype=object)
            for c, p in parts.items():
                arr[c] = p[u]
            out.append(Placed(self.mesh, P(*self.spec[1:]), self.shape[1:],
                              arr))
        return out

    def unique(self) -> list:
        """The coordinates of one position a distinct block (the first of
        its replicas, row major), in row-major order."""
        seen, out = set(), []
        for c in np.ndindex(self.blocks.shape):
            key = block_slices(self.mesh, self.spec, self.shape, c)
            key = tuple((s.start, s.stop) for s in key)
            if key not in seen:
                seen.add(key)
                out.append(c)
        return out

    def replica_sets(self) -> list:
        """Lists of the coordinates that hold the same block, each in row
        major order (the order a replica sum folds in)."""
        sets: dict = {}
        for c in np.ndindex(self.blocks.shape):
            key = tuple((s.start, s.stop) for s in block_slices(
                self.mesh, self.spec, self.shape, c))
            sets.setdefault(key, []).append(c)
        return list(sets.values())

    def aliased(self) -> bool:
        """Whether two blocks begin at one address of one device: replicas
        that are views of one tensor (`NamedSharding.shard` without
        ``copy``), which an in-place update would write more than once."""
        seen = set()
        for b in self.blocks.flat:
            if b.numel():
                key = (b.device, b.data_ptr())
                if key in seen:
                    return True
                seen.add(key)
        return False

    def unshard(self, device=None) -> torch.Tensor:
        """The logical tensor on ``device`` (the mesh's first device by
        default), assembled from one block a distinct slice."""
        dev = torch.device(device) if device is not None \
            else self.mesh.device()
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for c in self.unique():
            out[block_slices(self.mesh, self.spec, self.shape, c)] = \
                self.blocks[c].to(dev)
        return out

    def __repr__(self) -> str:
        return (f"Placed({tuple(self.shape)}, {self.dtype}, {self.spec!r}, "
                f"{self.mesh!r})")


class NamedSharding:
    """A spec over a mesh's named axes."""

    def __init__(self, mesh, spec: P):
        self.mesh = mesh
        self.spec = spec

    def device(self) -> torch.device:
        """The device of a one-position mesh (a larger mesh has one device
        a position: `shard`)."""
        if self.mesh.size != 1:
            raise ValueError(f"{self.mesh} has {self.mesh.size} positions: "
                             f"NamedSharding.shard places a tensor on it")
        return self.mesh.device()

    def shard(self, x, *, copy: bool = False):
        """``x`` (a tensor or a numpy array) placed by this sharding.

        One position (or a 0-d leaf): the tensor on the mesh's first
        device, ``x`` itself when it is there. Otherwise a `Placed` whose
        blocks are views of ``x`` where a position's device is ``x``'s and
        ``copy`` is false, else contiguous copies (a donated train step
        updates its blocks in place, so they must not share storage)."""
        x = torch.as_tensor(x)
        if self.mesh.size == 1 or x.ndim == 0:
            dev = self.mesh.device()
            if copy and x.device == dev:
                return x.clone()
            return x.to(dev)
        spec = sanitize_spec(self.mesh, P(*self.spec), x.shape)
        blocks = np.empty(self.mesh.devices.shape, dtype=object)
        for c in np.ndindex(blocks.shape):
            dev = self.mesh.devices[c]
            b = x[block_slices(self.mesh, spec, x.shape, c)]
            if b.device == dev and not copy:
                blocks[c] = b
            else:
                blocks[c] = b.to(dev, copy=True,
                                 memory_format=torch.contiguous_format)
        return Placed(self.mesh, spec, x.shape, blocks)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def shard(tree: Any, shardings: Any, *, copy: bool = False) -> Any:
    """Each leaf of ``tree`` placed by the sharding at its place in
    ``shardings`` (`NamedSharding.shard`); a leaf already `Placed` on that
    mesh is returned as it is, one placed on another mesh is re-placed
    through its logical tensor."""
    def one(x, s):
        if isinstance(x, Placed):
            if x.mesh is s.mesh:
                return x
            x = x.unshard()
        return s.shard(x, copy=copy)
    return _tree.tree_map(one, tree, shardings)


def unshard(tree: Any, device=None) -> Any:
    """Every `Placed` leaf of ``tree`` as its logical tensor on ``device``
    (the mesh's first device by default); other leaves unchanged."""
    return _tree.tree_map(
        lambda x: x.unshard(device) if isinstance(x, Placed) else x, tree)


# leaf-name -> base spec (by decreasing specificity)
_RULES: dict[str, P] = {
    # embeddings
    "embed": P("model", "data"),          # (V, D): vocab TP + d FSDP
    "unembed": P("data", "model"),        # (D, V)
    "pos": P(None, "data"),
    "enc_pos": P(None, "data"),
    "frame_adapter": P("data", "model"),
    # attention
    "wq": P("data", "model"),
    "wk": P("data", "model"),
    "wv": P("data", "model"),
    "wo": P("model", "data"),
    # mla
    "wq_down": P("data", None),
    "wq_up": P(None, "model"),
    "wkv_down": P("data", None),
    "wkv_up": P(None, "model"),
    # mlp
    "wi_gate": P("data", "model"),
    "wi_up": P("data", "model"),
    "wi": P("data", "model"),
    "bi": P("model"),
    "bo": P("data"),
    # moe (3D expert weights get the extra expert axis unsharded)
    "router": P("data", None),
    # rglru / xlstm
    "w_gate": P("data", "model"),
    "w_in": P("data", "model"),
    "w_up": P("data", "model"),
    "w_a": P("model", "data"),
    "w_x": P("model", "data"),
    "w_out": P("model", "data"),
    "w_down": P("model", "data"),
    "w_if": P("data", None),
    "w": P("data", "model"),
    "conv_w": P(None, "model"),
}

# MoE expert tensors are 3D -- matched by name with explicit 3D specs
_RULES_3D: dict[str, P] = {
    "wi_gate": P(None, "data", "model"),
    "wi_up": P(None, "data", "model"),
    "wo": P(None, "model", "data"),
}


def _leaf_name(path) -> str:
    for entry in reversed(path):
        if isinstance(entry, _tree.DictKey):
            return str(entry.key)
        if isinstance(entry, _tree.GetAttrKey):
            return str(entry.name)
    return ""


def spec_for(path, leaf) -> P:
    name = _leaf_name(path)
    ndim = getattr(leaf, "ndim", 0)
    base = None
    if ndim >= 3 and name in _RULES_3D:
        base = _RULES_3D[name]
    elif name in _RULES:
        base = _RULES[name]
    if base is None:
        return P(*([None] * ndim))
    pad = ndim - len(base)
    if pad < 0:  # rank-reduced leaf (e.g. biases sharing a rule name)
        return P(*([None] * ndim))
    return P(*([None] * pad), *base)


def sanitize_spec(mesh, spec: P, shape) -> P:
    """Drop axis assignments whose dimension is not evenly divisible: any
    dim that does not divide by its mesh-axis product falls back to
    replication on that dim -- e.g. minicpm3's vocab 73448 over model=16,
    mixtral's 8 kv heads over 16 chips, or long_500k's batch=1 over (pod,
    data)."""
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(None if i >= len(shape) else entry)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        factor = 1
        for a in axes:
            factor *= mesh.shape[a]
        out.append(entry if shape[i] % factor == 0 else None)
    # pad missing trailing dims
    out += [None] * (len(shape) - len(out))
    return P(*out)


def param_specs(params: Any) -> Any:
    """Tree of `P` mirroring ``params``."""
    return _tree.tree_map_with_path(spec_for, params)


def param_shardings(mesh, params: Any) -> Any:
    return _tree.tree_map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, sanitize_spec(mesh, spec_for(path, leaf),
                                getattr(leaf, "shape", ()))),
        params)


def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes that shard the global batch (pod first if present)."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def batch_spec(mesh, ndim: int) -> P:
    """Batch tensors: leading axis over (pod, data), rest replicated."""
    return P(batch_axes(mesh), *([None] * (ndim - 1)))


def batch_shardings(mesh, batch: Any) -> Any:
    return _tree.tree_map(
        lambda x: NamedSharding(
            mesh, sanitize_spec(mesh, batch_spec(mesh, x.ndim), x.shape)),
        batch)


def cache_shardings(mesh, cache: Any) -> Any:
    """Decode-cache shardings, type-aware.

    * attention KVCache k/v (B, S, KV, hd): batch over (pod, data), KV heads
      over ``model`` when they divide it, else the sequence when it does,
      else replicated over model.
    * MLA latent caches (shared across heads): batch, and the sequence
      over ``model`` when divisible -- the latent cannot shard by head.
    * recurrent states (RG-LRU / xLSTM): batch over (pod, data); mLSTM's
      (B, H, hd, hd) matrix state also shards heads over ``model`` (or its
      head_dim rows when the heads do not divide it).
    * positions (the port's Python ints, the reference's scalars) and
      tiny leaves: replicated.

    Works on caches of ``meta`` tensors; dispatch is by the cache's
    NamedTuple types.
    """
    from repro_torch.models.layers.attention import KVCache
    from repro_torch.models.layers.mla import MLACache
    from repro_torch.models.layers.rglru import RGLRUState
    from repro_torch.models.layers.xlstm import MLSTMState, SLSTMState

    axes = batch_axes(mesh)
    model_size = mesh.shape.get("model", 1)

    def pad(spec_tail, leaf, base_ndim):
        """Left-pad with None for stacked leading axes, then sanitize
        against the leaf's actual shape."""
        extra = getattr(leaf, "ndim", 0) - base_ndim
        spec = P(*([None] * extra), *spec_tail)
        return NamedSharding(
            mesh, sanitize_spec(mesh, spec, getattr(leaf, "shape", ())))

    def walk(node):
        if isinstance(node, KVCache):
            kv_heads = node.k.shape[-2]
            buf = node.k.shape[-3]
            if kv_heads % model_size == 0:
                kv_spec = (axes, None, "model", None)
            elif buf % model_size == 0:
                kv_spec = (axes, "model", None, None)
            else:
                kv_spec = (axes, None, None, None)
            return KVCache(k=pad(kv_spec, node.k, 4),
                           v=pad(kv_spec, node.v, 4),
                           pos=pad((), node.pos, 0))
        if isinstance(node, MLACache):
            seq = node.c_kv.shape[-2]
            sspec = "model" if seq % model_size == 0 else None
            return MLACache(c_kv=pad((axes, sspec, None), node.c_kv, 3),
                            k_rope=pad((axes, sspec, None), node.k_rope, 3),
                            pos=pad((), node.pos, 0))
        if isinstance(node, RGLRUState):
            return RGLRUState(h=pad((axes, "model"), node.h, 2),
                              conv=pad((axes, None, "model"), node.conv, 3),
                              pos=pad((), node.pos, 0))
        if isinstance(node, MLSTMState):
            h = node.c.shape[-3]
            hspec = "model" if h % model_size == 0 else None
            dspec = "model" if hspec is None else None
            return MLSTMState(c=pad((axes, hspec, dspec, None), node.c, 4),
                              n=pad((axes, hspec, dspec), node.n, 3),
                              m=pad((axes, None), node.m, 2),
                              conv=pad((axes, None, None), node.conv, 3),
                              pos=pad((), node.pos, 0))
        if isinstance(node, SLSTMState):
            return SLSTMState(h=pad((axes, "model"), node.h, 2),
                              c=pad((axes, "model"), node.c, 2),
                              n=pad((axes, "model"), node.n, 2),
                              m=pad((axes, "model"), node.m, 2),
                              pos=pad((), node.pos, 0))
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k in ("cross_k", "cross_v"):   # (L, B, Tenc, KV, hd)
                    out[k] = pad((axes, None, "model", None), v, 4)
                elif k == "pos":
                    out[k] = pad((), v, 0)
                else:
                    out[k] = walk(v)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        # a bare leaf: replicated (the reference's fallback means this but
        # raises a TypeError; no cache of the ten configs reaches it)
        return pad((), node, 0)

    return walk(cache)
