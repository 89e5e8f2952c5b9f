"""Sharded, async checkpointing (msgpack, optionally zstd; no orbax).

Port of `repro.checkpoint.checkpointer`, on the reference's on-disk
format, so either package restores the other's directories. Layout per
step:  <dir>/step_<n>/
    meta.json            step, mesh signature, tree structure hash, the
                         shard's byte count and sha256
    shard_<p>.msgpack[.zst]  one file per host process (p = 0 here);
                         ``.zst`` when the optional ``zstandard`` codec is
                         installed, plain msgpack otherwise (restore reads
                         both, but a ``.zst`` shard needs the codec)

The payload is a msgpack map from each leaf's path, spelled as
`jax.tree_util.keystr` spells it (``.opt.mu['units'][0]['moe']['wo']``),
to ``{"dtype", "shape", "data"}`` (numpy's dtype name, the shape, the
C-order bytes), written in the reference's flatten order with the port's
own codec (`data._msgpack`, byte-identical to ``msgpack.packb(...,
use_bin_type=True)``). So for one state the two packages write the same
shard bytes, checksum and tree signature.

  * **atomic**: written to ``step_<n>.tmp`` then renamed -- a crashed
    writer never corrupts the latest checkpoint;
  * **async**: `AsyncCheckpointer.save` copies the tensors to host memory
    synchronously and serializes / writes on a background thread;
  * **logical on disk, placed on restore**: a leaf placed on a mesh
    (`distributed.partitioning.Placed`) is written as its logical tensor,
    so a state's shard bytes do not depend on its mesh; `restore` places
    each array by ``shardings`` (the current mesh's: a one-position mesh
    puts it on its device, a larger one cuts it into blocks -- the
    elastic path), else where the target leaf lies;
  * **self-describing**: dtypes / shapes / tree paths in the file, the
    tree's paths checked against the restore target.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Optional

import torch

from repro_torch import _tree
from repro_torch.data import _msgpack
from repro_torch.distributed.partitioning import Placed

try:  # optional dep (`pip install .[zstd]`): fall back to uncompressed
    import zstandard
except ImportError:
    zstandard = None

_COMPRESS_LEVEL = 3

# numpy's dtype names (the file's) <-> torch dtypes
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
           "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint on disk fails its integrity check (shard checksum
    mismatch, missing shard, or unreadable metadata)."""


def _path_str(path) -> str:
    return _tree.keystr(path)


def _tree_signature(tree: Any) -> str:
    paths = [_path_str(p) for p, _ in _tree.flatten_with_path(tree)]
    return hashlib.sha1("|".join(sorted(paths)).encode()).hexdigest()


def _host(state: Any) -> dict:
    """{path string: a contiguous CPU copy} in flatten order: a copy even
    of a CPU tensor, which a donated train step updates in place while the
    background thread writes."""
    return {_path_str(p): v.unshard("cpu") if isinstance(v, Placed) else
            torch.as_tensor(v).detach().to("cpu", copy=True).contiguous()
            for p, v in _tree.flatten_with_path(state)}


def save(ckpt_dir: str, step: int, state: Any, *,
         mesh_signature: str = "", process_index: int = 0) -> str:
    """Blocking save. Returns the final checkpoint path."""
    return _write(ckpt_dir, step, _host(state), _tree_signature(state),
                  mesh_signature, process_index)


class AsyncCheckpointer:
    """Snapshot synchronously, serialize+write in the background."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, state: Any, *, mesh_signature: str = "") -> None:
        self.wait()
        host = _host(state)
        sig = _tree_signature(state)

        def work():
            try:
                _write(self.ckpt_dir, step, host, sig, mesh_signature, 0)
                _gc(self.ckpt_dir, self.keep)
            except BaseException as e:  # surfaced on the next wait()/save()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the in-flight write. A failure on the background thread is
        re-raised here (once) rather than dying silently -- otherwise the
        train loop keeps running while every checkpoint is lost."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def _record(t: torch.Tensor) -> dict:
    return {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
            "data": t.reshape(-1).view(torch.uint8).numpy().tobytes()}


def _write(ckpt_dir, step, host: dict, tree_sig, mesh_sig, proc) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):  # leftovers from a crashed writer (possibly a
        shutil.rmtree(tmp)   # different codec) must not leak into this save
    os.makedirs(tmp)
    blob = _msgpack.packb({k: _record(v) for k, v in host.items()})
    if zstandard is not None:
        blob = zstandard.ZstdCompressor(level=_COMPRESS_LEVEL).compress(blob)
        shard_name = f"shard_{proc}.msgpack.zst"
    else:
        shard_name = f"shard_{proc}.msgpack"
    with open(os.path.join(tmp, shard_name), "wb") as f:
        f.write(blob)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "tree_signature": tree_sig,
                   "mesh_signature": mesh_sig,
                   "num_arrays": len(host),
                   "shards": {shard_name: {
                       "sha256": hashlib.sha256(blob).hexdigest(),
                       "bytes": len(blob)}}}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                   and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def _step_intact(path: str) -> bool:
    """True when a step dir's metadata is readable and every shard listed
    in it exists with a matching sha256.  Legacy checkpoints (no "shards"
    key in meta.json) are trusted as-is."""
    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return False
    for name, rec in meta.get("shards", {}).items():
        shard = os.path.join(path, name)
        try:
            with open(shard, "rb") as f:
                blob = f.read()
        except OSError:
            return False
        if len(blob) != rec["bytes"]:
            return False
        if hashlib.sha256(blob).hexdigest() != rec["sha256"]:
            return False
    return True


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest step whose checkpoint is intact.  Corrupt or incomplete
    steps (truncated shard, bit-flip, missing meta) are skipped so a
    restart falls back to the last good one instead of crashing."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted((int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                    if d.startswith("step_") and not d.endswith(".tmp")),
                   reverse=True)
    for step in steps:
        if _step_intact(os.path.join(ckpt_dir, f"step_{step:08d}")):
            return step
    return None


def _verify_shard(meta: dict, name: str, blob: bytes) -> None:
    rec = meta.get("shards", {}).get(name)
    if rec is None:  # legacy checkpoint written before checksums existed
        return
    if len(blob) != rec["bytes"] or \
            hashlib.sha256(blob).hexdigest() != rec["sha256"]:
        raise CheckpointCorruptionError(
            f"shard {name}: on-disk bytes do not match the checksum in "
            f"meta.json (expected {rec['bytes']}B sha256={rec['sha256']}, "
            f"got {len(blob)}B) -- the checkpoint is corrupt")


def _target_device(leaf) -> torch.device:
    """Where a restored leaf without a sharding goes: the target leaf's
    device, the card for a shape-only (``meta``) target."""
    dev = getattr(leaf, "device", None)
    if dev is None or dev.type == "meta":
        return torch.device("cuda")
    return dev


def restore(ckpt_dir: str, step: int, like: Any, *,
            shardings: Any = None, process_index: int = 0) -> Any:
    """Restore into the structure of ``like`` (tensors, possibly on the
    ``meta`` device); place each array by ``shardings`` if given (re-sharded
    onto the current mesh, whatever mesh wrote it: the elastic path)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta["tree_signature"] != _tree_signature(like):
        raise ValueError("checkpoint tree does not match restore target "
                         "(structure changed?)")
    raw_path = os.path.join(path, f"shard_{process_index}.msgpack")
    zst_path = raw_path + ".zst"
    if os.path.exists(zst_path):
        if zstandard is None:
            raise RuntimeError(
                f"{zst_path} is zstd-compressed but zstandard is not "
                "installed (pip install .[zstd])")
        with open(zst_path, "rb") as f:
            raw = f.read()
        _verify_shard(meta, os.path.basename(zst_path), raw)
        blob = zstandard.ZstdDecompressor().decompress(raw)
    else:
        with open(raw_path, "rb") as f:
            blob = f.read()
        _verify_shard(meta, os.path.basename(raw_path), blob)
    payload = _msgpack.unpackb(blob)
    del blob

    flat = _tree.flatten_with_path(like)
    shard_flat = (_tree.leaves(shardings) if shardings is not None
                  else [None] * len(flat))
    out = []
    for (p, leaf), shard in zip(flat, shard_flat, strict=True):
        rec = payload.pop(_path_str(p))
        arr = torch.frombuffer(bytearray(rec["data"]),
                               dtype=_DTYPES[rec["dtype"]]
                               ) if rec["data"] else \
            torch.empty(0, dtype=_DTYPES[rec["dtype"]])
        arr = arr.reshape(rec["shape"])
        out.append(arr.to(_target_device(leaf)) if shard is None else
                   shard.shard(arr, copy=shard.mesh.size > 1))
    return _tree.unflatten(like, out)
