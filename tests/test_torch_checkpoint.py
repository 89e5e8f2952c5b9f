"""The port's checkpointer (`repro_torch.checkpoint`) on the CPU: its own
round trip and integrity cases (the reference's
`tests/test_checkpoint_integrity.py`, re-spelled), and the on-disk format
against live JAX: for one state both packages write the same shard bytes,
checksum and tree signature, and each restores the other's directory bit
for bit."""
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as ref_ckpt
from repro.optim import AdamWState as RefAdamWState
from repro.train.step import TrainState as RefTrainState
from repro_torch import _tree
from repro_torch.checkpoint import CheckpointCorruptionError
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.distributed.partitioning import NamedSharding, P
from repro_torch.launch.mesh import make_mesh, one_device_mesh
from repro_torch.optim import AdamWState
from repro_torch.train import TrainState


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.tensor(rng.normal(size=(4, 3)).astype(np.float32)),
            "b": torch.tensor(rng.normal(size=(3,)).astype(np.float32))}


def _numpy_train_state(seed=0):
    """A small training state as numpy: dicts, a list of stacked units, an
    int32 step and both moments."""
    rng = np.random.default_rng(seed)

    def p():
        return {"embedding": {"embed": rng.normal(size=(6, 4)).astype(
                    np.float32)},
                "units": [{"mlp": {"wi": rng.normal(size=(2, 4, 5)).astype(
                    np.float32)}, "mlp_norm": {"scale": np.ones(
                        (2, 4), np.float32)}}],
                "final_norm": {"scale": rng.normal(size=(4,)).astype(
                    np.float32)}}

    return p(), np.int32(7), p(), p()


def _port_state(seed=0):
    params, step, mu, nu = _numpy_train_state(seed)
    t = lambda tree: _tree.tree_map(torch.tensor, tree)  # noqa: E731
    return TrainState(params=t(params), opt=AdamWState(
        step=torch.tensor(step), mu=t(mu), nu=t(nu)), comp=None)


def _ref_state(seed=0):
    params, step, mu, nu = _numpy_train_state(seed)
    j = lambda tree: jax.tree.map(jnp.asarray, tree)  # noqa: E731
    return RefTrainState(params=j(params), opt=RefAdamWState(
        step=jnp.asarray(step), mu=j(mu), nu=j(nu)), comp=None)


def _shard_path(ckpt_dir, step):
    (path,) = glob.glob(
        os.path.join(ckpt_dir, f"step_{step:08d}", "shard_0.msgpack*"))
    return path


def _unwritable_dir(tmp_path):
    """A checkpoint-dir path that cannot be written to: its parent is a
    regular file (makedirs fails with NotADirectoryError even for root)."""
    blocker = os.path.join(str(tmp_path), "blocker")
    with open(blocker, "w") as f:
        f.write("not a directory")
    return os.path.join(blocker, "ckpts")


def _equal(a, b):
    la, lb = _tree.leaves(a), _tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.array(x))
        y = y if isinstance(y, torch.Tensor) else torch.from_numpy(
            np.array(y))
        assert x.dtype == y.dtype and torch.equal(x, y)


# -- the port's own behaviour -------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    state = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
             "nested": {"b": torch.tensor([1, 2, 3], dtype=torch.int32)},
             "scalar": torch.tensor(7, dtype=torch.int32),
             "half": torch.tensor([1.5, -2.0], dtype=torch.bfloat16)}
    td = str(tmp_path)
    ckpt.save(td, 5, state, mesh_signature="data=1")
    assert ckpt.latest_step(td) == 5
    like = _tree.tree_map(lambda x: torch.empty_like(x, device="meta"),
                          state)
    mesh = one_device_mesh("cpu")
    shard = _tree.tree_map(lambda _: NamedSharding(mesh, P()), state)
    r = ckpt.restore(td, 5, like, shardings=shard)
    _equal(r, state)
    assert r["scalar"].shape == () and r["scalar"].device.type == "cpu"
    r2 = ckpt.restore(td, 5, state)                # the target's device
    _equal(r2, state)
    with open(os.path.join(td, "step_00000005", "meta.json")) as f:
        meta = json.load(f)
    assert meta["mesh_signature"] == "data=1" and meta["num_arrays"] == 4


def test_restore_refuses_another_structure(tmp_path):
    td = str(tmp_path)
    ckpt.save(td, 1, _state())
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore(td, 1, {"w": torch.zeros(4, 3)})


def test_restore_refuses_a_mesh_beyond_one_position(tmp_path):
    """Restore on a mesh beyond one position (the elastic path, which the
    port once refused): each leaf placed by its sharding, blocks on their
    positions, the logical tensors bitwise the saved ones; the structure
    check still refuses another tree."""
    td = str(tmp_path)
    ckpt.save(td, 1, _state())
    mesh = make_mesh((2, 1), ("data", "model"),
                     devices=[torch.device("cpu")] * 2)
    shard = _tree.tree_map(lambda x: NamedSharding(mesh, P("data")),
                           _state())
    got = ckpt.restore(td, 1, _state(), shardings=shard)
    # w's 4 rows split over data; b's 3 do not (replicated)
    assert got["w"].spec == P("data", None) and got["b"].spec == P(None)
    assert [tuple(got["w"].blocks[i, 0].shape) for i in (0, 1)] == \
        [(2, 3), (2, 3)]
    for name, want in _state().items():
        for c in np.ndindex(2, 1):
            assert got[name].blocks[c].device == mesh.devices[c]
        assert torch.equal(got[name].unshard(), want)
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore(td, 1, {"w": torch.zeros(4, 3)}, shardings=shard)


def test_async_checkpointer_keeps_the_newest(tmp_path):
    td = str(tmp_path)
    c = ckpt.AsyncCheckpointer(td, keep=2)
    for step in (1, 2, 3, 4):
        c.save(step, _state(step))
    c.wait()
    assert sorted(os.listdir(td)) == ["step_00000003", "step_00000004"]
    _equal(ckpt.restore(td, 4, _state()), _state(4))


def test_async_save_snapshots_before_the_state_changes(tmp_path):
    """A donated train step updates the state in place while the
    background thread writes: the checkpoint holds the state as it was at
    `save`."""
    td = str(tmp_path)
    state = _state(3)
    want = _tree.tree_map(torch.clone, state)
    c = ckpt.AsyncCheckpointer(td)
    c.save(1, state)
    for x in _tree.leaves(state):
        x.add_(1.0)
    c.wait()
    _equal(ckpt.restore(td, 1, state), want)


def test_async_write_failure_raised_on_wait(tmp_path):
    td = str(tmp_path / "good")
    c = ckpt.AsyncCheckpointer(td)
    c.save(1, _state())
    c.wait()                                     # good save: no error
    c.ckpt_dir = _unwritable_dir(tmp_path)       # now unwritable
    c.save(2, _state())
    with pytest.raises(OSError):
        c.wait()                                 # background failure lands
    c.wait()                                     # ... exactly once
    assert ckpt.latest_step(td) == 1             # step 2 never appeared


def test_async_write_failure_raised_on_next_save(tmp_path):
    c = ckpt.AsyncCheckpointer(_unwritable_dir(tmp_path))
    c.save(1, _state())
    with pytest.raises(OSError):
        c.save(2, _state())                      # save() waits first


def test_truncated_shard_detected(tmp_path):
    td = str(tmp_path)
    state = _state()
    ckpt.save(td, 1, state)
    ckpt.save(td, 2, state)
    shard = _shard_path(td, 2)
    with open(shard, "r+b") as f:
        f.truncate(os.path.getsize(shard) // 2)
    with pytest.raises(CheckpointCorruptionError, match="shard"):
        ckpt.restore(td, 2, state)
    assert ckpt.latest_step(td) == 1
    _equal(ckpt.restore(td, 1, state), state)


def test_bitflip_shard_detected(tmp_path):
    td = str(tmp_path)
    state = _state()
    ckpt.save(td, 1, state)
    ckpt.save(td, 5, state)
    shard = _shard_path(td, 5)
    with open(shard, "r+b") as f:
        f.seek(os.path.getsize(shard) // 3)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0x10]))            # same length, wrong bits
    with pytest.raises(CheckpointCorruptionError):
        ckpt.restore(td, 5, state)
    assert ckpt.latest_step(td) == 1


def test_missing_meta_skipped_by_latest_step(tmp_path):
    td = str(tmp_path)
    state = _state()
    ckpt.save(td, 1, state)
    ckpt.save(td, 2, state)
    os.remove(os.path.join(td, "step_00000002", "meta.json"))
    assert ckpt.latest_step(td) == 1
    os.remove(_shard_path(td, 1))                # shard gone entirely
    assert ckpt.latest_step(td) is None


def test_meta_carries_shard_checksum(tmp_path):
    td = str(tmp_path)
    ckpt.save(td, 3, _state())
    with open(os.path.join(td, "step_00000003", "meta.json")) as f:
        meta = json.load(f)
    (name, rec), = meta["shards"].items()
    assert name.startswith("shard_0.msgpack")
    assert len(rec["sha256"]) == 64
    assert rec["bytes"] == os.path.getsize(_shard_path(td, 3))


def test_legacy_checkpoint_without_checksums_restores(tmp_path):
    td = str(tmp_path)
    state = _state()
    ckpt.save(td, 1, state)
    meta_path = os.path.join(td, "step_00000001", "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    del meta["shards"]
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    assert ckpt.latest_step(td) == 1             # trusted as-is
    _equal(ckpt.restore(td, 1, state), state)


def test_without_zstandard_the_shard_is_plain_msgpack(tmp_path,
                                                      monkeypatch):
    td = str(tmp_path)
    monkeypatch.setattr(ckpt, "zstandard", None)
    ckpt.save(td, 1, _state())
    assert os.path.basename(_shard_path(td, 1)) == "shard_0.msgpack"
    _equal(ckpt.restore(td, 1, _state()), _state())
    # a compressed shard needs the codec
    shard = os.path.join(td, "step_00000001", "shard_0.msgpack")
    os.rename(shard, shard + ".zst")
    with pytest.raises(RuntimeError, match="zstandard is not installed"):
        ckpt.restore(td, 1, _state())


# -- the on-disk format against the reference ---------------------------------

@pytest.mark.parametrize("codec", ["zstd", "plain"])
def test_one_state_gives_the_references_bytes(tmp_path, monkeypatch, codec):
    if codec == "plain":
        monkeypatch.setattr(ckpt, "zstandard", None)
        monkeypatch.setattr(ref_ckpt, "zstandard", None)
    elif ckpt.zstandard is None:
        # no codec installed: both packages write plain shards, which the
        # "plain" case covers
        monkeypatch.setattr(ref_ckpt, "zstandard", None)
    mine, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    state, rstate = _port_state(), _ref_state()
    assert ckpt._tree_signature(state) == ref_ckpt._tree_signature(rstate)
    ckpt.save(mine, 3, state, mesh_signature="data=1xmodel=1")
    ref_ckpt.save(ref, 3, rstate, mesh_signature="data=1xmodel=1")
    with open(_shard_path(mine, 3), "rb") as f, \
            open(_shard_path(ref, 3), "rb") as g:
        assert f.read() == g.read()
    metas = []
    for d in (mine, ref):
        with open(os.path.join(d, "step_00000003", "meta.json")) as f:
            metas.append(json.load(f))
    assert metas[0] == metas[1]


def test_each_package_restores_the_others_directory(tmp_path):
    mine, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    ref_ckpt.save(ref, 2, _ref_state(1))
    ckpt.save(mine, 2, _port_state(1))
    like = _port_state()
    got = ckpt.restore(ref, 2, like)
    _equal(got, _port_state(1))
    assert isinstance(got, TrainState) and got.opt.step.dtype == torch.int32
    back = ref_ckpt.restore(mine, 2, jax.eval_shape(lambda: _ref_state()))
    _equal(_tree.tree_map(lambda x: torch.from_numpy(np.array(x)), back),
           _port_state(1))
