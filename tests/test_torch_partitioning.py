"""The port's sharding rules (`repro_torch.distributed.partitioning`)
against the reference's, on the CPU, with no full-size tensor made.

Each of the ten LM configs' full-size parameter tree is made twice as
shapes only: by ``jax.eval_shape`` of the reference's init and by the
port's init on the ``meta`` device. The meshes are given by their shape
alone: a ``jax.sharding.AbstractMesh`` on the reference's side and a
`launch.mesh.Mesh` of ``meta`` devices on the port's (as the port's mesh
tests place logical shards). Every leaf's spec -- the rule's, then the
sanitized one of `param_shardings` / `batch_shardings` /
`cache_shardings` -- must be the reference's, with the same leaf path.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as ref_get_config
from repro.configs import registry as ref_registry
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.data.tokens import batch_struct as ref_batch_struct
from repro.distributed import partitioning as ref_part
from repro.models import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro.train import step as ref_step
from repro_torch import _tree
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.tokens import batch_struct
from repro_torch.distributed import partitioning as part
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.train import step as train_step
from repro_torch.train.step import _MetaKey

ARCHS = ref_registry.arch_ids()
MESHES = [((1, 1), ("data", "model")), ((2, 1), ("data", "model")),
          ((4, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _meshes(shape, axes):
    n = int(np.prod(shape))
    return (AbstractMesh(shape, axes),
            make_mesh(shape, axes, devices=[torch.device("meta")] * n))


def _ref_leaves(tree):
    return [(jax.tree_util.keystr(p), x) for p, x in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, (jax.sharding.PartitionSpec,
                        jax.sharding.NamedSharding)))[0]]


def _port_leaves(tree):
    return [(_tree.keystr(p), x) for p, x in _tree.flatten_with_path(tree)]


def _specs(pairs):
    return [(k, tuple(getattr(x, "spec", x))) for k, x in pairs]


@pytest.fixture(scope="module")
def full_trees():
    """{arch: (reference's shapes, port's meta tree)} of every config."""
    out = {}
    for arch in ARCHS:
        rm = ref_build_model(ref_get_config(arch))
        ref = jax.eval_shape(rm.init, jax.random.PRNGKey(0))
        mine = build_model(get_config(arch), device="meta").init(_MetaKey())
        out[arch] = (ref, mine)
    return out


def test_p_canonicalizes_as_partition_spec():
    from jax.sharding import PartitionSpec
    for entries in [(), (None,), ("data",), (("data",), None),
                    ((), "model"), (("pod", "data"), None, "model")]:
        assert tuple(part.P(*entries)) == tuple(PartitionSpec(*entries))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_shardings_are_the_references(arch, full_trees):
    ref, mine = full_trees[arch]
    want = _specs(_ref_leaves(ref_part.param_specs(ref)))
    assert _specs(_port_leaves(part.param_specs(mine))) == want
    shapes = [tuple(x.shape) for x in jax.tree.leaves(ref)]
    assert [tuple(x.shape) for x in _tree.leaves(mine)] == shapes
    for shape, axes in MESHES:
        rmesh, tmesh = _meshes(shape, axes)
        got = part.param_shardings(tmesh, mine)
        assert _specs(_port_leaves(got)) == _specs(_ref_leaves(
            ref_part.param_shardings(rmesh, ref))), (shape, axes)
        assert all(s.mesh is tmesh for s in _tree.leaves(got))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_are_the_references(arch):
    """Every cache type: GQA / MQA and ring KV caches, MLA latents,
    RG-LRU and xLSTM states, whisper's cross K/V, stacked units. A
    cache's positions are Python ints in the port (replicated, spec ()),
    where the reference's stacked units carry an (n_units,) position array
    (spec (None,)): the positions' specs are held to (), the rest to the
    reference's, path by path."""
    rm = ref_build_model(ref_get_config(arch))
    tm = build_model(get_config(arch), device="meta")
    for b, max_len in ((4, 96), (1, 4096)):
        ref = jax.eval_shape(lambda: rm.init_cache(b, max_len))
        mine = tm.init_cache(b, max_len)
        for shape, axes in MESHES:
            rmesh, tmesh = _meshes(shape, axes)
            want = _specs(_ref_leaves(ref_part.cache_shardings(rmesh, ref)))
            got = _specs(_port_leaves(part.cache_shardings(tmesh, mine)))
            assert [k for k, _ in got] == [k for k, _ in want]
            for (k, g), (_, w) in zip(got, want):
                if k.endswith("pos") or k.endswith("['pos']"):
                    assert g == (), k
                else:
                    assert g == w, (arch, b, shape, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_state_shardings_are_the_references(arch, full_trees):
    shape_cfg = ShapeConfig("t", 1024, 64, "train")
    ref_shape = RefShapeConfig("t", 1024, 64, "train")
    ref_batch = ref_batch_struct(ref_get_config(arch), ref_shape)
    batch = batch_struct(get_config(arch), shape_cfg)
    ref_params, params = full_trees[arch]
    rstate = ref_step.TrainState(
        params=ref_params, opt=jax.eval_shape(ref_adamw(3e-4).init,
                                              ref_params), comp=None)
    state = train_step.TrainState(params=params,
                                  opt=adamw(3e-4).init(params), comp=None)
    for shape, axes in MESHES:
        rmesh, tmesh = _meshes(shape, axes)
        assert _specs(_port_leaves(part.batch_shardings(tmesh, batch))) == \
            _specs(_ref_leaves(ref_part.batch_shardings(rmesh, ref_batch)))
        assert _specs(_port_leaves(train_step.state_shardings(
            tmesh, state))) == _specs(_ref_leaves(
                ref_step.state_shardings(rmesh, rstate)))
        assert part.batch_axes(tmesh) == ref_part.batch_axes(rmesh)


@pytest.mark.parametrize("shape", [(5,), (6, 7), (16, 4), (256, 3, 2)])
def test_sanitize_spec_drops_what_does_not_divide(shape):
    for mshape, axes in MESHES:
        rmesh, tmesh = _meshes(mshape, axes)
        for spec in [("data",), ("model", "data"), (None, ("data", "model")),
                     (("pod", "data") if "pod" in axes else "data", None,
                      "model")]:
            got = part.sanitize_spec(tmesh, part.P(*spec), shape)
            want = ref_part.sanitize_spec(
                rmesh, jax.sharding.PartitionSpec(*spec), shape)
            assert tuple(got) == tuple(want)


def test_one_position_sharding_places_and_a_larger_mesh_refuses():
    """One position: the device. A larger mesh has no one device (its
    ``device()`` refuses); its `shard` cuts blocks by the sanitized spec,
    and the train step takes it for an attention decoder and for a mixer
    (refused until ROADMAP Queue 1 item 5e)."""
    mesh = make_mesh((1, 1), ("data", "model"),
                     devices=[torch.device("cpu")])
    s = part.NamedSharding(mesh, part.P("data"))
    assert s.device() == torch.device("cpu")
    big = make_mesh((2, 2), ("data", "model"),
                    devices=[torch.device("cpu")] * 4)
    with pytest.raises(ValueError, match="positions"):
        part.NamedSharding(big, part.P()).device()
    x = torch.arange(24.0).reshape(4, 6)
    placed = part.NamedSharding(big, part.P("data", "model")).shard(x)
    assert tuple(placed.blocks[1, 0].shape) == (2, 3)
    assert torch.equal(placed.blocks[1, 0], x[2:, :3])
    assert torch.equal(placed.unshard(), x)
    model = build_model(get_config("olmo-1b"), device="meta")
    train_step.build_train_step(model, adamw(1e-3), big)
    mixer = build_model(get_config("xlstm-125m"), device="meta")
    assert callable(train_step.build_train_step(mixer, adamw(1e-3), big))
