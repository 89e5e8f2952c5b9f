"""The mixers' training step on meshes of logical CPU shards.

The reference's jitted train step runs on meshes of forced host devices in
one subprocess (as `tests/test_torch_train_mesh.py` runs it) and writes
its metrics and parameters to an npz; the port runs one step from the same
state (the reference's ``init_state``, through
`convert.train_state_from_numpy`) on the same mesh shape. Cases, smoke
configs in float32 compute, batch 8 x 16 of ``TokenPipeline(seed=0)``:
minicpm3-4b, recurrentgemma-9b, xlstm-125m and whisper-small on (2, 2);
xlstm-125m on (2, 1) with 2 microbatches; recurrentgemma-9b on (2, 1, 2)
with grad compression. Whisper's decoder embeds at bfloat16 whatever the
compute dtype in both packages; its default is lifted to float32 in both
alike (a wrapper, in the test only, as in
`tests/test_torch_train_grads_mixers.py`). Held at
`tests/test_torch_train_mesh.py`'s tolerances: loss and grad_norm rtol
1e-5, the update by ||dp_port - dp_ref|| / ||dp_ref|| per leaf, 1e-3
(1e-2 with compression). xlstm-125m's update is held at 1e-2: its sLSTM
bias has gradient elements at rounding level, which Adam's first step
moves by a rounding-decided part of the learning rate (the port's and the
reference's one-device steps on this batch already lie 8.5e-3 apart).

The port's own contracts: a whisper-small smoke state saved on (2, 2) and
restored on (1, 1) and (4, 1) bitwise, and two mesh steps from one state
bitwise.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro_torch  # noqa: F401  (precision pins)
from repro.configs import get_smoke_config as ref_get_smoke
from repro.models import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro.train import step as ref_step
from repro_torch import _tree
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs import get_smoke_config
from repro_torch.convert import train_state_from_numpy
from repro_torch.data import TokenPipeline
from repro_torch.distributed import partitioning as part
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.models.layers import embedding
from repro_torch.models.sharding_hints import activation_sharding
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.train import build_train_step, state_shardings
from repro_torch.train import step as train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_XLA_FLAGS = ("--xla_force_host_platform_device_count=8 "
                 "--xla_backend_optimization_level=0 "
                 "--xla_llvm_disable_expensive_passes=true")
# (arch, mesh shape, microbatches, grad compression)
CASES = [("minicpm3-4b", (2, 2), 1, False),
         ("recurrentgemma-9b", (2, 2), 1, False),
         ("xlstm-125m", (2, 2), 1, False),
         ("whisper-small", (2, 2), 1, False),
         ("xlstm-125m", (2, 1), 2, False),
         ("recurrentgemma-9b", (2, 1, 2), 1, True)]

_REF = """
import functools, dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.data.tokens import TokenPipeline
from repro.launch.mesh import make_mesh
from repro.models import build_model
from repro.models.layers import embedding
from repro.models.sharding_hints import activation_sharding
from repro.optim import adamw, warmup_cosine
from repro.train import step as ref_step
embed = embedding.embed
out = {{}}
for arch, shape, mb, comp in {CASES!r}:
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    embedding.embed = functools.partial(embed, dtype=jnp.float32) \\
        if cfg.family == "audio" else embed
    model = build_model(cfg, q_block=8, kv_block=8)
    opt = adamw(warmup_cosine(3e-3, warmup_steps=1, total_steps=10))
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    mesh = make_mesh(shape, axes)
    st = ref_step.init_state(model, opt, jax.random.PRNGKey(0),
                             grad_compression=comp)
    fn = ref_step.build_train_step(model, opt, mesh, microbatches=mb,
                                   grad_compression=comp, donate=False)
    batch = TokenPipeline(cfg, batch=8, seq_len=16).batch_at(0)
    with mesh, activation_sharding(mesh):
        st2, met = fn(st, {{k: jnp.asarray(v) for k, v in batch.items()}})
    key = "-".join([arch, "x".join(map(str, shape)), str(mb),
                    str(int(comp))])
    out[key + "/loss"] = np.asarray(met["loss"])
    out[key + "/grad_norm"] = np.asarray(met["grad_norm"])
    for i, p in enumerate(jax.tree.leaves(st2.params)):
        out[key + "/p1/" + str(i)] = np.asarray(p)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these smoke shapes (as
    `tests/test_torch_train_mesh.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's step on every case, from one subprocess."""
    path = str(tmp_path_factory.mktemp("ref") / "train.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=REF_XLA_FLAGS,
               PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("REPRO_FAILED_ONCE", None)
    run = subprocess.run([sys.executable, "-c", _REF.format(CASES=CASES),
                          path], env=env, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(path))


def _mesh(shape):
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return make_mesh(shape, axes,
                     devices=[torch.device("cpu")] * int(np.prod(shape)))


def _start(arch, comp):
    """(reference state as numpy, port model, port optimizer, the first
    batch)."""
    rcfg = dataclasses.replace(ref_get_smoke(arch), compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch),
                               compute_dtype="float32")
    ropt = ref_adamw(ref_warmup_cosine(3e-3, warmup_steps=1,
                                       total_steps=10))
    rs = ref_step.init_state(ref_build_model(rcfg, q_block=8, kv_block=8),
                             ropt, jax.random.PRNGKey(0),
                             grad_compression=comp)
    rs = jax.tree.map(np.asarray, rs)
    tm = build_model(tcfg, q_block=8, kv_block=8, device="cpu")
    topt = adamw(warmup_cosine(3e-3, warmup_steps=1, total_steps=10))
    batch = TokenPipeline(tcfg, batch=8, seq_len=16).batch_at(0)
    return rs, tm, topt, batch


def _step_on(tm, topt, state, batch, mesh, mb=1, comp=False):
    fn = build_train_step(tm, topt, mesh, microbatches=mb,
                          grad_compression=comp, donate=False)
    if mesh is not None:
        state = train_step.place(state, state_shardings(mesh, state))
    with activation_sharding(mesh):
        return fn(state, batch)


def _update_rel(p0, want, got):
    worst = 0.0
    for a, r, t in zip(p0, want, got, strict=True):
        dr = np.asarray(r, np.float64) - a
        dt = np.asarray(t, np.float64) - a
        worst = max(worst, np.linalg.norm(dt - dr)
                    / max(np.linalg.norm(dr), 1e-30))
    return worst


def _logical(tree):
    return [x.numpy() for x in _tree.leaves(part.unshard(tree))]


@pytest.mark.parametrize("arch,shape,mb,comp", CASES)
def test_mesh_step_matches_reference_on_the_same_mesh(
        reference, monkeypatch, arch, shape, mb, comp):
    if arch == "whisper-small":
        monkeypatch.setattr(embedding, "mesh_embed", functools.partial(
            embedding.mesh_embed, dtype=torch.float32))
    rs, tm, topt, batch = _start(arch, comp)
    state = train_state_from_numpy(rs, device="cpu")
    p0 = [np.array(x, np.float64) for x in _tree.leaves(rs.params)]
    new, met = _step_on(tm, topt, state, batch, _mesh(shape), mb, comp)
    key = f"{arch}-{'x'.join(map(str, shape))}-{mb}-{int(comp)}"
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(met[k]), float(reference[
            f"{key}/{k}"]), rtol=1e-5, err_msg=k)
    want = [reference[f"{key}/p1/{i}"] for i in range(len(p0))]
    assert _update_rel(p0, want, _logical(new.params)) <= \
        (1e-2 if comp or arch == "xlstm-125m" else 1e-3)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-125m"])
def test_two_mesh_steps_from_one_state_are_bitwise_equal(arch):
    _, tm, topt, batch = _start(arch, False)
    state = train_step.init_state(tm, topt, 0)
    outs = []
    for _ in range(2):
        new, met = _step_on(tm, topt, state, batch, _mesh((2, 2)))
        outs.append((_logical(new), float(met["loss"]),
                     float(met["grad_norm"])))
    (a, la, ga), (b, lb, gb) = outs
    assert la == lb and ga == gb
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_a_whisper_checkpoint_restores_on_another_mesh(tmp_path):
    """A whisper-small smoke state saved on (2, 2), restored on (1, 1) and
    (4, 1): the logical tensors bitwise."""
    _, tm, topt, _ = _start("whisper-small", False)
    state = train_step.init_state(tm, topt, 0)
    placed = train_step.place(state, state_shardings(_mesh((2, 2)), state))
    ckpt.save(str(tmp_path), 1, placed, mesh_signature="data=2xmodel=2")
    struct = train_step.state_struct(tm, topt)
    want = [x.numpy() for x in _tree.leaves(state)]
    for shape in ((1, 1), (4, 1)):
        mesh = _mesh(shape)
        got = ckpt.restore(str(tmp_path), 1, struct,
                           shardings=state_shardings(mesh, struct))
        for leaf in _tree.leaves(got.params):
            assert isinstance(leaf, part.Placed) == (mesh.size > 1)
        assert all(np.array_equal(x, y) for x, y in
                   zip(_logical(got), want, strict=True))
