"""The port's training path on meshes of logical CPU shards.

The reference's jitted train step runs on meshes of forced host devices in
one subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
`tests/test_system.py` does) and writes its metrics and parameters to an
npz; the port runs one step from the same state (the reference's
``init_state``, through `convert.train_state_from_numpy`) on the same
mesh shape of ``[torch.device("cpu")] * n`` logical shards. Cases
(deepseek-moe-16b smoke): one step on (2, 2) with both routers,
microbatches 2 on (2, 1), grad compression on (2, 1, 2); float32 compute;
held at `tests/test_torch_train_step.py`'s tolerances (loss and grad_norm
rtol 1e-5; the update by ||dp_port - dp_ref|| / ||dp_ref|| per leaf, 1e-3,
1e-2 with compression).

The port's own contracts: (d, m) meshes against its one-device step
(the same tolerances), two steps from one state bitwise on (2, 2) (both
routers), pod replicas bitwise equal, a (2, 2) checkpoint restored on
(1, 1) and (4, 1) bitwise with shard files byte-equal to a (1, 1) save,
the reference's failure-and-resume trainer test (`tests/test_system.py`)
on a (4, 2) mesh, and both launchers on ``--devices 4 --mesh 2x2``.
"""
import contextlib
import dataclasses
import io
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
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.models.sharding_hints import activation_sharding
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.train import Trainer, build_train_step, state_shardings
from repro_torch.train import step as train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 8 host devices; XLA's cheaper CPU compile (a third less CPU time: the
# reference's compiles are most of these files' cost, and rounding only
# moves within the tolerances)
REF_XLA_FLAGS = ("--xla_force_host_platform_device_count=8 "
                 "--xla_backend_optimization_level=0 "
                 "--xla_llvm_disable_expensive_passes=true")
CASES = [("deepseek-moe-16b", "topk", (2, 2), 1, False),
         ("deepseek-moe-16b", "sinkhorn", (2, 2), 1, False),
         ("deepseek-moe-16b", "sinkhorn", (2, 1), 2, False),
         ("deepseek-moe-16b", "topk", (2, 1, 2), 1, True)]

_REF = """
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.data.tokens import TokenPipeline
from repro.launch.mesh import make_mesh
from repro.models import build_model
from repro.models.sharding_hints import activation_sharding
from repro.optim import adamw, warmup_cosine
from repro.train import step as ref_step
out = {{}}
for arch, router, shape, mb, comp in {CASES!r}:
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    if router:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, router=router))
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
    key = "-".join([arch, str(router), "x".join(map(str, shape)), str(mb),
                    str(int(comp))])
    out[key + "/loss"] = np.asarray(met["loss"])
    out[key + "/grad_norm"] = np.asarray(met["grad_norm"])
    for i, p in enumerate(jax.tree.leaves(st2.params)):
        out[key + "/p1/" + str(i)] = np.asarray(p)
np.savez(sys.argv[1], **out)
"""



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these smoke shapes: more threads add CPU
    time here and no speed (a tiny op's work does not split)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's step on every case, from one subprocess."""
    path = str(tmp_path_factory.mktemp("ref") / "train.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=REF_XLA_FLAGS,
               PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("REPRO_FAILED_ONCE", None)
    run = subprocess.run([sys.executable, "-c", _REF.format(CASES=CASES),
                          path], env=env, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(path))


def _cfgs(arch, router):
    out = []
    for cfg in (ref_get_smoke(arch), get_smoke_config(arch)):
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
        if router:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, router=router))
        out.append(cfg)
    return out


def _mesh(shape):
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return make_mesh(shape, axes,
                     devices=[torch.device("cpu")] * int(np.prod(shape)))


def _start(arch, router, comp):
    """(reference state as numpy, port model, port optimizer, the port's
    state from it, the first batch)."""
    rcfg, tcfg = _cfgs(arch, router)
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
        return state, fn(state, batch)


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


@pytest.mark.parametrize("arch,router,shape,mb,comp", CASES)
def test_mesh_step_matches_reference_on_the_same_mesh(
        reference, arch, router, shape, mb, comp):
    rs, tm, topt, batch = _start(arch, router, comp)
    state = train_state_from_numpy(rs, device="cpu")
    p0 = [np.array(x, np.float64) for x in _tree.leaves(rs.params)]
    _, (new, met) = _step_on(tm, topt, state, batch, _mesh(shape), mb, comp)
    key = f"{arch}-{router}-{'x'.join(map(str, shape))}-{mb}-{int(comp)}"
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(met[k]), float(reference[
            f"{key}/{k}"]), rtol=1e-5, err_msg=k)
    want = [reference[f"{key}/p1/{i}"] for i in range(len(p0))]
    assert _update_rel(p0, want, _logical(new.params)) <= \
        (1e-2 if comp else 1e-3)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 3)])
def test_mesh_step_matches_one_device(shape):
    """gemma-2b smoke (model = 3: no whole-unit split, the layers run on
    each group's owner) against the one-device step."""
    rs, tm, topt, batch = _start("gemma-2b", None, False)
    state = train_state_from_numpy(rs, device="cpu")
    p0 = [np.array(x, np.float64) for x in _tree.leaves(rs.params)]
    _, (one, m1) = _step_on(tm, topt, state, batch, None)
    _, (new, mm) = _step_on(tm, topt, state, batch, _mesh(shape))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(mm[k]), float(m1[k]), rtol=1e-5)
    assert _update_rel(p0, _logical(one.params), _logical(new.params)) \
        <= 1e-3


@pytest.mark.parametrize("router", ["topk", "sinkhorn"])
def test_two_mesh_steps_from_one_state_are_bitwise_equal(router):
    _, tm, topt, batch = _start("deepseek-moe-16b", router, False)
    state = train_step.init_state(tm, topt, 0)
    outs = []
    for _ in range(2):
        _, (new, met) = _step_on(tm, topt, state, batch, _mesh((2, 2)))
        outs.append((_logical(new), float(met["loss"]),
                     float(met["grad_norm"])))
    (a, la, ga), (b, lb, gb) = outs
    assert la == lb and ga == gb
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_pod_replicas_stay_bitwise_equal():
    """Two steps with grad compression on (2, 1, 2): every leaf's blocks
    equal across the pods (each pod's data, one gradient sum written to
    both), and the result the one-device run's within the tolerances."""
    _, tm, topt, batch = _start("deepseek-moe-16b", "sinkhorn", True)
    state = train_step.init_state(tm, topt, 0, grad_compression=True)
    p0 = [x.numpy().astype(np.float64) for x in _tree.leaves(state.params)]
    mesh = _mesh((2, 1, 2))
    fn = build_train_step(tm, topt, mesh, grad_compression=True,
                          donate=False)
    one = build_train_step(tm, topt, None, grad_compression=True,
                           donate=False)
    st = train_step.place(state, state_shardings(mesh, state))
    ref = state
    for _ in range(2):
        st, met = fn(st, batch)
        ref, rmet = one(ref, batch)
        for leaf in _tree.leaves((st.params, st.opt.mu, st.opt.nu,
                                  st.comp.residual)):
            for c in np.ndindex(leaf.blocks.shape[1:]):
                assert torch.equal(leaf.blocks[(0, *c)],
                                   leaf.blocks[(1, *c)])
        np.testing.assert_allclose(float(met["loss"]), float(rmet["loss"]),
                                   rtol=1e-5)
    assert _update_rel(p0, _logical(ref.params), _logical(st.params)) \
        <= 1e-2


def test_a_checkpoint_restores_on_another_mesh(tmp_path):
    """A (2, 2) state saved, restored on (1, 1) and (4, 1): the logical
    tensors bitwise, and its shard file byte-equal to a (1, 1) save."""
    _, tm, topt, _ = _start("deepseek-moe-16b", "topk", True)
    state = train_step.init_state(tm, topt, 0, grad_compression=True)
    placed = train_step.place(state, state_shardings(_mesh((2, 2)), state))
    ckpt.save(str(tmp_path / "mesh"), 1, placed,
              mesh_signature="data=2xmodel=2")
    ckpt.save(str(tmp_path / "one"), 1, state)
    names = sorted(os.listdir(tmp_path / "one" / "step_00000001"))
    shard = [n for n in names if n.startswith("shard_")][0]
    for d in ("mesh", "one"):
        assert sorted(os.listdir(tmp_path / d / "step_00000001")) == names
    assert (tmp_path / "mesh" / "step_00000001" / shard).read_bytes() == \
        (tmp_path / "one" / "step_00000001" / shard).read_bytes()
    struct = train_step.state_struct(tm, topt, grad_compression=True)
    want = [x.numpy() for x in _tree.leaves(state)]
    for shape in ((1, 1), (4, 1)):
        mesh = _mesh(shape)
        got = ckpt.restore(str(tmp_path / "mesh"), 1, struct,
                           shardings=state_shardings(mesh, struct))
        for leaf in _tree.leaves(got.params):
            assert isinstance(leaf, part.Placed) == (mesh.size > 1)
        assert all(np.array_equal(x, y) for x, y in
                   zip(_logical(got), want))


def test_trainer_failure_restart_loss_decreases(tmp_path, monkeypatch):
    """The reference's `tests/test_system.py` test on the port: gemma-2b
    smoke on a (4, 2) mesh, a failure injected at step 6, the rerun
    resumes from the checkpoint of step 4 and the loss falls."""
    monkeypatch.delenv("REPRO_FAILED_ONCE", raising=False)
    cfg = get_smoke_config("gemma-2b")
    model = build_model(cfg, q_block=16, kv_block=16, device="cpu")
    opt = adamw(warmup_cosine(3e-4, warmup_steps=3, total_steps=20))
    pipe = TokenPipeline(cfg, batch=8, seq_len=32)
    mesh = _mesh((4, 2))
    td = str(tmp_path)
    tr = Trainer(model, opt, mesh, pipe, ckpt_dir=td, ckpt_every=4,
                 log_fn=lambda s: None)
    with pytest.raises(RuntimeError, match="injected"):
        tr.run(0, 12, fail_at=6)
    tr2 = Trainer(model, opt, mesh, pipe, ckpt_dir=td, ckpt_every=4,
                  log_fn=lambda s: None)
    out = tr2.run(0, 12)
    h = out["history"]
    assert h[0]["step"] == 4 and h[-1]["step"] == 11
    assert h[-1]["loss"] < h[0]["loss"]
    with open(os.path.join(td, "step_00000012", "meta.json")) as f:
        assert '"data=4xmodel=2"' in f.read()


def _run(main, args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(args)
    return out.getvalue()


def test_launchers_on_a_2x2_mesh(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_FAILED_ONCE", raising=False)
    mesh = ["--devices", "4", "--mesh", "2x2", "--device", "cpu"]
    common = ["--arch", "gemma-2b", "--smoke", "--ckpt-every", "2",
              "--batch", "4", "--seq-len", "16", "--ckpt-dir",
              str(tmp_path / "ck"), *mesh]
    first = _run(launch_train.main, ["--steps", "2", *common])
    assert "mesh={'data': 2, 'model': 2}" in first
    assert "[train] done: step 1 loss" in first
    second = _run(launch_train.main, ["--steps", "4", *common])
    assert "[trainer] restoring step 2" in second
    assert "[train] done: step 3 loss" in second
    served = _run(launch_serve.main, [
        "--arch", "deepseek-moe-16b", "--smoke", "--decode-steps", "2",
        "--prefill-len", "8", *mesh])
    assert "on Mesh(data=2, model=2" in served
    assert "[serve] 2 decode steps" in served


def test_a_donated_step_from_view_placed_params_matches_place():
    """`partitioning.shard` without ``copy`` places replicas as views of
    one tensor; the donated step gives them their own blocks, so each
    replica is updated once: the result is `place`'s bitwise."""
    _, tm, topt, batch = _start("gemma-2b", None, False)
    mesh = _mesh((2, 2))
    fn = build_train_step(tm, topt, mesh, donate=True)
    outs = []
    for placer in (train_step.place, part.shard):
        state = train_step.init_state(tm, topt, 0)
        st = placer(state, state_shardings(mesh, state))
        with activation_sharding(mesh):
            st, met = fn(st, batch)
        outs.append((_logical(st), float(met["loss"])))
    (a, la), (b, lb) = outs
    assert la == lb
    assert all(np.array_equal(x, y) for x, y in zip(a, b, strict=True))
