"""The port's training substrate on the CPU: remat, donation, the
fault-tolerant trainer, checkpoints crossing packages, the conversion of a
JAX training state and the launcher.

Bitwise claims are made only inside the port (remat on == off, donated ==
kept, resumed == uninterrupted, two runs from one state); against live
JAX the trainer is held by tolerance (float32 compute: losses at rtol
1e-4 after a restore, 3 steps on).
"""
import contextlib
import dataclasses
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch  # noqa: F401  (precision pins)
from repro.configs import get_smoke_config as ref_get_smoke
from repro.data.tokens import TokenPipeline as RefTokenPipeline
from repro.launch.mesh import make_mesh as ref_make_mesh
from repro.models import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro.train import Trainer as RefTrainer
from repro.train import step as ref_step
from repro_torch import _tree
from repro_torch.configs import get_smoke_config
from repro_torch.convert import train_state_from_numpy
from repro_torch.data import TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import one_device_mesh
from repro_torch.models import build_model
from repro_torch.models.layers import embedding, moe
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.train import Trainer, build_train_step, init_state
from repro_torch.train import step as train_step

CPU = one_device_mesh("cpu")


def _equal(a, b):
    la, lb = _tree.leaves(a), _tree.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _quiet(_):
    return None


@pytest.fixture
def no_failure_flag(monkeypatch):
    """The reference's failure hook is once per process, through the
    REPRO_FAILED_ONCE environment variable: clear it around a test."""
    monkeypatch.delenv("REPRO_FAILED_ONCE", raising=False)
    yield
    os.environ.pop("REPRO_FAILED_ONCE", None)


# -- the model's backward in a fixed order ------------------------------------

def test_table_rows_gradient_sums_duplicates_in_a_fixed_order():
    rng = np.random.default_rng(0)
    table = torch.tensor(rng.normal(size=(50, 8)).astype(np.float32),
                         requires_grad=True)
    idx = torch.tensor(np.minimum(rng.zipf(1.2, size=(4, 33)), 50) - 1)
    g = torch.tensor(rng.normal(size=(4, 33, 8)).astype(np.float32))
    out = embedding._TableRows.apply(table, idx)
    assert torch.equal(out, table[idx])
    (got,) = torch.autograd.grad(out, table, g)
    want = torch.zeros_like(table)
    for i, row in enumerate(idx.reshape(-1).tolist()):   # reads in order
        want[row] += g.reshape(-1, 8)[i]
    assert torch.equal(got, want)
    assert int((idx == 0).sum()) > 10                    # Zipf duplicates


def test_moe_dispatch_forward_is_the_plain_gather_and_its_gradient_too():
    cfg = get_smoke_config("deepseek-moe-16b")
    e = cfg.moe
    rng = np.random.default_rng(1)
    b, tg, d = 2, 24, cfg.d_model
    x = torch.tensor(rng.normal(size=(b, tg, d)).astype(np.float32),
                     requires_grad=True)
    ids = torch.tensor(np.stack([rng.permutation(e.num_experts)[:e.top_k]
                                 for _ in range(b * tg)]).reshape(
                                     b, tg, e.top_k))
    w = torch.softmax(torch.tensor(rng.normal(size=(b, tg, e.top_k)),
                                   dtype=torch.float32), -1)
    cap = 5
    grouped, (keep, slot, order, _) = moe._dispatch_group(e, x, ids, w, cap)
    # the reference's gather: token i // k of the (token, choice) order
    sorted_tok = torch.arange(tg).repeat_interleave(e.top_k)[order]
    rows = torch.arange(b)[:, None]
    buf = torch.zeros((b, e.num_experts * cap + 1, d))
    buf[rows, slot] = x[rows, sorted_tok]
    want = buf[:, :-1].reshape(b, e.num_experts, cap, d)
    assert torch.equal(grouped, want)
    g = torch.tensor(rng.normal(size=grouped.shape).astype(np.float32))
    (got,) = torch.autograd.grad(grouped, x, g)
    (ref,) = torch.autograd.grad(want, x, g)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("shift", [0.0, 3.0, 6.0])
def test_sinkhorn_router_gradient_is_the_references_in_float64(shift):
    """The Sinkhorn router's scores: the forward is the float32 loop, its
    gradient the reference's loop differentiated in float64 (within 1e-6
    of the largest). As one expert's K column fades (every token avoids
    expert 7 by ``shift`` in its logits) the reference's own float32
    gradient turns non-finite (inf * 0), which is why the port's backward
    runs in float64."""
    from repro.core.ot import sinkhorn_plan as ref_plan
    e = dataclasses.replace(get_smoke_config("deepseek-moe-16b").moe,
                            num_experts=64, router="sinkhorn")
    t = 256
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(t, 64)).astype(np.float32)
    logits[:, 7] -= shift
    cost = (-torch.log_softmax(torch.tensor(logits), -1)).numpy()
    g = rng.normal(size=(t, 64)).astype(np.float32)

    def ref_scores(c, dtype):
        a = jnp.full((t,), 1.0 / t, dtype)
        b = jnp.full((64,), 1.0 / 64, dtype)
        return ref_plan(c, a, b, lamb=e.sinkhorn_lamb,
                        max_iter=e.sinkhorn_iters).plan * t

    ct = torch.tensor(cost, requires_grad=True)
    got = moe._SinkhornScores.apply(ct, e)
    assert torch.equal(got, moe._sinkhorn_scores(e, ct.detach()))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref_scores(
        jnp.asarray(cost), jnp.float32)), rtol=1e-5, atol=1e-6)
    (got * torch.tensor(g)).sum().backward()
    x64 = getattr(jax, "enable_x64", None)
    if x64 is None:                          # older jax
        from jax.experimental import enable_x64 as x64
    with x64(True):
        want = np.asarray(jax.grad(lambda c: jnp.sum(
            ref_scores(c, jnp.float64) * g))(jnp.asarray(cost, jnp.float64)))
    assert torch.isfinite(ct.grad).all()
    err = np.abs(ct.grad.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-6
    ref32 = np.asarray(jax.grad(lambda c: jnp.sum(
        ref_scores(c, jnp.float32) * g))(jnp.asarray(cost)))
    assert np.isfinite(ref32).all() == (shift == 0.0)


# -- remat, donation, determinism ---------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "whisper-small",
                                  "xlstm-125m", "recurrentgemma-9b"])
def test_remat_on_is_remat_off_bitwise(arch):
    cfg = get_smoke_config(arch)
    opt = adamw(warmup_cosine(3e-4, warmup_steps=1, total_steps=10))
    pipe = TokenPipeline(cfg, batch=2, seq_len=32)
    out = []
    for remat in (True, False):
        model = build_model(cfg, q_block=16, kv_block=16, remat=remat,
                            device="cpu")
        state = init_state(model, opt, 0)
        fn = build_train_step(model, opt, CPU)
        for i in range(2):
            state, metrics = fn(state, pipe.batch_at(i))
        out.append((state, metrics))
    assert _equal(out[0][0], out[1][0])
    assert all(torch.equal(out[0][1][k], out[1][1][k]) for k in out[0][1])


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "xlstm-125m"])
def test_donated_step_is_the_kept_step_bitwise(arch):
    cfg = get_smoke_config(arch)
    model = build_model(cfg, q_block=16, kv_block=16, device="cpu")
    opt = adamw(warmup_cosine(3e-4, warmup_steps=1, total_steps=10))
    batch = TokenPipeline(cfg, batch=2, seq_len=32).batch_at(0)
    for comp in (False, True):
        state = init_state(model, opt, 0, grad_compression=comp)
        before = _tree.tree_map(torch.clone, state)
        kept, mk = build_train_step(model, opt, CPU, donate=False,
                                    grad_compression=comp)(state, batch)
        assert _equal(state, before)                 # the input unchanged
        donated, md = build_train_step(model, opt, CPU,
                                       grad_compression=comp)(state, batch)
        assert _equal(kept, donated)
        assert all(torch.equal(mk[k], md[k]) for k in mk)
        for a, b in zip(_tree.leaves(donated.params),
                        _tree.leaves(state.params)):
            assert a is b                            # written in place
        assert (donated.comp is None) != comp


def test_two_runs_from_one_state_are_bitwise_equal():
    cfg = dataclasses.replace(get_smoke_config("deepseek-moe-16b"),
                              moe=dataclasses.replace(
                                  get_smoke_config("deepseek-moe-16b").moe,
                                  router="sinkhorn"))
    model = build_model(cfg, device="cpu")
    opt = adamw(warmup_cosine(3e-4, warmup_steps=1, total_steps=10))
    batch = TokenPipeline(cfg, batch=8, seq_len=32).batch_at(0)
    state = init_state(model, opt, 0)
    runs = [build_train_step(model, opt, CPU, donate=False)(state, batch)
            for _ in range(2)]
    assert _equal(runs[0][0], runs[1][0])
    assert all(torch.equal(runs[0][1][k], runs[1][1][k])
               for k in runs[0][1])


# -- the trainer --------------------------------------------------------------

def test_trainer_failure_restart_loss_decreases(tmp_path, no_failure_flag):
    """The reference's restart test (`tests/test_system.py`) on the port's
    one-device mesh, plus: the resumed run ends bitwise where an
    uninterrupted run ends."""
    cfg = get_smoke_config("gemma-2b")
    model = build_model(cfg, q_block=16, kv_block=16, device="cpu")
    opt = adamw(warmup_cosine(3e-4, warmup_steps=3, total_steps=20))
    pipe = TokenPipeline(cfg, batch=8, seq_len=32)
    td = str(tmp_path / "ck")
    tr = Trainer(model, opt, CPU, pipe, ckpt_dir=td, ckpt_every=4,
                 log_fn=_quiet)
    with pytest.raises(RuntimeError, match="injected node failure"):
        tr.run(0, 12, fail_at=6)
    assert os.environ["REPRO_FAILED_ONCE"] == "1"
    logs = []
    out = Trainer(model, opt, CPU, pipe, ckpt_dir=td, ckpt_every=4,
                  log_fn=logs.append).run(0, 12, fail_at=6)  # once only
    h = out["history"]
    assert h[0]["step"] == 4 and h[-1]["step"] == 11
    assert h[-1]["loss"] < h[0]["loss"]
    assert any("restoring step 4" in s for s in logs)
    ref = Trainer(model, opt, CPU, pipe, ckpt_dir=str(tmp_path / "ref"),
                  ckpt_every=4, log_fn=_quiet).run(0, 12)
    assert _equal(out["final_state"], ref["final_state"])
    assert [r["loss"] for r in ref["history"][4:]] == [r["loss"] for r in h]
    assert sorted(os.listdir(td))[-1] == "step_00000012"


def test_trainer_restore_structure_comes_from_the_meta_device(tmp_path):
    cfg = get_smoke_config("olmo-1b")
    model = build_model(cfg, device="cpu")
    opt = adamw(3e-4)
    struct = train_step.state_struct(model, opt, grad_compression=True)
    assert {x.device.type for x in _tree.leaves(struct)} == {"meta"}
    real = init_state(model, opt, 0, grad_compression=True)
    assert [(x.shape, x.dtype) for x in _tree.leaves(struct)] == \
        [(x.shape, x.dtype) for x in _tree.leaves(real)]
    tr = Trainer(model, opt, CPU, TokenPipeline(cfg, batch=2, seq_len=16),
                 ckpt_dir=str(tmp_path), log_fn=_quiet)
    assert tr._mesh_signature() == "data=1xmodel=1"
    state, start = tr.restore_or_init(0)
    assert start == 0 and _equal(state, init_state(model, opt, 0))


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def test_a_reference_run_resumes_in_the_port(tmp_path):
    """The reference's Trainer runs 8 steps, checkpointing at 4 and 8; the
    port's Trainer restores its step-4 checkpoint and runs to 8. Its
    losses follow the reference's at rtol 1e-4, and its final checkpoint
    opens in the reference."""
    import shutil
    arch = "deepseek-moe-16b"
    rcfg, tcfg = _f32(ref_get_smoke(arch)), _f32(get_smoke_config(arch))
    rm = ref_build_model(rcfg, q_block=16, kv_block=16)
    tm = build_model(tcfg, q_block=16, kv_block=16, device="cpu")
    mesh = ref_make_mesh((1, 1), ("data", "model"))
    ropt = ref_adamw(ref_warmup_cosine(1e-3, warmup_steps=1, total_steps=8))
    topt = adamw(warmup_cosine(1e-3, warmup_steps=1, total_steps=8))
    rpipe = RefTokenPipeline(rcfg, batch=4, seq_len=32)
    td, full = str(tmp_path / "ck"), str(tmp_path / "full")
    ref = RefTrainer(rm, ropt, mesh, rpipe, ckpt_dir=full, ckpt_every=4,
                     log_fn=_quiet).run(jax.random.PRNGKey(0), 8)
    shutil.copytree(os.path.join(full, "step_00000004"),
                    os.path.join(td, "step_00000004"))
    logs = []
    out = Trainer(tm, topt, CPU, TokenPipeline(tcfg, batch=4, seq_len=32),
                  ckpt_dir=td, ckpt_every=4, log_fn=logs.append).run(0, 8)
    assert any("restoring step 4" in s for s in logs)
    np.testing.assert_allclose([h["loss"] for h in out["history"]],
                               [h["loss"] for h in ref["history"][4:]],
                               rtol=1e-4)
    from repro.checkpoint import checkpointer as ref_ckpt
    back = ref_ckpt.restore(td, 8, jax.eval_shape(
        lambda: ref_step.init_state(rm, ropt, jax.random.PRNGKey(0))))
    assert int(back.opt.step) == 8
    for a, b in zip(jax.tree.leaves(back), _tree.leaves(out["final_state"])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# -- conversion and the launcher ----------------------------------------------

def test_train_state_from_numpy_copies_bit_for_bit():
    arch = "xlstm-125m"
    rcfg = ref_get_smoke(arch)
    rm = ref_build_model(rcfg)
    ropt = ref_adamw(3e-4)
    rs = ref_step.init_state(rm, ropt, jax.random.PRNGKey(0),
                             grad_compression=True)
    rs = rs._replace(opt=rs.opt._replace(step=jnp.asarray(5, jnp.int32)))
    host = jax.tree.map(np.asarray, rs)
    ts = train_state_from_numpy(host, device="cpu")
    assert ts.opt.step.dtype == torch.int32 and int(ts.opt.step) == 5
    ref_flat = jax.tree_util.tree_flatten_with_path(host)[0]
    port_flat = _tree.flatten_with_path(ts)
    assert [jax.tree_util.keystr(p) for p, _ in ref_flat] == \
        [_tree.keystr(p) for p, _ in port_flat]
    for (_, a), (_, b) in zip(ref_flat, port_flat):
        assert b.dtype == torch.from_numpy(np.asarray(a)).dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # a copy: training the port's state in place leaves the arrays alone
    before = host.params["embedding"]["embed"].copy()
    ts.params["embedding"]["embed"].add_(1.0)
    np.testing.assert_array_equal(host.params["embedding"]["embed"], before)
    bad = host._replace(opt=host.opt._replace(step=np.float32(1.0)))
    with pytest.raises(ValueError, match="opt.step"):
        train_state_from_numpy(bad, device="cpu")


def _launch(args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_train.main(args)
    return out.getvalue()


def test_launcher_trains_and_resumes_on_the_cpu(tmp_path, no_failure_flag):
    td = str(tmp_path / "ck")
    common = ["--arch", "gemma-2b", "--smoke", "--ckpt-every", "2",
              "--batch", "2", "--seq-len", "32", "--device", "cpu",
              "--ckpt-dir", td]
    first = _launch(["--steps", "4", *common])
    assert "[train] arch=gemma-2b-smoke devices=1 " \
           "mesh={'data': 1, 'model': 1} on cpu" in first
    assert "[train] done: step 3 loss" in first
    assert "restoring" not in first
    second = _launch(["--steps", "6", *common])
    assert f"[trainer] restoring step 4 from {td}" in second
    assert "[train] done: step 5 loss" in second
    for i, (flags, shape) in enumerate((
            (["--devices", "2"], "{'data': 2, 'model': 1}"),
            (["--devices", "2", "--mesh", "2x1"], "{'data': 2, 'model': 1}"),
            (["--devices", "2", "--mesh", "1x1x2"],
             "{'pod': 1, 'data': 1, 'model': 2}"))):
        on_mesh = _launch(["--steps", "1", *common, *flags, "--ckpt-dir",
                           str(tmp_path / f"mesh{i}")])
        assert f"devices=2 mesh={shape} on cpu" in on_mesh
        assert "[train] done: step 0 loss" in on_mesh
    moe_run = _launch(["--arch", "deepseek-moe-16b", "--smoke", "--steps",
                       "2", "--router", "sinkhorn", "--microbatches", "2",
                       "--grad-compression", "--batch", "2", "--seq-len",
                       "16", "--device", "cpu", "--ckpt-dir",
                       str(tmp_path / "moe")])
    assert "[train] done: step 1 loss" in moe_run
