"""The port's language models served on a mesh of logical CPU shards.

The reference runs on meshes of forced host devices in one subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
`tests/test_system.py` does), writing its outputs to an npz; the port runs
the same parameters (the reference's ``init``, through
`convert.lm_params_from_numpy`) on `launch.mesh.make_mesh` meshes of
``[torch.device("cpu")] * n`` logical shards, one program in this process.

Served: deepseek-moe-16b (top-k on (2, 2), Sinkhorn on (1, 2, 2)),
gemma-2b (MQA: the head dim of ``wk`` / ``wv`` and the KV cache's
sequence split over ``model``; both meshes) and olmo-1b (2, 2) smoke
configs, float32 compute:
the prefill's last-position logits and 4 decode steps of fixed tokens,
held at the float32 tolerance of `tests/test_torch_lm.py` (rtol 1e-4, atol
1e-5) with a float32 cache in both packages (`lm.prefill`'s
``cache_dtype``; a bfloat16 cache entry one float32 ulp apart may round
to neighbouring bfloat16 values). The port's own contracts: meshes
against its one-device answers (float32 tolerance; bfloat16 at 2e-2,
5e-2 for MoE), blocks on their positions with their specs' shapes, the
donated and the kept decode bitwise, and the mixers (MLA, RG-LRU, xLSTM,
the encoder-decoder) taking a mesh.
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
from repro_torch import _tree
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.distributed import partitioning as part
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model, lm
from repro_torch.models.sharding_hints import activation_sharding
from repro_torch.serving import build_serve_fns
from repro_torch.train import build_train_step
from repro_torch.optim import adamw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 8 host devices; XLA's cheaper CPU compile (a third less CPU time: the
# reference's compiles are most of these files' cost, and rounding only
# moves within the tolerances)
REF_XLA_FLAGS = ("--xla_force_host_platform_device_count=8 "
                 "--xla_backend_optimization_level=0 "
                 "--xla_llvm_disable_expensive_passes=true")
F32 = dict(rtol=1e-4, atol=1e-5)
B, S, STEPS = 4, 16, 4
CASES = [("deepseek-moe-16b", "topk", (2, 2)),
         ("deepseek-moe-16b", "sinkhorn", (1, 2, 2)),
         ("gemma-2b", None, (2, 2)), ("gemma-2b", None, (1, 2, 2)),
         ("olmo-1b", None, (2, 2))]

_REF = """
import dataclasses, functools, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.launch.mesh import make_mesh
from repro.models import build_model, lm
from repro.models.sharding_hints import activation_sharding
from repro.serving.serve_step import build_serve_fns
lm.prefill = functools.partial(lm.prefill, cache_dtype=jnp.float32)
B, S, STEPS = {B}, {S}, {STEPS}
out = {{}}
for arch, router, shape in {CASES!r}:
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    if router:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, router=router))
    model = build_model(cfg, q_block=8, kv_block=8)
    params = model.init(jax.random.PRNGKey(0))
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    mesh = make_mesh(shape, axes)
    pf, df = build_serve_fns(model, mesh, max_len=S + STEPS)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    with mesh, activation_sharding(mesh):
        logits, cache = pf(B)(params, {{"tokens": jnp.asarray(toks[:, :S])}})
        outs = [np.asarray(logits)[:, -1]]
        dec = df(B, donate_cache=False)
        for i in range(STEPS):
            logits, cache = dec(params, cache,
                                jnp.asarray(toks[:, S + i:S + i + 1]))
            outs.append(np.asarray(logits)[:, -1])
    out[arch + "-" + str(router) + "-" + "x".join(map(str, shape))] = \\
        np.stack(outs)
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
    """The reference's logits of every case, from one subprocess."""
    path = str(tmp_path_factory.mktemp("ref") / "serve.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=REF_XLA_FLAGS,
               PYTHONPATH=os.path.join(REPO, "src"))
    code = _REF.format(B=B, S=S, STEPS=STEPS, CASES=CASES)
    run = subprocess.run([sys.executable, "-c", code, path], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(path))


def _cfg(arch, router=None, dtype="float32"):
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=dtype)
    if router:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, router=router))
    return cfg


@functools.lru_cache(maxsize=8)
def _ref_params(arch):
    """The reference's smoke parameters (PRNGKey 0) as numpy."""
    params = ref_build_model(ref_get_smoke(arch)).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _mesh(shape):
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return make_mesh(shape, axes,
                     devices=[torch.device("cpu")] * int(np.prod(shape)))


def _serve(cfg, params, mesh, toks, *, donate=True):
    """Last-position logits of the prefill and of STEPS decode steps of
    the fixed tokens: (STEPS + 1, B, V)."""
    model = build_model(cfg, q_block=8, kv_block=8, device="cpu")
    pf, df = build_serve_fns(model, mesh, max_len=S + STEPS)
    with activation_sharding(mesh):
        logits, cache = pf(B)(params, {"tokens": toks[:, :S]})
        outs = [logits[:, -1]]
        dec = df(B, donate_cache=donate)
        for i in range(STEPS):
            logits, cache = dec(params, cache, toks[:, S + i:S + i + 1])
            outs.append(logits[:, -1])
    return torch.stack(outs).float().numpy(), cache


def _toks(cfg):
    return np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S + STEPS)).astype(np.int32)


@pytest.mark.parametrize("arch,router,shape", CASES)
def test_mesh_serving_matches_reference_on_the_same_mesh(
        reference, monkeypatch, arch, router, shape):
    monkeypatch.setattr(lm, "prefill", functools.partial(
        lm.prefill, cache_dtype=torch.float32))
    cfg = _cfg(arch, router)
    params = lm_params_from_numpy(_ref_params(arch), device="cpu")
    got, _ = _serve(cfg, params, _mesh(shape), _toks(cfg))
    want = reference[f"{arch}-{router}-{'x'.join(map(str, shape))}"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("arch,shape", [
    ("deepseek-moe-16b", (4, 1)), ("deepseek-moe-16b", (2, 1, 2)),
    ("gemma-2b", (1, 2)), ("gemma-2b", (4, 1)), ("olmo-1b", (2, 1, 2)),
    ("mixtral-8x22b", (2, 2)), ("starcoder2-3b", (2, 2)),
    ("paligemma-3b", (2, 2)), ("gemma-2b", (1, 3)),
    ("deepseek-moe-16b", (1, 3))])
def test_mesh_serving_matches_one_device(monkeypatch, arch, shape):
    """A (d, m) mesh against the port's own one-device answers, float32
    (mixtral: the sliding-window ring of 16 slots; starcoder2: the GELU
    MLP's biases, ``bo`` added by the first model shard; paligemma: the
    patch prefix; model = 3 splits no smoke config's heads, hidden units
    or vocabulary into whole units, so every layer runs whole on each
    batch group's owner and the cache is replicated over ``model``)."""
    monkeypatch.setattr(lm, "prefill", functools.partial(
        lm.prefill, cache_dtype=torch.float32))
    cfg = _cfg(arch)
    params = build_model(cfg, device="cpu").init(0)
    toks = _toks(cfg)
    one, _ = _serve_any(cfg, params, None, toks)
    got, _ = _serve_any(cfg, params, _mesh(shape), toks)
    np.testing.assert_allclose(got, one, **F32)


def _serve_any(cfg, params, mesh, toks):
    """`_serve` with the patch embeddings of the vlm family."""
    if cfg.family != "vlm":
        return _serve(cfg, params, mesh, toks)
    model = build_model(cfg, q_block=8, kv_block=8, device="cpu")
    p = cfg.encoder.num_positions
    batch = {"tokens": toks[:, :S], "patches": np.random.default_rng(4)
             .normal(size=(B, p, cfg.d_model)).astype(np.float32)}
    pf, df = build_serve_fns(model, mesh, max_len=S + STEPS + p)
    logits, cache = pf(B)(params, batch)
    outs = [logits[:, -1]]
    for i in range(STEPS):
        logits, cache = df(B)(params, cache, toks[:, S + i:S + i + 1])
        outs.append(logits[:, -1])
    return torch.stack(outs).float().numpy(), cache


@pytest.mark.parametrize("arch,bound", [("deepseek-moe-16b", 5e-2),
                                        ("gemma-2b", 2e-2)])
def test_mesh_serving_bf16_within_the_bf16_bound(arch, bound):
    cfg = _cfg(arch, dtype="bfloat16")
    params = build_model(cfg, device="cpu").init(0)
    toks = _toks(cfg)
    one, _ = _serve(cfg, params, None, toks)
    got, _ = _serve(cfg, params, _mesh((2, 2)), toks)
    assert np.abs(got - one).max() / np.abs(one).max() <= bound


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "gemma-2b"])
def test_blocks_lie_on_their_positions_with_their_specs_shapes(arch):
    """Every parameter and cache block on its position's device, shaped
    as its sanitized spec cuts the logical tensor; `unshard` gives the
    logical tensor back bitwise. A mesh mixing "cpu" and "meta" devices
    shows a misplaced block on the CPU."""
    cfg = _cfg(arch)
    params = build_model(cfg, device="cpu").init(0)
    mixed = make_mesh((2, 2), ("data", "model"), devices=[
        torch.device("cpu"), torch.device("meta"), torch.device("meta"),
        torch.device("cpu")])
    placed = part.shard(params, part.param_shardings(mixed, params))
    for leaf, x in zip(_tree.leaves(placed), _tree.leaves(params)):
        assert isinstance(leaf, part.Placed)
        for c in np.ndindex(leaf.blocks.shape):
            blk = leaf.blocks[c]
            assert blk.device == mixed.devices[c]
            want = part.block_slices(mixed, leaf.spec, x.shape, c)
            assert tuple(blk.shape) == tuple(s.stop - s.start for s in want)
    mesh = _mesh((2, 2))
    placed = part.shard(params, part.param_shardings(mesh, params))
    for leaf, x in zip(_tree.leaves(placed), _tree.leaves(params)):
        assert torch.equal(leaf.unshard(), x)
    # the cache: per `cache_shardings` (gemma's one kv head: the sequence
    # over model; deepseek's 4: the heads)
    _, cache = _serve(cfg, params, mesh, _toks(cfg))
    blocks = [x for x in _tree.leaves(cache) if isinstance(x, part.Placed)]
    plan = lm.stack_plan(cfg)
    assert len(blocks) == 2 * (len(plan.prefix) + len(plan.unit)
                               + len(plan.tail))
    for leaf in blocks:
        kv_axis = 2 if cfg.num_kv_heads % 2 == 0 else 1
        assert leaf.spec[leaf.ndim - 4 + kv_axis] == "model"
        for c in np.ndindex(leaf.blocks.shape):
            assert leaf.blocks[c].device == mesh.devices[c]


def test_donated_and_kept_decode_agree_bitwise_on_a_mesh():
    cfg = _cfg("gemma-2b")
    params = build_model(cfg, device="cpu").init(0)
    toks = _toks(cfg)
    mesh = _mesh((2, 2))
    kept, _ = _serve(cfg, params, mesh, toks, donate=False)
    donated, _ = _serve(cfg, params, mesh, toks, donate=True)
    assert np.array_equal(kept, donated)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "recurrentgemma-9b",
                                  "xlstm-125m", "whisper-small"])
def test_mixers_refuse_a_mesh_citing_item_5e(arch):
    """The mixers that once refused a mesh (ROADMAP Queue 1 item 5e, now
    done) take one: `build_serve_fns` and `build_train_step` accept a
    (2, 1) mesh, and the prefill serves on its CPU shards, the cache
    placed on them (`tests/test_torch_mixers_mesh.py` holds the
    numbers)."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg, q_block=8, kv_block=8, device="cpu")
    mesh = _mesh((2, 1))
    prefill_for, _ = build_serve_fns(model, mesh, max_len=8)
    build_train_step(model, adamw(1e-3), mesh)
    batch = {"tokens": np.zeros((2, 4), np.int32)}
    if cfg.family == "audio":
        batch["frames"] = np.zeros((2, cfg.encoder.num_positions,
                                    cfg.d_model), np.float32)
    with activation_sharding(mesh):
        logits, cache = prefill_for(2)(model.init(0), batch)
    assert tuple(logits.shape) == (2, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all()) and cache["pos"] == 4
    assert all(isinstance(x, part.Placed) or isinstance(x, int)
               for x in _tree.leaves(cache))


def test_a_batch_that_does_not_split_over_the_groups_is_refused():
    """Three rows over a (2, 2) mesh's two batch groups (the batch spec
    would replicate them, and each group would serve every row)."""
    cfg = _cfg("olmo-1b")
    model = build_model(cfg, q_block=8, kv_block=8, device="cpu")
    prefill_for, _ = build_serve_fns(model, _mesh((2, 2)), max_len=8)
    with pytest.raises(ValueError, match="does not split"):
        prefill_for(3)(model.init(0), {"tokens": np.zeros((3, 4), np.int32)})
