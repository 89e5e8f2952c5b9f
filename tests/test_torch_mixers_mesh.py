"""The mixers on a mesh of logical CPU shards: multi-head latent attention
(minicpm3-4b), RG-LRU with local attention (recurrentgemma-9b), mLSTM and
sLSTM (xlstm-125m) and the encoder-decoder (whisper-small).

The reference serves on meshes of forced host devices in one subprocess
(``XLA_FLAGS`` as `tests/test_torch_lm_mesh.py` sets them), writing its
outputs to an npz; the port serves the same parameters (the reference's
``init``, through `convert.lm_params_from_numpy`) on `launch.mesh.make_mesh`
meshes of ``[torch.device("cpu")] * n`` logical shards. Cases, smoke
configs in float32 compute with a float32 cache in both packages, batch
4, 16 prompt tokens, 4 decode steps of fixed tokens: minicpm3-4b on
(2, 2) with the absorbed and the naive (``mla_absorbed=False``) decode;
recurrentgemma-9b on (2, 2) and (1, 2, 2) (the local attention's ring of
16 slots wraps in the decode steps); xlstm-125m on (2, 2) (two heads, one
a model shard) and (1, 4) (the heads do not divide ``model``: the mLSTM
runs whole on the group's owner, its matrix state's head_dim rows split
over ``model``); whisper-small on (2, 2). Whisper's decoder embeds at
bfloat16 whatever the compute dtype in both packages (ROADMAP Queue 3);
here that default is lifted to float32 in both alike, a wrapper in the
test only (as `tests/test_torch_train_grads_mixers.py` does), so its
logits and its cross-attention K / V are held at the float32 tolerance.
The prefill's last-position logits and every decode step's: rtol 1e-4,
atol 1e-5.

The port's own contracts: meshes against the one-device answers (float32
tolerance; whisper as it is, with its bfloat16 decoder, and bfloat16
compute at 2e-2 of the largest logit), every cache leaf a `Placed` whose
spec is `cache_shardings`' and whose blocks lie on their positions with
their regions' shapes (the latent cache, the recurrent states, the cross
K / V), the donated and the kept decode bitwise.
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
from repro_torch.models import build_model, encdec, lm
from repro_torch.models.layers import embedding
from repro_torch.serving import build_serve_fns

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_XLA_FLAGS = ("--xla_force_host_platform_device_count=8 "
                 "--xla_backend_optimization_level=0 "
                 "--xla_llvm_disable_expensive_passes=true")
F32 = dict(rtol=1e-4, atol=1e-5)
B, S, STEPS = 4, 16, 4
# (arch, mla_absorbed or None, mesh shape)
CASES = [("minicpm3-4b", True, (2, 2)), ("minicpm3-4b", False, (2, 2)),
         ("recurrentgemma-9b", None, (2, 2)),
         ("recurrentgemma-9b", None, (1, 2, 2)),
         ("xlstm-125m", None, (2, 2)), ("xlstm-125m", None, (1, 4)),
         ("whisper-small", None, (2, 2))]

_REF = """
import dataclasses, functools, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.launch.mesh import make_mesh
from repro.models import build_model, encdec, lm
from repro.models.layers import embedding
from repro.models.sharding_hints import activation_sharding
from repro.serving.serve_step import build_serve_fns
lm.prefill = functools.partial(lm.prefill, cache_dtype=jnp.float32)
encdec.prefill = functools.partial(encdec.prefill, cache_dtype=jnp.float32)
embed = embedding.embed
B, S, STEPS = {B}, {S}, {STEPS}
out = {{}}
for arch, absorbed, shape in {CASES!r}:
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    if absorbed is not None:
        cfg = dataclasses.replace(cfg, mla_absorbed=absorbed)
    audio = cfg.family == "audio"
    embedding.embed = functools.partial(embed, dtype=jnp.float32) \\
        if audio else embed
    model = build_model(cfg, q_block=8, kv_block=8)
    params = model.init(jax.random.PRNGKey(0))
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    mesh = make_mesh(shape, axes)
    pf, df = build_serve_fns(model, mesh, max_len=S + STEPS)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    batch = {{"tokens": jnp.asarray(toks[:, :S])}}
    if audio:
        batch["frames"] = jnp.asarray(rng.normal(size=(
            B, cfg.encoder.num_positions, cfg.d_model)).astype(np.float32))
    key = arch + "-" + str(absorbed) + "-" + "x".join(map(str, shape))
    with mesh, activation_sharding(mesh):
        logits, cache = pf(B)(params, batch)
        if audio:
            out[key + "/cross_k"] = np.asarray(cache["cross_k"])
            out[key + "/cross_v"] = np.asarray(cache["cross_v"])
        outs = [np.asarray(logits)[:, -1]]
        dec = df(B, donate_cache=False)
        for i in range(STEPS):
            logits, cache = dec(params, cache,
                                jnp.asarray(toks[:, S + i:S + i + 1]))
            outs.append(np.asarray(logits)[:, -1])
    out[key] = np.stack(outs)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these smoke shapes (as
    `tests/test_torch_lm_mesh.py`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's outputs of every case, from one subprocess."""
    path = str(tmp_path_factory.mktemp("ref") / "serve.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=REF_XLA_FLAGS,
               PYTHONPATH=os.path.join(REPO, "src"))
    code = _REF.format(B=B, S=S, STEPS=STEPS, CASES=CASES)
    run = subprocess.run([sys.executable, "-c", code, path], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(path))


@pytest.fixture
def f32_cache(monkeypatch):
    """A float32 decode cache from the model API's prefill."""
    for mod in (lm, encdec):
        monkeypatch.setattr(mod, "prefill", functools.partial(
            mod.prefill, cache_dtype=torch.float32))


def _cfg(arch, absorbed=None, dtype="float32"):
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=dtype)
    if absorbed is not None:
        cfg = dataclasses.replace(cfg, mla_absorbed=absorbed)
    return cfg


@functools.lru_cache(maxsize=8)
def _ref_params(arch):
    params = ref_build_model(ref_get_smoke(arch)).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _mesh(shape):
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return make_mesh(shape, axes,
                     devices=[torch.device("cpu")] * int(np.prod(shape)))


def _serve(cfg, params, mesh, *, donate=True):
    """Last-position logits of the prefill and of STEPS decode steps of
    fixed tokens ((STEPS + 1, B, V)), and the prefill's cache."""
    model = build_model(cfg, q_block=8, kv_block=8, device="cpu")
    pf, df = build_serve_fns(model, mesh, max_len=S + STEPS)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    batch = {"tokens": toks[:, :S]}
    if cfg.family == "audio":
        batch["frames"] = rng.normal(size=(
            B, cfg.encoder.num_positions, cfg.d_model)).astype(np.float32)
    logits, cache = pf(B)(params, batch)
    first = lm._tree_map(torch.clone, cache)
    outs = [logits[:, -1]]
    dec = df(B, donate_cache=donate)
    for i in range(STEPS):
        logits, cache = dec(params, cache, toks[:, S + i:S + i + 1])
        outs.append(logits[:, -1])
    return torch.stack(outs).float().numpy(), first


def _logical(x):
    return (x.unshard() if isinstance(x, part.Placed) else x).numpy()


@pytest.mark.parametrize("arch,absorbed,shape", CASES)
def test_mesh_serving_matches_reference_on_the_same_mesh(
        reference, f32_cache, monkeypatch, arch, absorbed, shape):
    cfg = _cfg(arch, absorbed)
    if cfg.family == "audio":
        monkeypatch.setattr(embedding, "mesh_embed", functools.partial(
            embedding.mesh_embed, dtype=torch.float32))
    params = lm_params_from_numpy(_ref_params(arch), device="cpu")
    got, cache = _serve(cfg, params, _mesh(shape))
    key = f"{arch}-{absorbed}-{'x'.join(map(str, shape))}"
    assert got.shape == reference[key].shape
    np.testing.assert_allclose(got, reference[key], **F32)
    if cfg.family == "audio":
        for k in ("cross_k", "cross_v"):
            assert isinstance(cache[k], part.Placed)
            np.testing.assert_allclose(_logical(cache[k]),
                                       reference[f"{key}/{k}"], **F32)


@pytest.mark.parametrize("arch,shape", [
    ("minicpm3-4b", (4, 1)), ("minicpm3-4b", (1, 3)),
    ("recurrentgemma-9b", (1, 4)), ("recurrentgemma-9b", (1, 3)),
    ("xlstm-125m", (2, 1, 2)), ("xlstm-125m", (1, 3)),
    ("whisper-small", (1, 4))])
def test_mesh_serving_matches_one_device(f32_cache, arch, shape):
    """A mesh against the port's one-device answers, float32 (model = 3
    splits no smoke config's heads or channels: every mixer runs whole
    on each batch group's owner; whisper's bfloat16 decoder as it is, at
    the bfloat16 bound)."""
    cfg = _cfg(arch)
    params = build_model(cfg, device="cpu").init(0)
    one, _ = _serve(cfg, params, None)
    got, _ = _serve(cfg, params, _mesh(shape))
    if cfg.family == "audio":
        assert np.abs(got - one).max() / np.abs(one).max() <= 2e-2
    else:
        np.testing.assert_allclose(got, one, **F32)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "recurrentgemma-9b",
                                  "xlstm-125m", "whisper-small"])
def test_mesh_serving_bf16_within_the_bf16_bound(arch):
    cfg = _cfg(arch, dtype="bfloat16")
    params = build_model(cfg, device="cpu").init(0)
    one, _ = _serve(cfg, params, None)
    got, _ = _serve(cfg, params, _mesh((2, 2)))
    assert np.abs(got - one).max() / np.abs(one).max() <= 2e-2


@pytest.mark.parametrize("arch,shape", [
    ("minicpm3-4b", (2, 2)), ("recurrentgemma-9b", (2, 2)),
    ("xlstm-125m", (2, 2)), ("xlstm-125m", (1, 4)),
    ("whisper-small", (2, 2))])
def test_cache_blocks_lie_on_their_positions_with_their_specs_shapes(
        arch, shape):
    """Every tensor of the prefill's cache is a `Placed` leaf whose spec
    is `cache_shardings`' for its logical tensor, each block on its
    position's device with its region's shape, and the cache's positions
    Python ints."""
    cfg = _cfg(arch)
    mesh = _mesh(shape)
    params = build_model(cfg, device="cpu").init(0)
    _, cache = _serve(cfg, params, mesh)
    logical = part.unshard(cache)
    want = part.cache_shardings(mesh, logical)
    leaves = _tree.leaves(cache)
    specs = _tree.leaves(want)
    assert len(leaves) == len(specs)
    n = 0
    for leaf, sh in zip(leaves, specs):
        if not isinstance(leaf, part.Placed):
            assert isinstance(leaf, int)
            continue
        n += 1
        assert leaf.spec == sh.spec, (leaf.shape, leaf.spec, sh.spec)
        for c in np.ndindex(leaf.blocks.shape):
            blk = leaf.blocks[c]
            assert blk.device == mesh.devices[c]
            r = part.block_slices(mesh, leaf.spec, leaf.shape, c)
            assert tuple(blk.shape) == tuple(s.stop - s.start for s in r)
    assert n > 0
    if arch == "xlstm-125m":     # the matrix state: heads, or head_dim rows
        c_spec = cache["units"][0].c.spec
        assert c_spec[2 if shape == (2, 2) else 3] == "model"
    if arch == "whisper-small":
        assert cache["cross_k"].spec[3] == "model"


@pytest.mark.parametrize("arch", ["minicpm3-4b", "recurrentgemma-9b",
                                  "xlstm-125m", "whisper-small"])
def test_donated_and_kept_decode_agree_bitwise_on_a_mesh(arch):
    cfg = _cfg(arch)
    params = build_model(cfg, device="cpu").init(0)
    mesh = _mesh((2, 2))
    kept, _ = _serve(cfg, params, mesh, donate=False)
    donated, _ = _serve(cfg, params, mesh, donate=True)
    assert np.array_equal(kept, donated)


def test_whisper_encoder_on_a_mesh_matches_one_device():
    """The encoder (float32 compute) of one (B_g, frames, D) tensor a
    batch group against the one-device encoder, float32 tolerance."""
    cfg = _cfg("whisper-small")
    params = build_model(cfg, device="cpu").init(0)
    frames = torch.from_numpy(np.random.default_rng(5).normal(size=(
        B, cfg.encoder.num_positions, cfg.d_model)).astype(np.float32))
    one = encdec.encode(cfg, params, frames)
    mesh = _mesh((2, 2))
    placed = part.shard(params, part.param_shardings(mesh, params))
    got = encdec.encode(cfg, placed, [frames[:2], frames[2:]])
    np.testing.assert_allclose(torch.cat(got).numpy(), one.numpy(), **F32)
