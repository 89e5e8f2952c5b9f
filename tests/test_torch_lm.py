"""The port's language-model serving path against live JAX, on the CPU.

The same inputs, made from fixed seeds with numpy, go through the JAX
package (`repro.models`, `repro.configs`, `repro.data.tokens`) and the
port (`repro_torch.models`, ...). Weights come from the reference's
``init`` and reach the port through `repro_torch.convert.
lm_params_from_numpy`, so both compute from the same parameters.

Tolerances:
* float32 compute (``compute_dtype="float32"``): rtol 1e-4, atol 1e-5 on
  logits and layer outputs (the same math, sums reassociated). The decode
  cache is bfloat16 in both packages (``cache_dtype``); a K or V entry
  one float32 ulp apart may round to neighbouring bfloat16 values, so the
  float32 decode steps are held at the float32 tolerance through
  `lm.prefill` / `lm.decode_step` with a float32 cache, and through the
  model's API (bfloat16 cache) at the bfloat16 bounds.
* bfloat16 compute: relative error (max |port - ref| / max |ref|) at most
  2e-2 for dense models and 5e-2 for MoE models (the reference's own
  bounds, `tests/test_archs_smoke.py:110`) and for the xLSTM (``ssm``)
  smoke model, whose bfloat16 logits lie up to 3.05e-2 from its own
  float32 ones in live JAX (seed 11, step 2; the port's 2.39e-2), so that
  two bfloat16 runs cannot be held closer; and the port's greedy token is
  the reference's, or one whose reference logit is within one bfloat16
  step of the reference's largest: the logits are bfloat16, and two
  tokens that close tie at their own resolution (seen: olmo-1b, two
  logits both 2.0625; mixtral-8x22b, 3.484375 against 3.46875).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch  # noqa: F401  (precision pins)
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke
from repro.configs import registry as ref_registry
from repro.configs.base import ModelConfig as RefModelConfig
from repro.configs.base import MoEConfig as RefMoEConfig
from repro.data.tokens import TokenPipeline as RefTokenPipeline
from repro.data.tokens import batch_struct as ref_batch_struct
from repro.models import build_model as ref_build_model
from repro.models import lm as ref_lm
from repro.models.layers import attention as ref_attention
from repro.models.layers import embedding as ref_embedding
from repro.models.layers import mlp as ref_mlp
from repro.models.layers import moe as ref_moe
from repro.models.layers import norms as ref_norms
from repro.models.layers import rope as ref_rope
from repro_torch.configs import (SHAPES, arch_ids, cell_supported, cells,
                                 get_config, get_shape, get_smoke_config)
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data import TokenPipeline, batch_struct
from repro_torch.launch.mesh import make_mesh, one_device_mesh
from repro_torch.models import build_model, cross_entropy
from repro_torch.models import lm
from repro_torch.models.layers import (attention, embedding, mlp, moe,
                                       norms, rope)
from repro_torch.models.sharding_hints import activation_sharding
from repro_torch.serving import build_serve_fns

F32 = dict(rtol=1e-4, atol=1e-5)
SERVED = ("deepseek-moe-16b", "mixtral-8x22b", "olmo-1b", "gemma-2b",
          "starcoder2-3b", "paligemma-3b", "minicpm3-4b", "recurrentgemma-9b",
          "xlstm-125m")


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _tree_t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), tree)


def _flat(tree, path=""):
    """[(path, shape, dtype name)] of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return [e for k in sorted(tree) for e in _flat(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [e for i, v in enumerate(tree) for e in _flat(v, f"{path}/{i}")]
    return [(path, tuple(tree.shape), str(tree.dtype).replace("torch.", ""))]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(a, r):
    return float(np.abs(a - r).max() / max(np.abs(r).max(), 1e-6))


def _greedy_agrees(a, r, steps=0):
    """The port's greedy token is the reference's, or one whose reference
    logit is within ``steps`` bfloat16 steps of the reference's maximum
    (a tie at the logits' own resolution)."""
    ia = a.argmax(-1)
    picked = np.take_along_axis(r, ia[..., None], -1)[..., 0]
    top = r.max(-1)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(top))) - 7)     # bfloat16 step
    assert np.all(picked >= top - steps * ulp), (ia, r.argmax(-1), picked,
                                                 top)


def _cfgs(arch, *, dtype=None, router=None, cf=None):
    """The reference's and the port's smoke config, changed alike."""
    out = []
    for cfg in (ref_get_smoke(arch), get_smoke_config(arch)):
        if dtype is not None:
            cfg = dataclasses.replace(cfg, compute_dtype=dtype)
        if cfg.moe is not None and (router or cf):
            moe_cfg = cfg.moe
            if router:
                moe_cfg = dataclasses.replace(moe_cfg, router=router)
            if cf:
                moe_cfg = dataclasses.replace(moe_cfg, capacity_factor=cf)
            cfg = dataclasses.replace(cfg, moe=moe_cfg)
        out.append(cfg)
    return out


def _models(arch, **kw):
    """(ref model, ref params, port model, port params) from one init."""
    rcfg, tcfg = _cfgs(arch, **kw)
    rm = ref_build_model(rcfg, q_block=16, kv_block=16)
    params = rm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, q_block=16, kv_block=16, device="cpu")
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, params),
                              device="cpu")
    return rm, params, tm, tp


def _batch(cfg, rng, b, s):
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.normal(
            size=(b, cfg.encoder.num_positions, cfg.d_model)).astype(
                np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.normal(
            size=(b, cfg.encoder.num_positions, cfg.d_model)).astype(
                np.float32)
    return out


def _leaves(tree):
    """The tensor / array leaves of a cache, in order; the positions
    (``pos``, an int in the port, an array in the reference) left out."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) if k != "pos"
                for x in _leaves(tree[k])]
    if hasattr(tree, "_fields"):
        return [x for f in tree._fields if f != "pos"
                for x in _leaves(getattr(tree, f))]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if hasattr(tree, "shape") else []


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# -- configs ----------------------------------------------------------------

@pytest.mark.parametrize("arch", ref_registry.arch_ids())
def test_configs_are_the_reference_configs(arch):
    for mine, ref in ((get_config(arch), ref_get_config(arch)),
                      (get_smoke_config(arch), ref_get_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.param_count() == ref.param_count()
        assert mine.active_param_count() == ref.active_param_count()
        assert mine.layer_kinds() == ref.layer_kinds()


def test_registry_matches_reference():
    assert arch_ids() == ref_registry.arch_ids()
    assert cells() == ref_registry.cells()
    for arch, shape in cells():
        assert cell_supported(arch, shape) == \
            ref_registry.cell_supported(arch, shape)
    for name in SHAPES:
        assert dataclasses.asdict(get_shape(name)) == \
            dataclasses.asdict(ref_registry.get_shape(name))
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_deepseek_full_config_is_the_published_one():
    cfg = get_config("deepseek-moe-16b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.vocab_size) == (28, 2048, 16, 16, 128, 102400)
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.d_ff_expert,
            cfg.moe.num_shared, cfg.moe.first_dense_layers,
            cfg.moe.d_ff_dense_first) == (64, 6, 1408, 2, 1, 10944)


# -- layers -----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparam_ln"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_reference(kind, dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 24)).astype(np.float32) * 3 + 1
    p = {}
    if kind != "nonparam_ln":
        p["scale"] = rng.normal(size=24).astype(np.float32)
    if kind == "layernorm":
        p["bias"] = rng.normal(size=24).astype(np.float32)
    want = ref_norms.apply(kind, {k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x).astype(dtype))
    got = norms.apply(kind, {k: _t(v) for k, v in p.items()},
                      _t(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    tol = F32 if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    assert norms.init(kind, 24).keys() == ref_norms.init(kind, 24).keys()


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = np.arange(5, 14)
    want = ref_rope.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=theta)
    got = rope.apply_rope(_t(x), _t(pos), theta=theta)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("kind", ["silu_glu", "geglu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_matches_reference(kind, dtype):
    p = ref_mlp.init(jax.random.PRNGKey(3), kind, 32, 48)
    if kind == "gelu":   # non-zero biases
        p = dict(p, bi=p["bi"] + 0.1, bo=p["bo"] - 0.2)
    x = np.random.default_rng(2).normal(size=(2, 7, 32)).astype(np.float32)
    want = ref_mlp.apply(kind, p, jnp.asarray(x).astype(dtype))
    got = mlp.apply(kind, {k: _t(v) for k, v in p.items()},
                    _t(x).to(getattr(torch, dtype)))
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    else:
        assert _rel(_np(got), _np(want)) < 2e-2
    shapes = {k: tuple(v.shape) for k, v in
              mlp.init(torch.Generator().manual_seed(0), kind, 32,
                       48).items()}
    assert shapes == {k: v.shape for k, v in p.items()}


@pytest.mark.parametrize("variant", ["untied", "tied_scaled", "learned_pos",
                                     "softcap"])
def test_embedding_matches_reference(variant):
    base = dict(name="t", family="dense", num_layers=1, d_model=32,
                num_heads=2, num_kv_heads=2, head_dim=16, d_ff=0,
                vocab_size=64)
    extra = {"untied": {}, "tied_scaled": dict(tie_embeddings=True,
                                               embed_scale=True),
             "learned_pos": dict(learned_pos=True),
             "softcap": dict(logit_softcap=5.0)}[variant]
    rcfg = RefModelConfig(**base, **extra)
    tcfg = ModelConfig(**base, **extra)
    p = ref_embedding.init(jax.random.PRNGKey(0), rcfg, max_positions=40)
    tp = {k: _t(v) for k, v in p.items()}
    toks = np.random.default_rng(0).integers(0, 64, (2, 6)).astype(np.int32)
    pos = np.arange(3, 9)
    for dtype in ("float32", "bfloat16"):
        x_r = ref_embedding.embed(rcfg, p, jnp.asarray(toks),
                                  positions=jnp.asarray(pos),
                                  dtype=getattr(jnp, dtype))
        x_t = embedding.embed(tcfg, tp, _t(toks), positions=_t(pos),
                              dtype=getattr(torch, dtype))
        assert x_t.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(x_t), _np(x_r), **F32)
        l_r = ref_embedding.logits(rcfg, p, x_r)
        l_t = embedding.logits(tcfg, tp, x_t)
        assert str(l_t.dtype).split(".")[1] == str(l_r.dtype)
        if dtype == "float32":
            np.testing.assert_allclose(_np(l_t), _np(l_r), **F32)
        else:
            assert _rel(_np(l_t), _np(l_r)) < 2e-2
    shapes = {k: tuple(v.shape) for k, v in embedding.init(
        torch.Generator().manual_seed(0), tcfg, max_positions=40).items()}
    assert shapes == {k: v.shape for k, v in p.items()}


@pytest.mark.parametrize("causal,window,prefix",
                         [(True, 0, 0), (True, 32, 0), (True, 0, 24),
                          (False, 0, 0), (True, 48, 0)])
@pytest.mark.parametrize("qb,kb", [(32, 32), (16, 64), (128, 128)])
def test_blockwise_attention_matches_reference(causal, window, prefix, qb,
                                               kb):
    """The grid of the reference's `tests/test_layers.py:43`."""
    rng = np.random.default_rng(0)
    b, t, kvh, g, hd = 2, 128, 2, 3, 16
    q = rng.normal(size=(b, t, kvh, g, hd)).astype(np.float32)
    k = rng.normal(size=(b, t, kvh, hd)).astype(np.float32)
    v = rng.normal(size=(b, t, kvh, hd)).astype(np.float32)
    kw = dict(causal=causal, window=window, prefix_len=prefix, q_block=qb,
              kv_block=kb)
    want = ref_attention.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = attention.blockwise_attention(_t(q), _t(k), _t(v), **kw)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("q_offset,tq", [(32, 32), (48, 16)])
def test_blockwise_attention_q_offset_matches_reference(q_offset, tq):
    """Prefill continuation: queries start at ``q_offset``."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(1, tq, 1, 2, 8)).astype(np.float32)
    k = rng.normal(size=(1, 64, 1, 8)).astype(np.float32)
    v = rng.normal(size=(1, 64, 1, 8)).astype(np.float32)
    kw = dict(causal=True, q_block=16, kv_block=16, q_offset=q_offset)
    want = ref_attention.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = attention.blockwise_attention(_t(q), _t(k), _t(v), **kw)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=2e-6)


def test_blockwise_attention_refuses_a_prefix_longer_than_a_block():
    x = torch.zeros(1, 32, 1, 1, 8)
    with pytest.raises(ValueError, match="prefix_len"):
        attention.blockwise_attention(x, x[:, :, :, 0], x[:, :, :, 0],
                                      causal=True, prefix_len=20,
                                      kv_block=16)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "gemma-2b"])
def test_attention_prefill_and_ring_decode_match_reference(arch):
    """fwd_full with return_kv, fill_cache and fwd_decode (mixtral: the
    sliding-window ring buffer of 16 slots, crossed by 12 decode steps
    after 10 prefill tokens), float32 activations and cache."""
    rcfg, tcfg = ref_get_smoke(arch), get_smoke_config(arch)
    p = ref_attention.init(jax.random.PRNGKey(1), rcfg)
    tp = {k: _t(v) for k, v in p.items()}
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 10, rcfg.d_model)).astype(np.float32)
    h_r, (k_r, v_r) = ref_attention.fwd_full(rcfg, p, jnp.asarray(x),
                                             q_block=4, kv_block=4,
                                             return_kv=True)
    h_t, (k_t, v_t) = attention.fwd_full(tcfg, tp, _t(x), q_block=4,
                                         kv_block=4, return_kv=True)
    for got, want in ((h_t, h_r), (k_t, k_r), (v_t, v_r)):
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    c_r = ref_attention.fill_cache(rcfg, k_r, v_r, 30, jnp.float32)
    c_t = attention.fill_cache(tcfg, k_t, v_t, 30, torch.float32)
    assert c_t.k.shape == c_r.k.shape and c_t.pos == int(c_r.pos) == 10
    assert attention.cache_len(tcfg, 30) == ref_attention.cache_len(rcfg, 30)
    for step in range(12):
        xs = rng.normal(size=(2, 1, rcfg.d_model)).astype(np.float32)
        o_r, c_r = ref_attention.fwd_decode(rcfg, p, jnp.asarray(xs), c_r)
        o_t, c_t = attention.fwd_decode(tcfg, tp, _t(xs), c_t)
        np.testing.assert_allclose(_np(o_t), _np(o_r), **F32)
        np.testing.assert_allclose(_np(c_t.k), _np(c_r.k), **F32)
        assert c_t.pos == int(c_r.pos) == 11 + step


def test_attention_decode_donate_and_cross_kv():
    cfg = get_smoke_config("olmo-1b")
    rcfg = ref_get_smoke("olmo-1b")
    p = ref_attention.init(jax.random.PRNGKey(2), rcfg)
    tp = {k: _t(v) for k, v in p.items()}
    rng = np.random.default_rng(8)
    x = _t(rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32))
    cache = attention.init_cache(cfg, 2, 8, torch.float32)
    before = cache.k.clone()
    out_a, new = attention.fwd_decode(cfg, tp, x, cache)
    assert torch.equal(cache.k, before) and new.k is not cache.k
    out_b, new_d = attention.fwd_decode(cfg, tp, x, cache, donate=True)
    assert new_d.k is cache.k and torch.equal(out_a, out_b)
    assert torch.equal(new_d.k, new.k)
    # cross-attention (the encoder's k / v): no cache update
    enc_k = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    enc_v = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    o_r, c_r = ref_attention.fwd_decode(
        rcfg, p, jnp.asarray(x.numpy()),
        ref_attention.init_cache(rcfg, 2, 8, jnp.float32),
        cross_kv=(jnp.asarray(enc_k), jnp.asarray(enc_v)))
    o_t, c_t = attention.fwd_decode(cfg, tp, x, cache,
                                    cross_kv=(_t(enc_k), _t(enc_v)))
    np.testing.assert_allclose(_np(o_t), _np(o_r), **F32)
    assert c_t is cache


# -- MoE ----------------------------------------------------------------------

def _moe_cfgs(router, cf, experts=8, top_k=2):
    kw = dict(name="t", family="moe", num_layers=1, d_model=32, num_heads=2,
              num_kv_heads=2, head_dim=16, d_ff=0, vocab_size=64)
    mk = dict(num_experts=experts, top_k=top_k, d_ff_expert=24,
              capacity_factor=cf, router=router, num_shared=1)
    rcfg = RefModelConfig(**kw, moe=RefMoEConfig(**mk))
    return rcfg, ModelConfig(**kw, moe=MoEConfig(**mk))


@pytest.mark.parametrize("router", ["topk", "sinkhorn"])
@pytest.mark.parametrize("seed", [0, 1])
def test_moe_gates_match_reference(router, seed):
    rcfg, tcfg = _moe_cfgs(router, 1.25)
    logits = np.random.default_rng(seed).normal(size=(48, 8)).astype(
        np.float32) * 2
    ids_r, w_r, aux_r = ref_moe._gates(rcfg.moe, jnp.asarray(logits))
    ids_t, w_t, aux_t = moe._gates(tcfg.moe, _t(logits))
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_r))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_r), **F32)
    np.testing.assert_allclose(float(aux_t), float(aux_r), **F32)


@pytest.mark.parametrize("router", ["topk", "sinkhorn"])
@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_matches_reference(router, cf, dtype):
    """Capacity factor 0.5 drops tokens in every group, 8.0 none."""
    rcfg, tcfg = _moe_cfgs(router, cf)
    p = ref_moe.init(jax.random.PRNGKey(4), rcfg)
    tp = _tree_t(p)
    x = np.random.default_rng(3).normal(size=(3, 16, 32)).astype(np.float32)
    out_r, aux_r = ref_moe.apply(rcfg, p, jnp.asarray(x).astype(dtype))
    out_t, aux_t = moe.apply(tcfg, tp, _t(x).to(getattr(torch, dtype)))
    assert out_t.dtype == getattr(torch, dtype) and aux_t.dtype == \
        torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(_np(out_t), _np(out_r), **F32)
        np.testing.assert_allclose(float(aux_t), float(aux_r), **F32)
    else:
        assert _rel(_np(out_t), _np(out_r)) < 5e-2
    if cf == 0.5:                  # the port drops tokens here, as JAX
        xt = _t(x)
        ids, w, _ = moe._gates(tcfg.moe, xt.reshape(48, 32) @ tp["router"])
        cap = max(int(16 * 2 * cf / 8 + 1), 2)
        _, meta = moe._dispatch_group(tcfg.moe, xt, ids.reshape(3, 16, 2),
                                      w.reshape(3, 16, 2), cap)
        assert not bool(meta[0].all())


def test_moe_combine_is_run_to_run_bitwise():
    rcfg, tcfg = _moe_cfgs("topk", 1.0)
    p = _tree_t(ref_moe.init(jax.random.PRNGKey(5), rcfg))
    x = _t(np.random.default_rng(4).normal(size=(2, 32, 32)).astype(
        np.float32)).to(torch.bfloat16)
    a, _ = moe.apply(tcfg, p, x)
    b, _ = moe.apply(tcfg, p, x)
    assert torch.equal(a, b)


def test_moe_sinkhorn_router_balances_load():
    """The reference's coefficient-of-variation check
    (`tests/test_layers.py:121-142`) through the port's `_gates`."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(1, 256, 32)) * 0.2
         + rng.normal(size=(1, 1, 32))).astype(np.float32)

    def loads(router):
        rcfg, tcfg = _moe_cfgs(router, 2.0)
        p = ref_moe.init(jax.random.PRNGKey(1), rcfg)
        logits = _t(x.reshape(-1, 32)) @ _t(np.asarray(p["router"]))
        ids, _, _ = moe._gates(tcfg.moe, logits)
        counts = np.bincount(ids.numpy().ravel(), minlength=8)
        return counts / counts.sum()

    cv = lambda q: q.std() / q.mean()   # noqa: E731
    assert cv(loads("sinkhorn")) < 0.5 * cv(loads("topk"))


# -- the model: init tree, prefill, decode -----------------------------------

@pytest.mark.parametrize("arch", SERVED)
def test_init_tree_has_the_reference_structure(arch):
    rcfg, tcfg = _cfgs(arch)
    ref = _flat(ref_build_model(rcfg).init(jax.random.PRNGKey(0)))
    mine = _flat(build_model(tcfg, device="cpu").init(0))
    assert mine == ref


def _serve_both(arch, dtype, router=None, b=2, s=24, steps=4):
    rm, params, tm, tp = _models(arch, dtype=dtype, router=router)
    cfg = tm.cfg
    rng = np.random.default_rng(11)
    batch = _batch(cfg, rng, b, s)
    max_len = s + steps + (cfg.encoder.num_positions if cfg.family == "vlm"
                           else 0)
    logits_r, cache_r = rm.prefill(params, _jnp(batch), max_len=max_len)
    logits_t, cache_t = tm.prefill(tp, batch, max_len=max_len)
    out = [(_np(logits_t), _np(logits_r))]
    nxt = rng.integers(0, cfg.vocab_size, (b, steps)).astype(np.int32)
    for i in range(steps):
        logits_r, cache_r = rm.decode(params, cache_r,
                                      jnp.asarray(nxt[:, i:i + 1]))
        logits_t, cache_t = tm.decode(tp, cache_t, nxt[:, i:i + 1])
        out.append((_np(logits_t), _np(logits_r)))
    assert cache_t["pos"] == int(cache_r["pos"])
    return cfg, out


@pytest.mark.parametrize("arch,router", [(a, None) for a in SERVED[1:]]
                         + [("deepseek-moe-16b", "topk"),
                            ("deepseek-moe-16b", "sinkhorn")])
def test_prefill_and_decode_match_reference_bf16(arch, router):
    cfg, out = _serve_both(arch, "bfloat16", router)
    bound = 5e-2 if cfg.moe is not None or cfg.family == "ssm" else 2e-2
    for got, want in out:
        assert got.shape == want.shape
        assert _rel(got, want) <= bound
        _greedy_agrees(got, want, steps=1)


@pytest.mark.parametrize("arch,router", [(a, None) for a in SERVED[1:]]
                         + [("deepseek-moe-16b", "topk"),
                            ("deepseek-moe-16b", "sinkhorn")])
def test_prefill_matches_reference_f32(arch, router):
    """Prefill logits at float32 compute through the model API; its decode
    steps (bfloat16 cache) at the bfloat16 bounds."""
    cfg, out = _serve_both(arch, "float32", router)
    np.testing.assert_allclose(*out[0], **F32)
    bound = 5e-2 if cfg.moe is not None else 2e-2
    for got, want in out[1:]:
        assert _rel(got, want) <= bound
        _greedy_agrees(got, want, steps=1)


@pytest.mark.parametrize("arch,router", [(a, None) for a in SERVED[1:]]
                         + [("deepseek-moe-16b", "topk"),
                            ("deepseek-moe-16b", "sinkhorn")])
def test_lm_prefill_and_decode_steps_match_reference_f32(arch, router):
    """`lm.prefill` and 4 `lm.decode_step`s at float32 compute with a
    float32 cache (mixtral: 20 tokens against a ring of 16 slots)."""
    rm, params, tm, tp = _models(arch, dtype="float32", router=router)
    cfg, rcfg = tm.cfg, rm.cfg
    rng = np.random.default_rng(12)
    b, s, steps = 2, 16, 4
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    prefix = cfg.encoder.num_positions if cfg.family == "vlm" else 0
    kw = dict(max_len=s + steps, prefix_len=prefix, q_block=8, kv_block=8)
    h_r, c_r = ref_lm.prefill(rcfg, params, jnp.asarray(x),
                              cache_dtype=jnp.float32, **kw)
    h_t, c_t = lm.prefill(cfg, tp, _t(x), cache_dtype=torch.float32, **kw)
    np.testing.assert_allclose(_np(h_t), _np(h_r), **F32)
    for _ in range(steps):
        xs = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
        h_r, c_r = ref_lm.decode_step(rcfg, params, c_r, jnp.asarray(xs))
        h_t, c_t = lm.decode_step(cfg, tp, c_t, _t(xs))
        np.testing.assert_allclose(_np(h_t), _np(h_r), **F32)
    got, want = _leaves(c_t), _leaves(c_r)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), **F32)


@pytest.mark.parametrize("arch", SERVED + ("whisper-small",))
def test_decode_matches_prefill(arch):
    """The reference's own test (`tests/test_archs_smoke.py:74-113`) on the
    port: decoding tokens one by one gives the prefill's logits on the
    extended sequence (argmax equal; relative error under 5e-2 MoE, 2e-2
    dense). MoE capacity is raised so drops do not dominate."""
    _, tcfg = _cfgs(arch, cf=8.0)
    model = build_model(tcfg, q_block=8, kv_block=8, remat=False,
                        device="cpu")
    params = model.init(0)
    rng = np.random.default_rng(2)
    b, s1, s2, maxlen = 2, 16, 24, 32
    toks = rng.integers(0, tcfg.vocab_size, (b, s2)).astype(np.int32)
    batch = {"tokens": toks[:, :s1]}
    if tcfg.family in ("vlm", "audio"):
        p = tcfg.encoder.num_positions
        batch["patches" if tcfg.family == "vlm" else "frames"] = rng.normal(
            size=(b, p, tcfg.d_model)).astype(np.float32)
    _, cache = model.prefill(params, batch, max_len=maxlen)
    for t in range(s1, s2):
        logits_d, cache = model.decode(params, cache, toks[:, t:t + 1])
    logits_ref, _ = model.prefill(params, dict(batch, tokens=toks),
                                  max_len=maxlen)
    a, r = _np(logits_d), _np(logits_ref)
    assert np.array_equal(a.argmax(-1), r.argmax(-1))
    assert _rel(a, r) < (5e-2 if tcfg.moe is not None else 2e-2)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "minicpm3-4b",
                                  "recurrentgemma-9b", "xlstm-125m",
                                  "whisper-small"])
def test_decode_leaves_the_cache_unless_donated(arch):
    """Every tensor of the cache (KV, latent, recurrent state, the
    stacked units, prefix and tail) is bitwise as it was after a decode
    that was not donated; a donated one writes into its buffers."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg, q_block=8, kv_block=8, device="cpu")
    params = model.init(3)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (2, 9)).astype(np.int32)
    batch = _batch(cfg, rng, 2, 8)
    batch["tokens"] = toks[:, :8]
    _, cache = model.prefill(params, batch, max_len=12)
    snap = lm._tree_map(torch.clone, cache)
    l1, c1 = model.decode(params, cache, toks[:, 8:])
    for got, want in zip(_leaves(cache), _leaves(snap), strict=True):
        assert torch.equal(got, want)
    assert cache["pos"] == 8
    l2, c2 = model.decode(params, cache, toks[:, 8:], donate=True)
    assert torch.equal(l1, l2)
    for got, was, ref in zip(_leaves(c2), _leaves(cache), _leaves(c1),
                             strict=True):
        assert got is was and torch.equal(got, ref)
    assert c1["pos"] == c2["pos"] == 9


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-moe-16b"])
def test_loss_matches_reference(arch):
    rm, params, tm, tp = _models(arch, dtype="float32")
    rng = np.random.default_rng(6)
    batch = _batch(tm.cfg, rng, 2, 16)
    batch["labels"] = rng.integers(-1, tm.cfg.vocab_size, (2, 16)).astype(
        np.int32)
    l_r, m_r = rm.loss(params, _jnp(batch))
    l_t, m_t = tm.loss(tp, batch)
    np.testing.assert_allclose(float(l_t), float(l_r), **F32)
    np.testing.assert_allclose(float(m_t["aux"]), float(m_r["aux"]), **F32)
    logits = rng.normal(size=(2, 5, 9)).astype(np.float32)
    labels = np.array([[1, -1, 3, 0, 8], [2, 2, -1, -1, 5]], np.int32)
    from repro.models.registry import cross_entropy as ref_ce
    np.testing.assert_allclose(
        float(cross_entropy(_t(logits), _t(labels))),
        float(ref_ce(jnp.asarray(logits), jnp.asarray(labels))), **F32)


# -- serve steps, the launcher ----------------------------------------------

def test_serve_fns_run_the_model_and_donate():
    model = build_model(get_smoke_config("olmo-1b"), q_block=16,
                        kv_block=16, device="cpu")
    params = model.init(0)
    toks = np.random.default_rng(1).integers(0, 256, (2, 12)).astype(
        np.int32)
    for mesh in (None, one_device_mesh("cpu")):
        prefill_for, decode_for = build_serve_fns(model, mesh, max_len=16)
        logits, cache = prefill_for(2)(params, {"tokens": toks})
        want, _ = model.prefill(params, {"tokens": toks}, max_len=16)
        assert torch.equal(logits, want)
        tok = logits[:, -1].argmax(-1)[:, None]
        kept = decode_for(2, donate_cache=False)
        l1, c1 = kept(params, cache, tok)
        l2, c2 = decode_for(2)(params, cache, tok)
        assert torch.equal(l1, l2) and c2["units"][0].k is \
            cache["units"][0].k and c1["units"][0].k is not \
            cache["units"][0].k
        with pytest.raises(ValueError, match="batch 3"):
            prefill_for(3)(params, {"tokens": toks})


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "paligemma-3b",
                                  "minicpm3-4b", "recurrentgemma-9b",
                                  "xlstm-125m", "whisper-small"])
def test_launcher_lm_path_on_cpu(arch, capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch",
                "2", "--prefill-len", "16", "--decode-steps", "3"])
    out = capsys.readouterr().out
    assert "[serve] prefill 16 tokens:" in out
    assert "[serve] 3 decode steps:" in out


# -- tokens -------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["olmo-1b", "paligemma-3b",
                                  "whisper-small"])
@pytest.mark.parametrize("step", [0, 7])
def test_token_batches_are_the_reference_bitwise(arch, step):
    mine = TokenPipeline(get_smoke_config(arch), batch=3, seq_len=24,
                         seed=5).batch_at(step)
    ref = RefTokenPipeline(ref_get_smoke(arch), batch=3, seq_len=24,
                           seed=5).batch_at(step)
    assert mine.keys() == ref.keys()
    for k in ref:
        assert mine[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(mine[k], ref[k])


@pytest.mark.parametrize("arch", ["olmo-1b", "paligemma-3b",
                                  "whisper-small"])
def test_batch_struct_has_the_reference_shapes(arch):
    mine = batch_struct(get_config(arch), get_shape("train_4k"))
    ref = ref_batch_struct(ref_get_config(arch),
                           ref_registry.get_shape("train_4k"))
    assert mine.keys() == ref.keys()
    for k in ref:
        assert mine[k].device.type == "meta"
        assert tuple(mine[k].shape) == ref[k].shape
        assert str(mine[k].dtype).split(".")[1] == str(ref[k].dtype)


@pytest.mark.parametrize("arch,kinds", [
    ("minicpm3-4b", ("MLACache",)),
    ("recurrentgemma-9b", ("RGLRUState", "KVCache")),
    ("xlstm-125m", ("MLSTMState", "SLSTMState")),
    ("whisper-small", ("KVCache",))])
def test_remaining_mixers_build_and_serve_on_cpu(arch, kinds):
    """Each of the four architectures builds at smoke size and serves a
    prefill and decode steps; its cache holds the mixers' own entries."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg, q_block=8, kv_block=8, device="cpu")
    params = model.init(0)
    rng = np.random.default_rng(1)
    logits, cache = model.prefill(params, _batch(cfg, rng, 2, 8), max_len=12)
    for _ in range(3):
        tok = logits[:, -1].argmax(-1)[:, None]
        logits, cache = model.decode(params, cache, tok)
    assert tuple(logits.shape) == (2, 1, cfg.vocab_size)
    assert torch.isfinite(logits.float()).all() and cache["pos"] == 11
    entries = cache.values() if cfg.family == "audio" else \
        cache["prefix"] + cache["units"] + cache["tail"]
    assert {type(e).__name__ for e in entries if hasattr(e, "_fields")} == \
        set(kinds)
    empty = model.init_cache(2, 12)
    assert [(x.shape, x.dtype) for x in _leaves(empty)] == \
        [(x.shape, x.dtype) for x in _leaves(cache)] and empty["pos"] == 0


# -- what the port refuses ---------------------------------------------------


def test_a_mesh_beyond_one_device_is_refused():
    """A mesh beyond one device is refused by no config any more (the
    mixers took one with ROADMAP Queue 1 item 5e): an attention decoder
    and a mixer serve on it (`tests/test_torch_lm_mesh.py` and
    `tests/test_torch_mixers_mesh.py` hold the numbers), and the sharding
    context takes any mesh."""
    model = build_model(get_smoke_config("olmo-1b"), device="cpu")
    mesh = make_mesh((2, 1), ("data", "model"),
                     devices=[torch.device("cpu")] * 2)
    prefill_for, _ = build_serve_fns(model, mesh, max_len=8)
    params = model.init(0)
    toks = np.zeros((2, 4), np.int32)
    with activation_sharding(mesh):
        logits, cache = prefill_for(2)(params, {"tokens": toks})
    assert tuple(logits.shape) == (2, 1, 256) and cache["pos"] == 4
    mixer = build_model(get_smoke_config("minicpm3-4b"), device="cpu")
    prefill_for, _ = build_serve_fns(mixer, mesh, max_len=8)
    with activation_sharding(mesh):
        logits, cache = prefill_for(2)(mixer.init(0), {"tokens": toks})
    assert tuple(logits.shape) == (2, 1, 256) and cache["pos"] == 4
    with activation_sharding(one_device_mesh("cpu"), "decode"):
        pass
    with activation_sharding(None):
        pass


def test_params_from_numpy_refuse_what_is_not_a_tree():
    with pytest.raises(ValueError, match="embedding"):
        lm_params_from_numpy({"units": []}, device="cpu")
    with pytest.raises(ValueError, match="float"):
        lm_params_from_numpy({"embedding": {"embed": np.zeros(3, np.int32)}},
                             device="cpu")
