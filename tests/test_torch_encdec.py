"""The port's encoder-decoder (`repro_torch.models.encdec`, whisper-small)
against live JAX, on the CPU.

The reference's parameters (its own ``init``) reach the port through
`repro_torch.convert.lm_params_from_numpy`; frames and tokens come from
fixed numpy seeds. Tolerances:
* float32: rtol 1e-4, atol 1e-5 -- the encoder at float32 compute, and
  the decode step (float32 activations) from one cache;
* bfloat16: relative error (max |port - ref| / max |ref|) under 2e-2, and
  the greedy token within one bfloat16 step of the reference's largest
  logit. The decoder's prefill and teacher-forced pass run in bfloat16
  whatever the compute dtype: the reference embeds their tokens at
  `embedding.embed`'s default dtype.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch  # noqa: F401  (precision pins)
from repro.configs import get_smoke_config as ref_get_smoke
from repro.models import build_model as ref_build_model
from repro.models import encdec as ref_encdec
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import build_model, encdec
from repro_torch.models.layers.attention import KVCache

F32 = dict(rtol=1e-4, atol=1e-5)
ARCH = "whisper-small"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(a, r):
    return float(np.abs(a - r).max() / max(np.abs(r).max(), 1e-6))


def _greedy_agrees(a, r):
    """The port's greedy token is the reference's, or one whose reference
    logit is within one bfloat16 step of the reference's maximum."""
    picked = np.take_along_axis(r, a.argmax(-1)[..., None], -1)[..., 0]
    top = r.max(-1)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(top))) - 7)
    assert np.all(picked >= top - ulp)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return [e for k in sorted(tree) for e in _flat(tree[k], f"{path}/{k}")]
    return [(path, tuple(tree.shape), str(tree.dtype).replace("torch.", ""))]


def _models(dtype=None):
    """(ref cfg, ref params, port cfg, port params) from one init."""
    rcfg, tcfg = ref_get_smoke(ARCH), get_smoke_config(ARCH)
    if dtype is not None:
        rcfg = dataclasses.replace(rcfg, compute_dtype=dtype)
        tcfg = dataclasses.replace(tcfg, compute_dtype=dtype)
    params = ref_build_model(rcfg).init(jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, params),
                              device="cpu")
    return rcfg, params, tcfg, tp


def _inputs(cfg, seed, b=2, s=12):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(b, cfg.encoder.num_positions,
                              cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return rng, frames, tokens


def _port_cache(cache_r):
    """The reference's decode cache as the port's: int positions."""
    def t(a):
        return torch.from_numpy(np.array(a))
    s = cache_r["self"]
    return {"self": KVCache(k=t(s.k), v=t(s.v), pos=int(s.pos[0])),
            "cross_k": t(cache_r["cross_k"]), "cross_v": t(cache_r["cross_v"]),
            "pos": int(cache_r["pos"])}


def test_init_tree_has_the_reference_structure():
    rcfg, tcfg = ref_get_smoke(ARCH), get_smoke_config(ARCH)
    ref = _flat(ref_build_model(rcfg).init(jax.random.PRNGKey(0)))
    mine = _flat(build_model(tcfg, device="cpu").init(0))
    assert mine == ref
    assert ("/embedding/pos", (32768, rcfg.d_model), "float32") in mine


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("blocks", [(512, 512), (4, 8)])
def test_encode_matches_reference(dtype, blocks):
    rcfg, params, tcfg, tp = _models(dtype)
    _, frames, _ = _inputs(tcfg, 0)
    kw = dict(q_block=blocks[0], kv_block=blocks[1])
    want = ref_encdec.encode(rcfg, params, jnp.asarray(frames), **kw)
    got = encdec.encode(tcfg, tp, torch.from_numpy(frames), **kw)
    assert str(got.dtype).split(".")[1] == str(want.dtype)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    else:
        assert _rel(_np(got), _np(want)) < 2e-2


def test_decode_full_matches_reference():
    """The teacher-forced decoder on the reference's encoder output (a
    bfloat16 pass, as the reference's)."""
    rcfg, params, tcfg, tp = _models("float32")
    _, frames, tokens = _inputs(tcfg, 1)
    enc_r = ref_encdec.encode(rcfg, params, jnp.asarray(frames))
    want = ref_encdec.decode_full(rcfg, params, jnp.asarray(tokens), enc_r,
                                  q_block=4, kv_block=4)
    got = encdec.decode_full(tcfg, tp, torch.from_numpy(tokens),
                             torch.from_numpy(np.asarray(enc_r)), q_block=4,
                             kv_block=4)
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    assert _rel(_np(got), _np(want)) < 2e-2


def test_prefill_and_decode_step_match_reference():
    """`prefill` (bfloat16 decoder, a float32 cache): hidden states and the
    cache -- self K/V, the cross K/V of all 16 frames -- at the bfloat16
    bound; then 4 `decode_step`s at float32 from the reference's cache,
    held at the float32 tolerance."""
    rcfg, params, tcfg, tp = _models("float32")
    rng, frames, tokens = _inputs(tcfg, 2)
    kw = dict(max_len=16, q_block=4, kv_block=4)
    h_r, c_r = ref_encdec.prefill(rcfg, params, jnp.asarray(frames),
                                  jnp.asarray(tokens),
                                  cache_dtype=jnp.float32, **kw)
    h_t, c_t = encdec.prefill(tcfg, tp, torch.from_numpy(frames),
                              torch.from_numpy(tokens),
                              cache_dtype=torch.float32, **kw)
    assert _rel(_np(h_t), _np(h_r)) < 2e-2
    assert c_t.keys() == c_r.keys() and c_t["pos"] == int(c_r["pos"]) == 12
    assert c_t["self"].pos == 12
    for got, want in ((c_t["self"].k, c_r["self"].k),
                      (c_t["self"].v, c_r["self"].v),
                      (c_t["cross_k"], c_r["cross_k"]),
                      (c_t["cross_v"], c_r["cross_v"])):
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        assert _rel(_np(got), _np(want)) < 2e-2
    assert tuple(c_t["cross_k"].shape) == (2, 2, 16, 4, 16)  # (L,B,F,kv,hd)
    c_t = _port_cache(c_r)
    for _ in range(4):
        xs = rng.normal(size=(2, 1, tcfg.d_model)).astype(np.float32)
        h_r, c_r = ref_encdec.decode_step(rcfg, params, c_r, jnp.asarray(xs))
        h_t, c_t = encdec.decode_step(tcfg, tp, c_t, torch.from_numpy(xs))
        np.testing.assert_allclose(_np(h_t), _np(h_r), **F32)
        np.testing.assert_allclose(_np(c_t["self"].k), _np(c_r["self"].k),
                                   **F32)
        assert c_t["pos"] == int(c_r["pos"]) == c_t["self"].pos


def test_decode_step_leaves_the_cache_unless_donated():
    _, _, tcfg, tp = _models("float32")
    _, frames, tokens = _inputs(tcfg, 3)
    _, cache = encdec.prefill(tcfg, tp, torch.from_numpy(frames),
                              torch.from_numpy(tokens), max_len=16)
    snap = {k: v.clone() for k, v in (("k", cache["self"].k),
                                      ("v", cache["self"].v))}
    x = torch.randn(2, 1, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    h1, c1 = encdec.decode_step(tcfg, tp, cache, x)
    assert torch.equal(cache["self"].k, snap["k"]) and cache["pos"] == 12
    assert c1["self"].k is not cache["self"].k
    assert c1["cross_k"] is cache["cross_k"]      # read only, shared
    h2, c2 = encdec.decode_step(tcfg, tp, cache, x, donate=True)
    assert torch.equal(h1, h2) and c2["self"].k is cache["self"].k
    assert torch.equal(c2["self"].k, c1["self"].k)
    assert c1["pos"] == c2["pos"] == c2["self"].pos == 13


def test_prefill_encodes_with_the_default_blocks(monkeypatch):
    """A reference-side fact kept: `prefill` calls `encode` with its
    default blocks of 512, whatever the caller's ``q_block``."""
    _, _, tcfg, tp = _models()
    _, frames, tokens = _inputs(tcfg, 4)
    seen, encode = [], encdec.encode

    def spy(*a, **kw):
        seen.append(kw)
        return encode(*a, **kw)

    monkeypatch.setattr(encdec, "encode", spy)
    encdec.prefill(tcfg, tp, torch.from_numpy(frames),
                   torch.from_numpy(tokens), max_len=16, q_block=4,
                   kv_block=4)
    assert seen == [{}]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_model_prefill_and_decode_match_reference(dtype):
    """Through the model API: prefill logits, then 4 decode steps (a
    bfloat16 cache) at the bfloat16 bounds."""
    rcfg, params, tcfg, tp = _models(dtype)
    rm = ref_build_model(rcfg, q_block=4, kv_block=4)
    tm = build_model(tcfg, q_block=4, kv_block=4, device="cpu")
    rng, frames, tokens = _inputs(tcfg, 5)
    batch = {"frames": frames, "tokens": tokens}
    l_r, c_r = rm.prefill(params, {k: jnp.asarray(v) for k, v in
                                   batch.items()}, max_len=16)
    l_t, c_t = tm.prefill(tp, batch, max_len=16)
    out = [(_np(l_t), _np(l_r))]
    nxt = rng.integers(0, tcfg.vocab_size, (2, 4)).astype(np.int32)
    for i in range(4):
        l_r, c_r = rm.decode(params, c_r, jnp.asarray(nxt[:, i:i + 1]))
        l_t, c_t = tm.decode(tp, c_t, nxt[:, i:i + 1])
        out.append((_np(l_t), _np(l_r)))
    for got, want in out:
        assert got.shape == want.shape
        assert _rel(got, want) < 2e-2
        _greedy_agrees(got, want)
    assert c_t["pos"] == int(c_r["pos"]) == 16


def test_model_loss_matches_reference():
    """The model API's loss (float32 encoder, bfloat16 decoder, float32
    cross entropy): within the bfloat16 bound of the reference's."""
    rcfg, params, tcfg, tp = _models("float32")
    rng, frames, tokens = _inputs(tcfg, 6)
    labels = rng.integers(-1, tcfg.vocab_size, tokens.shape).astype(np.int32)
    batch = {"frames": frames, "tokens": tokens, "labels": labels}
    l_r, m_r = ref_build_model(rcfg, q_block=4, kv_block=4).loss(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    l_t, m_t = build_model(tcfg, q_block=4, kv_block=4, device="cpu").loss(
        tp, batch)
    assert abs(float(l_t) - float(l_r)) < 2e-2 * abs(float(l_r))
    assert float(m_t["aux"]) == float(m_r["aux"]) == 0.0
    assert float(m_t["ce"]) == float(l_t)
