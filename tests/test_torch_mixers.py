"""The port's recurrent and latent-attention mixers against live JAX, on the
CPU: RG-LRU (`layers/rglru.py`), mLSTM / sLSTM (`layers/xlstm.py`) and
multi-head latent attention (`layers/mla.py`).

Inputs come from fixed numpy seeds; the reference's parameters (its own
``init``) reach the port as tensors, so both compute from the same
weights. Tolerances:
* float32: rtol 1e-4, atol 1e-5 (the same math, sums reassociated);
* the RG-LRU prefill scan: atol 1e-4, the reference's own scan-against-
  decode tolerance (`tests/test_layers.py:88-91`): the port's doubling
  scan combines in another order than `jax.lax.associative_scan`;
* the port's chunkwise mLSTM against its recurrent one: atol 5e-4 on h,
  1e-4 on C (`tests/test_layers.py:67-70`);
* MLA absorbed decode against naive: atol 2e-5 (`tests/test_layers.py:171`);
* bfloat16 compute: relative error (max |port - ref| / max |ref|) under
  2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch  # noqa: F401  (precision pins)
from repro.configs import get_smoke_config as ref_get_smoke
from repro.models.layers import mla as ref_mla
from repro.models.layers import rglru as ref_rglru
from repro.models.layers import xlstm as ref_xlstm
from repro_torch.configs import get_smoke_config
from repro_torch.models.layers import mla, rglru, xlstm

F32 = dict(rtol=1e-4, atol=1e-5)
SCAN = dict(rtol=0, atol=1e-4)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _tree_t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(a, r):
    return float(np.abs(a - r).max() / max(np.abs(r).max(), 1e-6))


def _shapes(tree):
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        else:
            out[path] = tuple(node.shape)

    walk(tree, "")
    return out


def _cfgs(arch, dtype=None):
    rcfg, tcfg = ref_get_smoke(arch), get_smoke_config(arch)
    if dtype is not None:
        rcfg = dataclasses.replace(rcfg, compute_dtype=dtype)
        tcfg = dataclasses.replace(tcfg, compute_dtype=dtype)
    return rcfg, tcfg


def _assert_state(got, want, tol=F32):
    """A port state (NamedTuple, int pos) equals a reference state."""
    assert got._fields == want._fields
    for name in got._fields:
        if name == "pos":
            assert got.pos == int(want.pos)
        else:
            g, w = getattr(got, name), getattr(want, name)
            assert tuple(g.shape) == w.shape, name
            np.testing.assert_allclose(_np(g), _np(w), **tol, err_msg=name)


# -- RG-LRU --------------------------------------------------------------------

def _rglru(seed=0):
    rcfg, tcfg = _cfgs("recurrentgemma-9b")
    p = ref_rglru.init(jax.random.PRNGKey(seed), rcfg)
    # non-zero biases so every term is exercised
    p = dict(p, conv_b=p["conv_b"] + 0.1, b_a=p["b_a"] - 0.2,
             b_x=p["b_x"] + 0.3)
    return rcfg, tcfg, p, _tree_t(p)


def test_rglru_init_has_the_reference_shapes():
    rcfg, tcfg, p, _ = _rglru()
    got = rglru.init(torch.Generator().manual_seed(0), tcfg)
    assert _shapes(got) == _shapes(p)
    assert list(got) == list(p)
    stacked = rglru.init(torch.Generator().manual_seed(0), tcfg, lead=(3,))
    assert all(v.shape[0] == 3 for v in stacked.values())


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("t", [1, 7, 12, 33])
def test_rglru_fwd_full_matches_reference(h0, t):
    """The scan's output and returned state (``h0=`` folds an initial
    state into the first step), float32."""
    rcfg, tcfg, p, tp = _rglru()
    rng = np.random.default_rng(t)
    x = rng.normal(size=(2, t, rcfg.d_model)).astype(np.float32)
    h_init = rng.normal(size=(2, rcfg.d_model)).astype(np.float32) \
        if h0 else None
    y_r, s_r = ref_rglru.fwd_full(
        rcfg, p, jnp.asarray(x),
        None if h_init is None else jnp.asarray(h_init), return_state=True)
    y_t, s_t = rglru.fwd_full(tcfg, tp, _t(x),
                              None if h_init is None else _t(h_init),
                              return_state=True)
    np.testing.assert_allclose(_np(y_t), _np(y_r), **SCAN)
    _assert_state(s_t, s_r, SCAN)
    assert torch.equal(rglru.fwd_full(tcfg, tp, _t(x), None if h_init is None
                                      else _t(h_init)), y_t)


def test_rglru_fwd_full_bf16_matches_reference():
    """Prefill's conv in the compute dtype (bfloat16), as the reference's."""
    rcfg, tcfg, p, tp = _rglru()
    x = np.random.default_rng(3).normal(size=(2, 16, rcfg.d_model)).astype(
        np.float32)
    y_r = ref_rglru.fwd_full(rcfg, p, jnp.asarray(x).astype(jnp.bfloat16))
    y_t = rglru.fwd_full(tcfg, tp, _t(x).to(torch.bfloat16))
    assert y_t.dtype == torch.bfloat16
    assert _rel(_np(y_t), _np(y_r)) < 2e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_decode_steps_match_reference(dtype):
    """fwd_decode from a fresh state and from a prefill's: outputs and
    states step by step (decode's conv in float32 at either dtype)."""
    rcfg, tcfg, p, tp = _rglru()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6, rcfg.d_model)).astype(np.float32)
    _, s_r = ref_rglru.fwd_full(rcfg, p, jnp.asarray(x), return_state=True)
    _, s_t = rglru.fwd_full(tcfg, tp, _t(x), return_state=True)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    starts = [(ref_rglru.init_state(rcfg, 2), rglru.init_state(tcfg, 2)),
              (s_r, s_t)]
    for st_r, st_t in starts:
        assert st_t.h.dtype == torch.float32
        for _ in range(5):
            xs = rng.normal(size=(2, 1, rcfg.d_model)).astype(np.float32)
            o_r, st_r = ref_rglru.fwd_decode(rcfg, p,
                                             jnp.asarray(xs).astype(jd), st_r)
            o_t, st_t = rglru.fwd_decode(tcfg, tp, _t(xs).to(td), st_t)
            assert o_t.dtype == td and tuple(o_t.shape) == o_r.shape
            if dtype == "float32":
                np.testing.assert_allclose(_np(o_t), _np(o_r), **F32)
                _assert_state(st_t, st_r)
            else:
                assert _rel(_np(o_t), _np(o_r)) < 2e-2
                assert st_t.pos == int(st_r.pos)


def test_rglru_scan_matches_decode():
    """The reference's own check (`tests/test_layers.py:73-91`) on the
    port: the doubling scan equals step-by-step decode."""
    _, tcfg, _, tp = _rglru()
    x = _t(np.random.default_rng(1).normal(size=(2, 12, tcfg.d_model))
           .astype(np.float32))
    y_full, s_full = rglru.fwd_full(tcfg, tp, x, return_state=True)
    state = rglru.init_state(tcfg, 2)
    ys = []
    for i in range(12):
        y, state = rglru.fwd_decode(tcfg, tp, x[:, i:i + 1], state)
        ys.append(y)
    np.testing.assert_allclose(_np(torch.cat(ys, 1)), _np(y_full), **SCAN)
    np.testing.assert_allclose(_np(state.h), _np(s_full.h), **SCAN)
    np.testing.assert_allclose(_np(state.conv), _np(s_full.conv), **F32)


@pytest.mark.parametrize("t", [1, 2])
def test_rglru_short_prompt_state_is_the_references(t):
    """A reference-side fact kept as it is: for T < W-1 the returned conv
    history is ``xin[:, T-(W-1):]``, fewer than W-1 rows."""
    rcfg, tcfg, p, tp = _rglru()
    x = np.random.default_rng(2).normal(size=(2, t, rcfg.d_model)).astype(
        np.float32)
    _, s_r = ref_rglru.fwd_full(rcfg, p, jnp.asarray(x), return_state=True)
    _, s_t = rglru.fwd_full(tcfg, tp, _t(x), return_state=True)
    assert tuple(s_t.conv.shape) == s_r.conv.shape == (2, 1, rcfg.d_model)
    _assert_state(s_t, s_r, SCAN)


# -- mLSTM cell ----------------------------------------------------------------

def _gates(seed, b=2, h=3, t=64, hd=16):
    """q, k, v, log_i, log_f as the reference's test draws them."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, t, hd)).astype(np.float32) * hd ** -0.5
    k = rng.normal(size=(b, h, t, hd)).astype(np.float32)
    v = rng.normal(size=(b, h, t, hd)).astype(np.float32)
    li = rng.normal(size=(b, h, t)).astype(np.float32)
    lf = np.log(1 / (1 + np.exp(-rng.normal(size=(b, h, t)) - 3))).astype(
        np.float32)
    return q, k, v, li, lf


def _cell_equal(got, want, tol=F32):
    h_g, (c_g, n_g, m_g) = got
    h_w, (c_w, n_w, m_w) = want
    for g, w in ((h_g, h_w), (c_g, c_w), (n_g, n_w), (m_g, m_w)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), **tol)


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_mlstm_chunkwise_matches_reference(chunk):
    ins = _gates(0)
    want = ref_xlstm.mlstm_chunkwise(*map(jnp.asarray, ins), chunk=chunk)
    got = xlstm.mlstm_chunkwise(*map(_t, ins), chunk=chunk)
    _cell_equal(got, want)


def test_mlstm_recurrent_matches_reference():
    ins = _gates(1, t=24)
    want = ref_xlstm.mlstm_recurrent(*map(jnp.asarray, ins))
    got = xlstm.mlstm_recurrent(*map(_t, ins))
    _cell_equal(got, want)


@pytest.mark.parametrize("split", [16, 32])
def test_mlstm_chunkwise_state_passing_matches_reference(split):
    """The sequence in two calls, the first's (C, n, m) passed to the
    second: both halves equal live JAX's, and the whole the one-call
    result."""
    ins = _gates(2)
    halves = [[x[:, :, :split] for x in ins], [x[:, :, split:] for x in ins]]
    h1_r, st_r = ref_xlstm.mlstm_chunkwise(*map(jnp.asarray, halves[0]),
                                           chunk=16)
    h2_r = ref_xlstm.mlstm_chunkwise(*map(jnp.asarray, halves[1]), chunk=16,
                                     state=st_r)
    h1_t, st_t = xlstm.mlstm_chunkwise(*map(_t, halves[0]), chunk=16)
    h2_t = xlstm.mlstm_chunkwise(*map(_t, halves[1]), chunk=16, state=st_t)
    _cell_equal((h1_t, st_t), (h1_r, st_r))
    _cell_equal(h2_t, h2_r)
    whole, _ = xlstm.mlstm_chunkwise(*map(_t, ins), chunk=16)
    np.testing.assert_allclose(_np(torch.cat([h1_t, h2_t[0]], 2)),
                               _np(whole), **F32)


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_mlstm_chunkwise_matches_recurrent(chunk):
    """The reference's own check (`tests/test_layers.py:53-70`) on the
    port."""
    ins = [_t(x) for x in _gates(3)]
    h_r, (c_r, _, m_r) = xlstm.mlstm_recurrent(*ins)
    h_c, (c_c, _, m_c) = xlstm.mlstm_chunkwise(*ins, chunk=chunk)
    np.testing.assert_allclose(_np(h_c), _np(h_r), rtol=0, atol=5e-4)
    np.testing.assert_allclose(_np(c_c), _np(c_r), rtol=0, atol=1e-4)
    np.testing.assert_allclose(_np(m_c), _np(m_r), rtol=0, atol=1e-5)


def test_mlstm_chunkwise_refuses_a_ragged_sequence():
    ins = [_t(x) for x in _gates(4, t=48)]
    with pytest.raises(ValueError, match="T=48 not divisible by chunk=32"):
        xlstm.mlstm_chunkwise(*ins, chunk=32)
    _, tcfg = _cfgs("xlstm-125m")
    p = xlstm.init_mlstm(torch.Generator().manual_seed(0), tcfg)
    with pytest.raises(ValueError, match="T=300 not divisible by chunk=256"):
        xlstm.mlstm_block(tcfg, p, torch.zeros(1, 300, tcfg.d_model))


def test_mlstm_empty_state_starts_at_minus_inf_without_nan():
    """A prefill from no state starts m at -inf: exp(-inf) = 0 keeps the
    empty (C, n) out of every chunk's carry, with no NaN."""
    ins = [_t(x) for x in _gates(5, t=32)]
    _, (c, n, m) = xlstm.mlstm_chunkwise(*ins, chunk=16)
    h1, (c1, n1, m1) = xlstm.mlstm_chunkwise(*[x[:, :, :16] for x in ins],
                                             chunk=16)
    for x in (c, n, m, h1, c1, n1, m1):
        assert torch.isfinite(x).all()
    fresh = xlstm.init_mlstm_state(get_smoke_config("xlstm-125m"), 1)
    assert (fresh.m == np.float32(-1e30)).all()


# -- xLSTM blocks ----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_init_has_the_reference_shapes(kind):
    rcfg, tcfg = _cfgs("xlstm-125m")
    ref = getattr(ref_xlstm, f"init_{kind}")(jax.random.PRNGKey(0), rcfg)
    got = getattr(xlstm, f"init_{kind}")(torch.Generator().manual_seed(0),
                                         tcfg)
    assert _shapes(got) == _shapes(ref) and list(got) == list(ref)
    np.testing.assert_array_equal(_np(got["b_if" if kind == "mlstm"
                                          else "b"]),
                                  _np(ref["b_if" if kind == "mlstm"
                                          else "b"]))


def _xlstm_params(kind, seed=0):
    rcfg, tcfg = _cfgs("xlstm-125m")
    p = getattr(ref_xlstm, f"init_{kind}")(jax.random.PRNGKey(seed), rcfg)
    p = dict(p, ln=dict(p["ln"], bias=p["ln"]["bias"] + 0.05))
    return rcfg, tcfg, p, _tree_t(p)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlstm_block_and_decode_match_reference(kind, dtype):
    """mlstm_block / slstm_block with return_state, then 4 decode steps
    from that state and 2 from a fresh one."""
    rcfg, tcfg, p, tp = _xlstm_params(kind)
    block, dec = f"{kind}_block", f"{kind}_block_decode"
    init_state = f"init_{kind}_state"
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 16, rcfg.d_model)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    kw = dict(chunk=8) if kind == "mlstm" else {}
    y_r, s_r = getattr(ref_xlstm, block)(rcfg, p, jnp.asarray(x).astype(jd),
                                         return_state=True, **kw)
    y_t, s_t = getattr(xlstm, block)(tcfg, tp, _t(x).to(td),
                                     return_state=True, **kw)
    assert y_t.dtype == td

    def same(a, r):
        if dtype == "float32":
            np.testing.assert_allclose(_np(a), _np(r), **F32)
        else:
            assert _rel(_np(a), _np(r)) < 2e-2

    same(y_t, y_r)
    if dtype == "float32":
        _assert_state(s_t, s_r)
    starts = [(s_r, s_t), (getattr(ref_xlstm, init_state)(rcfg, 2),
                           getattr(xlstm, init_state)(tcfg, 2))]
    for (st_r, st_t), n in zip(starts, (4, 2)):
        for _ in range(n):
            xs = rng.normal(size=(2, 1, rcfg.d_model)).astype(np.float32)
            o_r, st_r = getattr(ref_xlstm, dec)(
                rcfg, p, jnp.asarray(xs).astype(jd), st_r)
            o_t, st_t = getattr(xlstm, dec)(tcfg, tp, _t(xs).to(td), st_t)
            assert tuple(o_t.shape) == o_r.shape == (2, 1, rcfg.d_model)
            same(o_t, o_r)
            if dtype == "float32":
                _assert_state(st_t, st_r)
            assert st_t.pos == int(st_r.pos)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_block_bf16_error_is_the_references(kind):
    """One block at xlstm-125m's full width (d_model 768, 4 heads of 192),
    64 tokens: the port's bfloat16 output lies no further from the
    reference's float32 output than 1.25x the reference's own bfloat16
    output does. The mLSTM cell divides by max(|q . n|, exp(-m)), so its
    bfloat16 error is large in the reference itself (3.5e-2 of the
    largest output here); the port rounds no worse."""
    from repro.configs import get_config as ref_get_config
    from repro_torch.configs import get_config
    rcfg, tcfg = ref_get_config("xlstm-125m"), get_config("xlstm-125m")
    p = getattr(ref_xlstm, f"init_{kind}")(jax.random.PRNGKey(0), rcfg)
    tp = _tree_t(p)
    x = np.random.default_rng(0).normal(size=(4, 64, 768)).astype(np.float32)
    block = f"{kind}_block"
    r32 = _np(getattr(ref_xlstm, block)(rcfg, p, jnp.asarray(x)))
    r16 = _np(getattr(ref_xlstm, block)(rcfg, p,
                                        jnp.asarray(x).astype(jnp.bfloat16)))
    t32 = _np(getattr(xlstm, block)(tcfg, tp, _t(x)))
    t16 = _np(getattr(xlstm, block)(tcfg, tp, _t(x).to(torch.bfloat16)))
    np.testing.assert_allclose(t32, r32, **F32)
    assert _rel(t16, r32) <= 1.25 * _rel(r16, r32)


def test_mlstm_block_matches_its_decode_steps():
    """Prefill of T tokens == T decode steps from a fresh state (chunkwise
    against recurrent, the -inf and -1e30 starts): the block outputs."""
    _, tcfg, _, tp = _xlstm_params("mlstm")
    x = _t(np.random.default_rng(7).normal(size=(2, 16, tcfg.d_model))
           .astype(np.float32))
    y_full = xlstm.mlstm_block(tcfg, tp, x, chunk=8)
    st = xlstm.init_mlstm_state(tcfg, 2)
    ys = []
    for i in range(16):
        y, st = xlstm.mlstm_block_decode(tcfg, tp, x[:, i:i + 1], st)
        ys.append(y)
    np.testing.assert_allclose(_np(torch.cat(ys, 1)), _np(y_full), rtol=0,
                               atol=5e-4)


# -- MLA -------------------------------------------------------------------------

def _mla(seed=0, dtype=None):
    rcfg, tcfg = _cfgs("minicpm3-4b", dtype)
    p = ref_mla.init(jax.random.PRNGKey(seed), rcfg)
    return rcfg, tcfg, p, _tree_t(p)


def test_mla_init_has_the_reference_shapes():
    rcfg, tcfg, p, _ = _mla()
    got = mla.init(torch.Generator().manual_seed(0), tcfg)
    assert _shapes(got) == _shapes(p) and list(got) == list(p)


@pytest.mark.parametrize("qb,kb", [(4, 4), (8, 16), (16, 16)])
def test_mla_fwd_full_and_fill_cache_match_reference(qb, kb):
    rcfg, tcfg, p, tp = _mla()
    x = np.random.default_rng(8).normal(size=(2, 16, rcfg.d_model)).astype(
        np.float32)
    y_r, (c_r, k_r) = ref_mla.fwd_full(rcfg, p, jnp.asarray(x), q_block=qb,
                                       kv_block=kb, return_latent=True)
    y_t, (c_t, k_t) = mla.fwd_full(tcfg, tp, _t(x), q_block=qb, kv_block=kb,
                                   return_latent=True)
    for got, want in ((y_t, y_r), (c_t, c_r), (k_t, k_r)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    assert torch.equal(mla.fwd_full(tcfg, tp, _t(x), q_block=qb,
                                    kv_block=kb), y_t)
    for dt, tdt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        cache_r = ref_mla.fill_cache(rcfg, c_r, k_r, 24, dt)
        cache_t = mla.fill_cache(tcfg, c_t, k_t, 24, tdt)
        assert cache_t.c_kv.dtype == tdt and cache_t.pos == 16
        tol = F32 if tdt == torch.float32 else dict(rtol=1e-2, atol=1e-2)
        _assert_state(cache_t, cache_r, tol)


@pytest.mark.parametrize("absorbed", [False, True])
def test_mla_decode_steps_match_reference(absorbed):
    """6 decode steps after a 10-token prefill, float32 cache."""
    rcfg, tcfg, p, tp = _mla()
    name = "fwd_decode_absorbed" if absorbed else "fwd_decode"
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 10, rcfg.d_model)).astype(np.float32)
    _, (c_r, k_r) = ref_mla.fwd_full(rcfg, p, jnp.asarray(x), q_block=5,
                                     kv_block=5, return_latent=True)
    _, (c_t, k_t) = mla.fwd_full(tcfg, tp, _t(x), q_block=5, kv_block=5,
                                 return_latent=True)
    cache_r = ref_mla.fill_cache(rcfg, c_r, k_r, 16, jnp.float32)
    cache_t = mla.fill_cache(tcfg, c_t, k_t, 16, torch.float32)
    for _ in range(6):
        xs = rng.normal(size=(2, 1, rcfg.d_model)).astype(np.float32)
        o_r, cache_r = getattr(ref_mla, name)(rcfg, p, jnp.asarray(xs),
                                              cache_r)
        o_t, cache_t = getattr(mla, name)(tcfg, tp, _t(xs), cache_t)
        np.testing.assert_allclose(_np(o_t), _np(o_r), **F32)
        _assert_state(cache_t, cache_r)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_absorbed_decode_matches_naive(dtype):
    """The reference's own check (`tests/test_layers.py:145-171`) on the
    port, from a fresh cache and from a prefill's; and in bfloat16 (a
    bfloat16 cache) at the bfloat16 bound."""
    _, tcfg, _, tp = _mla()
    td = getattr(torch, dtype)
    rng = np.random.default_rng(10)
    x = _t(rng.normal(size=(2, 8, tcfg.d_model)).astype(np.float32)).to(td)
    _, (c, k) = mla.fwd_full(tcfg, tp, x, q_block=4, kv_block=4,
                             return_latent=True)
    for start in (mla.init_cache(tcfg, 2, 16, td),
                  mla.fill_cache(tcfg, c, k, 16, td)):
        c_n = c_a = start
        for _ in range(4):
            xs = _t(rng.normal(size=(2, 1, tcfg.d_model)).astype(
                np.float32)).to(td)
            o_n, c_n = mla.fwd_decode(tcfg, tp, xs, c_n)
            o_a, c_a = mla.fwd_decode_absorbed(tcfg, tp, xs, c_a)
            if dtype == "float32":
                np.testing.assert_allclose(_np(o_a), _np(o_n), rtol=0,
                                           atol=2e-5)
            else:
                assert _rel(_np(o_a), _np(o_n)) < 2e-2
            assert torch.equal(c_a.c_kv, c_n.c_kv) and c_a.pos == c_n.pos


@pytest.mark.parametrize("absorbed", [False, True])
def test_mla_decode_leaves_the_cache_unless_donated(absorbed):
    _, tcfg, _, tp = _mla()
    fn = mla.fwd_decode_absorbed if absorbed else mla.fwd_decode
    x = _t(np.random.default_rng(11).normal(size=(2, 1, tcfg.d_model))
           .astype(np.float32))
    cache = mla.init_cache(tcfg, 2, 8, torch.float32)
    snap = (cache.c_kv.clone(), cache.k_rope.clone())
    out_a, new = fn(tcfg, tp, x, cache)
    assert torch.equal(cache.c_kv, snap[0]) and torch.equal(cache.k_rope,
                                                            snap[1])
    assert new.c_kv is not cache.c_kv and new.pos == 1 and cache.pos == 0
    out_b, new_d = fn(tcfg, tp, x, cache, donate=True)
    assert new_d.c_kv is cache.c_kv and new_d.k_rope is cache.k_rope
    assert torch.equal(out_a, out_b) and torch.equal(new_d.c_kv, new.c_kv)
