"""The port's optimizer substrate (`repro_torch.optim`) against live JAX, on
the CPU.

The same numpy-seeded trees go through `repro.optim` and
`repro_torch.optim`. Tolerances: AdamW's parameters and moments after 5
steps at float32 rtol 1e-6 / atol 1e-7 (the same op sequence; XLA and
PyTorch may differ by an ulp in ``b ** step``, ``sqrt`` and ``cos``);
the schedules at rtol 1e-6; the int8 codes and block scales of the
gradient compressor bitwise (``torch.round`` and ``jnp.round`` both round
half to even), its residual at atol 1e-7.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch  # noqa: F401  (precision pins)
from repro.optim import adamw as ref_adamw
from repro.optim import compress_grads as ref_compress_grads
from repro.optim import constant as ref_constant
from repro.optim import global_norm as ref_global_norm
from repro.optim import init_compression_state as ref_init_compression
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro.optim.compression import _quantize_leaf as ref_quantize
from repro_torch import _tree
from repro_torch.optim import (AdamWState, adamw, compress_grads, constant,
                               global_norm, init_compression_state,
                               warmup_cosine)
from repro_torch.optim.compression import BLOCK, _dequantize_leaf, \
    _quantize_leaf

F32 = dict(rtol=1e-6, atol=1e-7)
SHAPES = {"a": (3, 4), "units": [{"w": (2, 5, 3)}, {"b": (7,)}],
          "z": (300,)}


def _np_tree(rng, scale=1.0):
    """A tree of dicts and a list (the parameter trees' containers), its
    float32 leaves drawn from ``rng``."""
    def draw(shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    return {"a": draw(SHAPES["a"]),
            "units": [{"w": draw(SHAPES["units"][0]["w"])},
                      {"b": draw(SHAPES["units"][1]["b"])}],
            "z": draw(SHAPES["z"])}


def _to_t(tree):
    return _tree.tree_map(lambda a: torch.tensor(a), tree)


def _to_j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(t_tree, j_tree, **tol):
    tl, jl = _tree.leaves(t_tree), jax.tree.leaves(j_tree)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


@pytest.mark.parametrize("clip_norm", [1e3, 0.5], ids=["no_clip", "clip"])
@pytest.mark.parametrize("donate", [False, True])
def test_adamw_matches_reference_over_five_steps(clip_norm, donate):
    rng = np.random.default_rng(0)
    params = _np_tree(rng)
    ref = ref_adamw(ref_warmup_cosine(0.05, warmup_steps=2, total_steps=5),
                    clip_norm=clip_norm)
    mine = adamw(warmup_cosine(0.05, warmup_steps=2, total_steps=5),
                 clip_norm=clip_norm)
    rp, tp = _to_j(params), _to_t(params)
    rs, ts = ref.init(rp), mine.init(tp)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    clipped = []
    for _ in range(5):
        g = _np_tree(rng, scale=3.0)
        clipped.append(float(ref_global_norm(_to_j(g))) > clip_norm)
        rp, rs = ref.update(_to_j(g), rs, rp)
        tp, ts = mine.update(_to_t(g), ts, tp, donate=donate)
        _close(tp, rp, **F32)
        _close(ts.mu, rs.mu, **F32)
        _close(ts.nu, rs.nu, **F32)
        assert int(ts.step) == int(rs.step)
    assert all(clipped) == (clip_norm < 1)


def test_adamw_donate_writes_in_place_and_keeps_bits():
    rng = np.random.default_rng(1)
    params, g = _np_tree(rng), _np_tree(rng, scale=2.0)
    opt = adamw(constant(1e-2))
    kept_p = _to_t(params)
    kept_s = opt.init(kept_p)
    before = [x.clone() for x in _tree.leaves(kept_p)]
    new_k, st_k = opt.update(_to_t(g), kept_s, kept_p)
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 _tree.leaves(kept_p)))
    don_p = _to_t(params)
    don_s = opt.init(don_p)
    new_d, st_d = opt.update(_to_t(g), don_s, don_p, donate=True)
    for a, b in zip(_tree.leaves(new_d), _tree.leaves(don_p)):
        assert a is b                          # the given buffers
    for x, y in zip(_tree.leaves((new_k, st_k)), _tree.leaves((new_d, st_d))):
        assert torch.equal(x, y)


def test_global_norm_sums_in_the_reference_order():
    rng = np.random.default_rng(2)
    tree = _np_tree(rng, scale=10.0)
    got = global_norm(_to_t(tree))
    want = ref_global_norm(_to_j(tree))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    order = [np.asarray(x).shape for x in jax.tree.leaves(_to_j(tree))]
    assert [tuple(x.shape) for x in _tree.leaves(_to_t(tree))] == order


@pytest.mark.parametrize("warmup,total", [(0, 10), (3, 10), (10, 10),
                                          (2, 1)])
def test_schedules_match_reference(warmup, total):
    ref = ref_warmup_cosine(3e-4, warmup_steps=warmup, total_steps=total)
    mine = warmup_cosine(3e-4, warmup_steps=warmup, total_steps=total)
    for step in range(total + 3):
        got = mine(torch.tensor(step, dtype=torch.int32))
        want = ref(jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=0)
    c = constant(1e-3)(torch.tensor(4, dtype=torch.int32))
    assert c.dtype == torch.float32 and float(c) == float(
        ref_constant(1e-3)(jnp.asarray(4)))


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000, 4096])
def test_quantize_codes_and_scales_are_the_references_bitwise(n):
    rng = np.random.default_rng(n)
    g = (rng.normal(size=(n,)) * rng.choice([1e-3, 1.0, 50.0], size=n)
         ).astype(np.float32)
    g[: n // 7] = 0.0                     # whole zero blocks where n allows
    q, s = _quantize_leaf(torch.tensor(g))
    rq, rs = ref_quantize(jnp.asarray(g))
    assert q.dtype == torch.int8 and q.shape == (-(-n // BLOCK), BLOCK)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    deq = _dequantize_leaf(q, s, (n,), n)
    assert deq.shape == (n,)


def test_quantize_rounds_half_to_even():
    # a block whose scale is exactly 1: the codes are round(g)
    g = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5] + [0.0] * 250)
    q, s = _quantize_leaf(g)
    assert float(s[0, 0]) == 1.0
    assert q[0, :6].tolist() == [127, 0, 2, 2, 0, -2]


def test_compress_grads_matches_reference_over_steps():
    rng = np.random.default_rng(3)
    tree = _np_tree(rng, scale=1e-2)
    ts = init_compression_state(_to_t(tree))
    rs = ref_init_compression(_to_j(tree))
    for _ in range(4):
        g = _np_tree(rng, scale=1e-2)
        tg, ts = compress_grads(_to_t(g), ts)
        rg, rs = ref_compress_grads(_to_j(g), rs)
        for a, b in zip(_tree.leaves(tg), jax.tree.leaves(rg)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        _close(ts.residual, rs.residual, rtol=0, atol=1e-7)


# -- the reference's own substrate properties (tests/test_substrate.py) ------

def test_adamw_minimizes_quadratic():
    opt = adamw(constant(0.1), weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0, 5.0])}
    state = opt.init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}          # d/dw w^2
        params, state = opt.update(grads, state, params)
    assert float(params["w"].abs().max()) < 1e-2
    assert isinstance(state, AdamWState) and int(state.step) == 200


def test_warmup_cosine_shape():
    lr = warmup_cosine(1e-3, warmup_steps=10, total_steps=100)
    assert float(lr(torch.tensor(0))) == 0.0
    assert float(lr(torch.tensor(10))) == pytest.approx(1e-3, rel=1e-3)
    assert float(lr(torch.tensor(100))) == pytest.approx(1e-4, rel=1e-2)
    assert float(lr(torch.tensor(55))) < 1e-3


def test_grad_compression_error_feedback():
    """int8 round-trip with error feedback: the *accumulated* compressed
    signal converges to the true signal (residual stays bounded)."""
    rng = np.random.default_rng(0)
    g_true = {"w": torch.tensor(rng.normal(size=(1000,)) * 1e-3,
                                dtype=torch.float32)}
    state = init_compression_state(g_true)
    acc_comp = np.zeros(1000)
    for _ in range(20):
        g_comp, state = compress_grads(g_true, state)
        acc_comp += g_comp["w"].numpy()
    acc_true = 20 * g_true["w"].numpy()
    err = np.abs(acc_comp - acc_true).max()
    one_step_q = float(g_true["w"].abs().max()) / 127
    assert err < 3 * one_step_q
