"""The port's generic Sinkhorn OT (`repro_torch.core.ot`) against live JAX
(`repro.core.ot`) on the CPU: the same cost matrices and marginals, made
from fixed seeds with numpy, through both packages.

Both branches: the fixed-count loop (``tol == 0``) and the early exit
(``tol > 0``), whose iteration count must be the reference's exactly.
The seeds are a fixed ``parametrize`` list, never random draws, so every
run checks the same problems.
"""
import numpy as np
import pytest
import torch

import repro_torch  # noqa: F401  (precision pins)
from repro.core import ot as ref_ot
from repro_torch.core import ot

TOL = dict(rtol=1e-5, atol=1e-7)


def _problem(seed, n, m, skew=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3))
    y = rng.normal(size=(m, 3))
    if skew:
        y[: m // 2] += 2.0
    cost = np.linalg.norm(x[:, None] - y[None], axis=-1).astype(np.float32)
    a = rng.random(n).astype(np.float32) + 0.1
    b = rng.random(m).astype(np.float32) + 0.1
    return cost, (a / a.sum()).astype(np.float32), \
        (b / b.sum()).astype(np.float32)


def _both(cost, a, b, **kw):
    want = ref_ot.sinkhorn_plan(cost, a, b, **kw)
    got = ot.sinkhorn_plan(torch.from_numpy(cost), torch.from_numpy(a),
                           torch.from_numpy(b), **kw)
    return got, want


def _close(got, want):
    np.testing.assert_allclose(got.plan.numpy(), np.asarray(want.plan),
                               **TOL)
    np.testing.assert_allclose(float(got.cost), float(want.cost), **TOL)
    np.testing.assert_allclose(float(got.marginal_err),
                               float(want.marginal_err), rtol=1e-5,
                               atol=1e-7)
    assert int(got.n_iter) == int(want.n_iter)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("shape", [(7, 5), (12, 12), (30, 9)])
@pytest.mark.parametrize("lamb", [1.0, 8.0])
def test_fixed_count_plan_matches_reference(seed, shape, lamb):
    cost, a, b = _problem(seed, *shape)
    got, want = _both(cost, a, b, lamb=lamb, max_iter=20)
    _close(got, want)
    assert int(got.n_iter) == 20
    assert got.plan.shape == shape and got.plan.dtype == torch.float32


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("tol", [1e-2, 1e-3, 1e-4])
def test_early_exit_counts_iterations_as_the_reference(seed, tol):
    """At lamb 1 these problems' scalings u stay below 1.1, which float32
    resolves to 1.2e-7: each tolerance here is far above the rounding of
    the stop test's deltas. (At lamb 4 u reaches 266, whose float32 step
    is 3e-5; a tolerance near that compares rounding noise, and the two
    packages' counts part, as the WMD solver's do, ROADMAP Queue 3.)"""
    cost, a, b = _problem(seed, 16, 11, skew=True)
    got, want = _both(cost, a, b, lamb=1.0, max_iter=200, tol=tol)
    _close(got, want)
    assert 1 < int(got.n_iter) < 200


def test_early_exit_stops_at_the_cap():
    """A tolerance the loop never reaches: both run max_iter iterations."""
    cost, a, b = _problem(7, 10, 10, skew=True)
    got, want = _both(cost, a, b, lamb=8.0, max_iter=5, tol=1e-12)
    _close(got, want)
    assert int(got.n_iter) == int(want.n_iter) == 5


def test_early_exit_at_the_first_test():
    """A loose tolerance stops after the first step, counted as 1."""
    cost, a, b = _problem(8, 6, 6)
    got, want = _both(cost, a, b, lamb=1.0, max_iter=50, tol=10.0)
    _close(got, want)
    assert int(got.n_iter) == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_divergence_matches_reference(seed):
    cost, a, b = _problem(seed, 9, 13)
    want = float(ref_ot.sinkhorn_divergence(cost, a, b, 2.0, 30))
    got = ot.sinkhorn_divergence(torch.from_numpy(cost), torch.from_numpy(a),
                                 torch.from_numpy(b), 2.0, 30)
    assert got.shape == ()
    np.testing.assert_allclose(float(got), want, **TOL)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_divergence_is_symmetric_on_fixed_inputs(seed):
    """The property of the reference's hypothesis test, on fixed seeds:
    d(C, a, b) == d(C^T, b, a)."""
    cost, a, b = _problem(seed, 8, 8)
    c = torch.from_numpy(cost)
    d1 = ot.sinkhorn_divergence(c, torch.from_numpy(a), torch.from_numpy(b),
                                1.0, 200)
    d2 = ot.sinkhorn_divergence(c.T.contiguous(), torch.from_numpy(b),
                                torch.from_numpy(a), 1.0, 200)
    np.testing.assert_allclose(float(d1), float(d2), rtol=1e-3)


def test_router_shaped_plan_balances_columns():
    """The MoE router's problem: uniform token mass onto uniform experts;
    with enough iterations the plan's columns carry 1/E each."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(64, 8)).astype(np.float32)
    cost = -torch.log_softmax(torch.from_numpy(logits), dim=-1)
    a = torch.full((64,), 1 / 64)
    b = torch.full((8,), 1 / 8)
    res = ot.sinkhorn_plan(cost, a, b, lamb=8.0, max_iter=200)
    np.testing.assert_allclose(res.plan.sum(dim=0).numpy(), 1 / 8,
                               rtol=1e-4)
    want = ref_ot.sinkhorn_plan(cost.numpy(), a.numpy(), b.numpy(),
                                lamb=8.0, max_iter=200)
    np.testing.assert_allclose(res.plan.numpy(), np.asarray(want.plan),
                               **TOL)
