"""The port's kernel modules on the CPU: `repro_torch.kernels.ops` (which
runs each kernel's plain version for CPU tensors) against the JAX
package's `repro.kernels.ops` (Pallas, interpret mode) and against the
port's own naive oracle `repro_torch.kernels.ref`, on shapes that are not
tile multiples, with pad query rows, ELL pad slots and Q-filler.

Tolerance ``rtol=1e-4, atol=1e-6``: the same fp32 math, sums over v_r and
nnz taken in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build, kexp, ops, ref, sddmm_spmm
from repro_torch.kernels._pad import pad_axis

TOL = dict(rtol=1e-4, atol=1e-6)


def _problem(seed, q=3, v_r=11, v=320, n=45, nnz=16, pad_rows=3, filler=1):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(v, 24)).astype(np.float32)
    sel = rng.choice(v, (q, v_r))
    m = np.sqrt(((vecs[sel][:, :, None, :] - vecs[None, None]) ** 2)
                .sum(-1)).astype(np.float32)                   # (Q, v_r, V)
    k = np.exp(-m).astype(np.float32)
    k[:, v_r - pad_rows:] = 0.0                                # pad rows
    k[q - filler:] = 0.0                                       # Q-filler
    km = (k * m).astype(np.float32)
    k_pad = np.pad(k, ((0, 0), (0, 0), (0, 1)))                # zero column
    km_pad = np.pad(km, ((0, 0), (0, 0), (0, 1)))
    r = (rng.random((q, v_r)) + 0.1).astype(np.float32)
    r[:, v_r - pad_rows:] = 1.0
    u = (rng.random((q, v_r, n)) * 3 + 0.2).astype(np.float32)
    cols = np.full((n, nnz), v, np.int32)                      # pad slots
    vals = np.zeros((n, nnz), np.float32)
    for j in range(n):
        c = int(rng.integers(1, nnz - 2))
        cols[j, :c] = rng.choice(v, c, replace=False)
        vals[j, :c] = rng.random(c).astype(np.float32) + 0.05
    return k_pad, km_pad, r, u, cols, vals


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("seed", [0, 1])
def test_type1_batch_three_way(seed):
    k_pad, km_pad, r, u, cols, vals = _problem(seed)
    got = ops.sddmm_spmm_type1_batch(*_t(k_pad, r, u, cols, vals)).numpy()
    want = np.asarray(jops.sddmm_spmm_type1_batch(
        *_j(k_pad, r, u, cols, vals)))
    oracle = ref.sddmm_spmm_type1_batch(*_t(k_pad, r, u, cols, vals)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)
    assert got.shape == (3, 11, 45) and got.dtype == np.float32
    # pad query rows and the Q-filler contribute exact zeros
    assert np.all(got[:, -3:] == 0) and np.all(got[-1] == 0)


@pytest.mark.parametrize("seed", [0, 1])
def test_type2_batch_three_way(seed):
    k_pad, km_pad, r, u, cols, vals = _problem(seed)
    got = ops.sddmm_spmm_type2_batch(*_t(k_pad, km_pad, u, cols,
                                         vals)).numpy()
    want = np.asarray(jops.sddmm_spmm_type2_batch(
        *_j(k_pad, km_pad, u, cols, vals)))
    oracle = ref.sddmm_spmm_type2_batch(*_t(k_pad, km_pad, u, cols,
                                            vals)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)
    assert got.shape == (3, 45) and np.all(got[-1] == 0)


@pytest.mark.parametrize("m,v,w", [(13, 320, 24), (1, 77, 5), (20, 129, 40)])
def test_cdist_kexp_rows_three_way(m, v, w):
    rng = np.random.default_rng(m)
    b = rng.normal(scale=1.3, size=(v, w)).astype(np.float32)
    a = b[rng.choice(v, m, replace=False)]
    a[0] += 0.5                                    # one off-vocab row
    k, km = ops.cdist_kexp_rows(*_t(a, b), lamb=1.0)
    jk, jkm = jops.cdist_kexp_rows(*_j(a, b), lamb=1.0)
    ok, okm = ref.cdist_kexp(*_t(a, b), lamb=1.0)
    # the expansion cancels near the diagonal (a row against its own
    # word): there K differs by round-off of M ~ sqrt(eps * |a|^2), so
    # those entries get an absolute bound instead
    near = ok.numpy() > np.exp(-1.0)
    for got, want in ((k, jk), (k, ok)):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_allclose(got[~near], want[~near], **TOL)
        assert np.all(np.abs(got - want)[near] <= 5e-2)
    for got, want in ((km, jkm), (km, okm)):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_allclose(got[~near], want[~near], **TOL)
        assert np.all(np.abs(got - want)[near] <= 5e-2)
    assert k.shape == (m, v) and k.dtype == torch.float32


def test_plain_versions_are_what_ops_runs_on_cpu():
    k_pad, km_pad, r, u, cols, vals = _t(*_problem(2))
    assert torch.equal(ops.sddmm_spmm_type1_batch(k_pad, r, u, cols, vals),
                       sddmm_spmm.sddmm_spmm_type1_batch_plain(
                           k_pad, r, u, cols, vals))
    assert torch.equal(
        ops.sddmm_spmm_type2_batch(k_pad, km_pad, u, cols, vals),
        sddmm_spmm.sddmm_spmm_type2_batch_plain(k_pad, km_pad, u, cols,
                                                vals))
    a, b = torch.ones(3, 4), torch.zeros(5, 4)
    for x, y in zip(ops.cdist_kexp_rows(a, b, lamb=2.0),
                    kexp.cdist_kexp_rows_plain(a, b, lamb=2.0)):
        assert torch.equal(x, y)


def test_cuda_wrappers_refuse_cpu_tensors_and_count_nothing():
    """The CUDA entry points launch or raise: a CPU tensor is refused, and
    no launch is counted (nothing falls back to the plain version)."""
    k_pad, km_pad, r, u, cols, vals = _t(*_problem(3))
    _build.reset_launches()
    with pytest.raises(ValueError):
        sddmm_spmm.sddmm_spmm_type1_batch(k_pad, r, u, cols, vals)
    with pytest.raises(ValueError):
        sddmm_spmm.sddmm_spmm_type2_batch(k_pad, km_pad, u, cols, vals)
    with pytest.raises(ValueError):
        kexp.cdist_kexp_rows(torch.ones(2, 3), torch.ones(4, 3), lamb=1.0)
    assert sum(_build.launches.values()) == 0


def test_build_flags_target_sm90a_without_fast_math():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").exists()


@pytest.mark.parametrize("axis,mult,value", [(0, 8, 0.0), (1, 5, 1.0),
                                             (-1, 4, float("inf"))])
def test_pad_axis_matches_reference(axis, mult, value):
    from repro.kernels._pad import pad_axis as jpad
    x = np.arange(3 * 7, dtype=np.float32).reshape(3, 7)
    got = pad_axis(torch.from_numpy(x), axis, mult, value=value).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpad(jnp.asarray(x), axis,
                                                       mult, value=value)))
