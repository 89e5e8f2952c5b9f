"""The per-query final distance (#2) on vocab-major copies and the two
routes of the doc-side min-SDDMM (#8), on the CPU: their plain versions
against each other, bitwise, and against live JAX.

#2 `ops.sddmm_spmm_type2_vm` reads one query's vocab-major copies of K and
K.*M (made once a query by `core.sparse_sinkhorn.query_contractions`); its
plain version gathers ``k_vm[cols]``, the very tensor the reference
layout's gather builds, so it is bitwise the reference-layout plain route,
and both are held to the reference's Pallas kernel
(`repro.kernels.sddmm_spmm.sddmm_spmm_type2`, interpret mode) at the
engine tolerance.

#8 `kernels.rwmd.rwmd_bound_batch` picks its route from the shapes alone
(`rwmd_route`): "dense" (the column mins of all of M, then #9's walk) for
large document sets, "gather" for small ones. The dense route's plain
spelling (`torch.amin`, then the LC sparse dot) is bitwise the gather
spelling and both are held to the reference's Pallas kernel
(`repro.kernels.rwmd.rwmd_bound_batch`, interpret mode). The card tests
(`tests/test_torch_cuda.py`) hold the kernels to these.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import rwmd as jrwmd
from repro.kernels import sddmm_spmm as jsk
from repro_torch.kernels import lcrwmd, ops
from repro_torch.kernels import rwmd as krwmd
from repro_torch.kernels import sddmm_spmm as sk

TOL = dict(rtol=2e-3, atol=1e-5)      # the reference's engine tolerance
TOL_BOUND = dict(rtol=1e-5, atol=1e-6)


def _query(seed, v_r, v, n, nnz, pad_rows=2):
    """One query's stripes with pad query rows (zero K), a zero pad
    column, ELL pad slots (col V, val 0) and an all-pad document (the
    last)."""
    rng = np.random.default_rng(seed)
    k = rng.random((v_r, v + 1)).astype(np.float32)
    k[:, v] = 0.0
    k[v_r - pad_rows:] = 0.0
    km = (k * rng.random(k.shape) * 3).astype(np.float32)
    u = (rng.random((v_r, n)) * 2 + 0.1).astype(np.float32)
    cols = np.full((n, nnz), v, np.int32)
    vals = np.zeros((n, nnz), np.float32)
    for j in range(n - 1):
        m = int(rng.integers(1, nnz + 1))
        cols[j, :m] = rng.choice(v, m, replace=False)
        vals[j, :m] = rng.random(m).astype(np.float32) + 0.05
    return k, km, u, cols, vals


@pytest.mark.parametrize("v_r,nnz", [(8, 8), (40, 13), (96, 1)])
def test_type2_on_copies_is_the_reference_layout_route_and_live_jax(v_r,
                                                                    nnz):
    arrs = _query(70 + v_r, v_r, 64, 16, nnz)
    k, km, u, cols, vals = (torch.from_numpy(a) for a in arrs)
    k_vm, km_vm = (ops.k_vocab_major(x[None])[0] for x in (k, km))
    got = ops.sddmm_spmm_type2_vm(k_vm, km_vm, u, cols, vals)
    plain = sk.sddmm_spmm_type2_plain(k, km, u, cols, vals)
    assert got.shape == (16,) and torch.equal(got, plain)
    assert torch.equal(
        sk.sddmm_spmm_type2_vm_plain(k_vm, km_vm, u, cols, vals), plain)
    # the reference-layout entry: the copies, then the vm entry
    assert torch.equal(ops.sddmm_spmm_type2(k, km, u, cols, vals), plain)
    want = np.asarray(jsk.sddmm_spmm_type2(
        *(jnp.asarray(a) for a in arrs), docs_blk=8, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert got[-1] == 0 and want[-1] == 0       # the all-pad document
    assert torch.all(got[:-1] > 0)


def test_bound_route_is_a_function_of_shapes(monkeypatch):
    vp1, nnz = 100_001, 144                    # paper_5k's M stripes, ELL
    assert krwmd.rwmd_route(5_000, nnz, vp1) == "dense"   # bounds tier
    assert krwmd.rwmd_route(256, nnz, vp1) == "gather"    # tier 2
    # the boundary: the ELL's slots against the columns of M
    edge = math.ceil(krwmd.DENSE_SLOTS_PER_COLUMN * vp1 / nnz)
    assert krwmd.rwmd_route(edge, nnz, vp1) == "dense"
    assert krwmd.rwmd_route(edge - 1, nnz, vp1) == "gather"
    assert krwmd.rwmd_route(edge, nnz, vp1 + nnz) == "gather"
    # the entry follows it, whatever the values of M and of the ELL
    seen = []
    monkeypatch.setattr(krwmd, "rwmd_bound_batch_route",
                        lambda m, c, v, route, **kw: seen.append(route))
    big = math.ceil(krwmd.DENSE_SLOTS_PER_COLUMN * 101 / 3)
    for n, fill in ((big - 1, 0.0), (1, np.inf), (big, 1.0), (big, np.nan)):
        m_pad = torch.full((2, 4, 101), fill)
        cols = torch.zeros((n, 3), dtype=torch.int32)
        krwmd.rwmd_bound_batch(m_pad, cols, cols.float(), docs_blk=5)
    assert seen == ["gather", "gather", "dense", "dense"]


def _bound_problem(seed, q, v_r, v, n, nnz, pad_rows=1):
    """M stripes of q queries with +inf pad query rows plus an all-+inf
    filler query (the last), a zero pad column, ELL pad slots and an empty
    document (the last)."""
    rng = np.random.default_rng(seed)
    m_pad = (rng.random((q + 1, v_r, v + 1)) * 4).astype(np.float32)
    m_pad[:, :, v] = 0.0
    m_pad[:, v_r - pad_rows:] = np.inf
    m_pad[q] = np.inf
    cols = np.full((n, nnz), v, np.int32)
    vals = np.zeros((n, nnz), np.float32)
    for j in range(n - 1):
        c = int(rng.integers(1, nnz + 1))
        cols[j, :c] = rng.choice(v, c, replace=False)
        vals[j, :c] = rng.random(c).astype(np.float32) + 0.05
    return m_pad, cols, vals


@pytest.mark.parametrize("seed,q,v_r,nnz", [(0, 3, 11, 16), (1, 7, 40, 9),
                                            (2, 1, 2, 5)])
def test_dense_route_spelling_is_the_gather_spelling_and_live_jax(seed, q,
                                                                  v_r, nnz):
    arrs = _bound_problem(seed, q, v_r, 96, 16, nnz)
    m_pad, cols, vals = (torch.from_numpy(a) for a in arrs)
    dense = krwmd.rwmd_bound_batch_dense_plain(m_pad, cols, vals)
    gather = krwmd.rwmd_bound_batch_plain(m_pad, cols, vals)
    assert torch.equal(dense, gather)
    lc = lcrwmd.lc_rwmd_bound_batch_plain(torch.amin(m_pad, dim=1), cols,
                                          vals)
    assert torch.equal(lc, gather)
    # raw bounds: the filler query is +inf on every live document, 0 on
    # the empty one; the ops entry finite-izes it to 0
    assert torch.isinf(dense[-1, :-1]).all() and dense[-1, -1] == 0
    assert torch.all(dense[:, -1] == 0)
    assert torch.equal(ops.rwmd_bound_batch(m_pad, cols, vals),
                       ops._finite(dense))
    want = np.asarray(jrwmd.rwmd_bound_batch(
        *(jnp.asarray(a) for a in arrs), docs_blk=8, q_blk=q + 1,
        interpret=True))
    np.testing.assert_allclose(dense.numpy(), want, **TOL_BOUND)


def test_new_cuda_wrappers_refuse_cpu_tensors_and_count_nothing():
    """The CUDA entry points launch or raise: a CPU tensor is refused and
    no launch is counted (nothing falls back to the plain version)."""
    from repro_torch.kernels import _build
    k, km, u, cols, vals = (torch.from_numpy(a)
                            for a in _query(5, 8, 64, 9, 8))
    m_pad, m_cols, m_vals = (torch.from_numpy(a)
                             for a in _bound_problem(5, 2, 4, 64, 9, 8))
    _build.reset_launches()
    calls = [
        lambda: sk.sddmm_spmm_type2_vm(k.T.contiguous(), km.T.contiguous(),
                                       u, cols, vals),
        lambda: sk.sddmm_spmm_type2_naive(k, km, u, cols, vals),
        lambda: krwmd.column_min(m_pad),
        lambda: krwmd.rwmd_bound_batch_route(m_pad, m_cols, m_vals,
                                             "dense"),
        lambda: krwmd.rwmd_bound_batch_route(m_pad, m_cols, m_vals,
                                             "gather"),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="route"):
        krwmd.rwmd_bound_batch_route(m_pad, m_cols, m_vals, "scan")
    assert sum(_build.launches.values()) == 0
