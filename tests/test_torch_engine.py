"""The port's solver engine against the live JAX package, on the golden
corpus recipe (`tests/test_golden.py::_corpus`, seed 1234, rebuilt here
with numpy): cost matrix, precompute, the dense oracle, the batched sparse
engine for every impl with and without doc chunking, early exit, and the
single-device batch programs of `core.distributed`.

Engine against engine the tolerance is the reference's own
(``rtol=2e-3, atol=1e-5``, `tests/test_golden.py:234-241`). Inside the port
the bitwise contracts hold with ``torch.equal``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro.core import sinkhorn as jsk
from repro.core import sparse_sinkhorn as jss
from repro.core.cost_matrix import cdist_direct as j_cdist_direct
from repro.core.cost_matrix import cdist_matmul as j_cdist_matmul
from repro.launch.mesh import make_mesh
from repro_torch.core import cost_matrix as tcm
from repro_torch.core import distributed as tdist
from repro_torch.core import formats as tf
from repro_torch.core import sinkhorn as tsk
from repro_torch.core import sparse_sinkhorn as tss

LAMB, MAX_ITER, V_R_BUCKET = 1.0, 8, 12
TOL = dict(rtol=2e-3, atol=1e-5)


@functools.lru_cache(maxsize=1)
def _corpus():
    """The golden corpus, numpy only: (vecs, ell, rs)."""
    rng = np.random.default_rng(1234)
    v, w, n, q = 96, 8, 24, 3
    vecs = rng.normal(size=(v, w)).astype(np.float32)
    c = np.zeros((v, n), np.float32)
    for j in range(n):
        widx = rng.choice(v, rng.integers(3, 10), replace=False)
        c[widx, j] = rng.random(widx.size).astype(np.float32)
        c[:, j] /= c[:, j].sum()
    rs = []
    for i in range(q):
        r = np.zeros(v, np.float32)
        idx = rng.choice(v, 5 + 2 * i, replace=False)   # mixed v_r
        r[idx] = rng.random(idx.size).astype(np.float32) + 0.1
        r /= r.sum()
        rs.append(r)
    return vecs, tf.ell_from_dense(c), rs


@functools.lru_cache(maxsize=1)
def _batch():
    vecs, ell, rs = _corpus()
    sels, rsels = zip(*[tsk.select_query(r) for r in rs])
    return tdist.pad_query_batch(sels, rsels, V_R_BUCKET)


def _port_batch(impl, docs_chunk=None, tol=0.0):
    vecs, ell, _ = _corpus()
    sel_b, r_b, mask_b = _batch()
    return tss.sinkhorn_wmd_sparse_batch(
        torch.from_numpy(sel_b), torch.from_numpy(r_b),
        torch.from_numpy(ell.cols), torch.from_numpy(ell.vals),
        torch.from_numpy(vecs), LAMB, MAX_ITER,
        row_mask=torch.from_numpy(mask_b), impl=impl,
        docs_chunk=docs_chunk, tol=tol)


@functools.lru_cache(maxsize=None)
def _jax_batch(impl, docs_chunk=None, tol=0.0):
    vecs, ell, _ = _corpus()
    sel_b, r_b, mask_b = _batch()
    return np.asarray(jss.sinkhorn_wmd_sparse_batch(
        jnp.asarray(sel_b), jnp.asarray(r_b), jnp.asarray(ell.cols),
        jnp.asarray(ell.vals), jnp.asarray(vecs), LAMB, MAX_ITER,
        row_mask=jnp.asarray(mask_b), impl=impl, docs_chunk=docs_chunk,
        tol=tol))


@pytest.mark.parametrize("squared", [False, True])
def test_cost_matrix_matches(squared):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(7, 16)).astype(np.float32)
    b = rng.normal(size=(33, 16)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(
        tcm.cdist_direct(ta, tb, squared=squared).numpy(),
        np.asarray(j_cdist_direct(jnp.asarray(a), jnp.asarray(b),
                                  squared=squared)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tcm.cdist(ta, tb, squared=squared).numpy(),
        np.asarray(j_cdist_matmul(jnp.asarray(a), jnp.asarray(b),
                                  squared=squared)), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        tcm.cdist(ta, tb, method="nope")


def test_precompute_matches():
    vecs, _, rs = _corpus()
    sel, r_sel = tsk.select_query(rs[2])
    pre = tsk.precompute(torch.from_numpy(sel), torch.from_numpy(r_sel),
                         torch.from_numpy(vecs), LAMB)
    jpre = jsk.precompute(jnp.asarray(sel), jnp.asarray(r_sel),
                          jnp.asarray(vecs), LAMB)
    for got, want in zip(pre, jpre):
        # K near the diagonal carries the expansion's round-off (see
        # core.sinkhorn): absolute tolerance there
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=2e-3)


def test_dense_oracle_matches():
    vecs, ell, rs = _corpus()
    c = torch.from_numpy(ell.to_dense())
    for r in rs:
        sel, r_sel = tsk.select_query(r)
        got = tsk.sinkhorn_wmd_dense(torch.from_numpy(sel),
                                     torch.from_numpy(r_sel), c,
                                     torch.from_numpy(vecs), LAMB, MAX_ITER)
        want = jsk.sinkhorn_wmd_dense(jnp.asarray(sel), jnp.asarray(r_sel),
                                      jnp.asarray(ell.to_dense()),
                                      jnp.asarray(vecs), LAMB, MAX_ITER)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", ["fused", "unfused", "kernel"])
@pytest.mark.parametrize("docs_chunk", [None, 7])
def test_sparse_batch_matches_live_jax(impl, docs_chunk):
    got = _port_batch(impl, docs_chunk).numpy()
    want = _jax_batch(impl, docs_chunk)
    assert got.shape == want.shape == (3, 24) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("impl", ["fused", "unfused", "kernel"])
def test_sparse_batch_matches_dense_oracle(impl):
    vecs, ell, rs = _corpus()
    c = torch.from_numpy(ell.to_dense())
    dense = np.stack([tsk.sinkhorn_wmd_dense(
        *map(torch.from_numpy, tsk.select_query(r)), c,
        torch.from_numpy(vecs), LAMB, MAX_ITER).numpy() for r in rs])
    np.testing.assert_allclose(_port_batch(impl).numpy(), dense, **TOL)


@pytest.mark.parametrize("impl", ["fused", "unfused", "kernel"])
@pytest.mark.parametrize("docs_chunk", [5, 7, 24])
def test_chunked_equals_unchunked_bitwise(impl, docs_chunk):
    assert torch.equal(_port_batch(impl, docs_chunk), _port_batch(impl))


def test_tol_zero_loop_equals_fixed_loop_bitwise():
    vecs, ell, _ = _corpus()
    sel_b, r_b, mask_b = _batch()
    pre = tss.precompute_batch(torch.from_numpy(sel_b),
                               torch.from_numpy(r_b),
                               torch.from_numpy(vecs), LAMB,
                               torch.from_numpy(mask_b))
    k_pad = tss.pad_k(pre.K)
    cols, vals = torch.from_numpy(ell.cols), torch.from_numpy(ell.vals)
    type1 = tss._resolve_impl("type1", "kernel")

    def iteration(x):
        return type1(k_pad, pre.r, tss.safe_recip(x), cols, vals)

    x0 = torch.full((3, V_R_BUCKET, ell.num_docs), 1.0 / V_R_BUCKET)
    x_loop, delta, n_iter = tss.batched_sinkhorn_loop(
        iteration, x0, max_iter=MAX_ITER, tol=0.0)
    x_fixed = x0
    for _ in range(MAX_ITER):
        x_fixed = iteration(x_fixed)
    assert torch.equal(x_loop, x_fixed)
    assert torch.all(n_iter == MAX_ITER)
    # and the solver's own tol=0 route is the fixed loop
    assert torch.equal(_port_batch("kernel", tol=0.0), _port_batch("kernel"))


@pytest.mark.parametrize("impl", ["fused", "kernel"])
def test_early_exit_matches_live_jax(impl):
    got = _port_batch(impl, tol=1e-3).numpy()
    np.testing.assert_allclose(got, _jax_batch(impl, tol=1e-3), **TOL)


def test_stripes_solver_equals_embedding_solver_bitwise():
    vecs, ell, _ = _corpus()
    sel_b, r_b, mask_b = _batch()
    pre = tss.precompute_batch(torch.from_numpy(sel_b),
                               torch.from_numpy(r_b),
                               torch.from_numpy(vecs), LAMB,
                               torch.from_numpy(mask_b))
    got = tss.sinkhorn_wmd_sparse_batch_stripes(
        tss.pad_k(pre.K), tss.pad_k(pre.KM), pre.r,
        torch.from_numpy(ell.cols), torch.from_numpy(ell.vals), MAX_ITER)
    assert torch.equal(got, _port_batch("kernel"))


def _jax_mesh_fn(placement, docs_chunk, tol, impl="fused"):
    vecs, ell, _ = _corpus()
    sel_b, r_b, mask_b = _batch()
    rb = tf.rebucket_for_vocab_shards(ell, 1)
    mesh = make_mesh((1, 1), ("data", "model"))
    fn = jdist.build_wmd_batch_fn(mesh, lamb=LAMB, max_iter=MAX_ITER,
                                  impl=impl, docs_chunk=docs_chunk,
                                  chunk_placement=placement, tol=tol,
                                  with_info=True)
    vecs_d, cols_d, vals_d = jdist.shard_wmd_inputs(mesh, vecs, rb.cols,
                                                    rb.vals)
    out = fn(jnp.asarray(vecs[sel_b]), jnp.asarray(r_b),
             jnp.asarray(mask_b), vecs_d, cols_d, vals_d)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("placement,docs_chunk,tol", [
    ("solve", None, 0.0), ("solve", 7, 0.0), ("iteration", 7, 0.0),
    ("solve", 7, 1e-3)])
def test_batch_program_matches_live_jax(placement, docs_chunk, tol):
    vecs, ell, _ = _corpus()
    sel_b, r_b, mask_b = _batch()
    rb = tf.rebucket_for_vocab_shards(ell, 1)
    fn = tdist.build_wmd_batch_fn(lamb=LAMB, max_iter=MAX_ITER,
                                  docs_chunk=docs_chunk,
                                  chunk_placement=placement, tol=tol,
                                  with_info=True)
    vecs_t = torch.from_numpy(vecs)
    wmd, n_iter, delta = fn(vecs_t[torch.from_numpy(sel_b).long()],
                            torch.from_numpy(r_b), torch.from_numpy(mask_b),
                            vecs_t, torch.from_numpy(rb.cols),
                            torch.from_numpy(rb.vals))
    jwmd, jn, _ = _jax_mesh_fn(placement, docs_chunk, tol)
    np.testing.assert_allclose(wmd.numpy(), jwmd, **TOL)
    assert n_iter.dtype == torch.int32 and n_iter.shape == (3,)
    if not tol:
        np.testing.assert_array_equal(n_iter.numpy(), jn)
        assert torch.all(delta == 0)


def test_batch_program_rejects_bad_placement():
    with pytest.raises(ValueError):
        tdist.build_wmd_batch_fn(lamb=1.0, max_iter=2, chunk_placement="x")
    with pytest.raises(ValueError):
        tss._resolve_impl("type1", "pallas")
