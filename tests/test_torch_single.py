"""The port's per-query program on the CPU against the live JAX package.

Kernels #1 / #2 (`ops.sddmm_spmm_type1/2`) and #5 (`ops.cdist_kexp`) run
their plain versions on CPU tensors and are held to the reference's
Pallas kernels (interpret mode) and to the port's naive oracles
(`kernels.ref`) at ``rtol=1e-4, atol=1e-6`` (the same fp32 math, sums in
another order); the vocab-chunked driver likewise. The solvers (the
single-query `sinkhorn_wmd_sparse`, the early-exit solvers, the dense
history, `build_wmd_fn`) and the service's `query` / `top_k` run on the
golden corpus recipe (`tests/test_golden.py::_corpus`, rebuilt with numpy)
and are held to the reference's engine tolerance (``rtol=2e-3,
atol=1e-5``); top-k ids are equal.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.sinkhorn_wmd import WMDConfig as JConfig
from repro.core import convergence as jconv
from repro.core import distributed as jdist
from repro.core import sinkhorn as jsk
from repro.core import sparse_sinkhorn as jss
from repro.kernels import ops as jops
from repro.launch.mesh import make_mesh
from repro.serving import WMDService as JService
from repro_torch.configs.sinkhorn_wmd import WMDConfig
from repro_torch.core import convergence as tconv
from repro_torch.core import distributed as tdist
from repro_torch.core import formats as tf
from repro_torch.core import sinkhorn as tsk
from repro_torch.core import sparse_sinkhorn as tss
from repro_torch.kernels import _build, kexp, ops, ref, sddmm_spmm
from repro_torch.serving import WMDService

TOL_KERNEL = dict(rtol=1e-4, atol=1e-6)
TOL = dict(rtol=2e-3, atol=1e-5)
LAMB, MAX_ITER, V_R_BUCKET, TOP_K = 1.0, 8, 12, 5


def _t(*arrs):
    return [torch.from_numpy(np.asarray(a)) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


def _problem(seed, v_r, v, n, nnz, pad_rows=2):
    """One query's stripes (pad rows: zero K, r = 1; a zero pad column),
    an iterate u and an ELL with pad slots (col V, val 0)."""
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(v, 24)).astype(np.float32)
    sel = rng.choice(v, v_r, replace=False)
    m = np.sqrt(((vecs[sel][:, None, :] - vecs[None]) ** 2).sum(-1)) \
        .astype(np.float32)
    k = np.exp(-m).astype(np.float32)
    k[v_r - pad_rows:] = 0.0
    km = (k * m).astype(np.float32)
    k_pad = np.pad(k, ((0, 0), (0, 1)))
    km_pad = np.pad(km, ((0, 0), (0, 1)))
    r = (rng.random(v_r) + 0.1).astype(np.float32)
    r[v_r - pad_rows:] = 1.0
    u = (rng.random((v_r, n)) * 3 + 0.2).astype(np.float32)
    cols = np.full((n, nnz), v, np.int32)
    vals = np.zeros((n, nnz), np.float32)
    for j in range(n):
        c = int(rng.integers(1, nnz - 2))
        cols[j, :c] = rng.choice(v, c, replace=False)
        vals[j, :c] = rng.random(c).astype(np.float32) + 0.05
    return k_pad, km_pad, r, u, cols, vals


# -- kernels #1 / #2 / #5 and the chunked driver -----------------------------

@pytest.mark.parametrize("kind", ["type1", "type2"])
@pytest.mark.parametrize("v_r,v,n,nnz", [(11, 320, 45, 16), (5, 97, 13, 8)])
def test_single_query_kernels_three_way(kind, v_r, v, n, nnz):
    k_pad, km_pad, r, u, cols, vals = _problem(v_r, v_r, v, n, nnz)
    args = (k_pad, r, u, cols, vals) if kind == "type1" else \
        (k_pad, km_pad, u, cols, vals)
    got = getattr(ops, f"sddmm_spmm_{kind}")(*_t(*args)).numpy()
    want = np.asarray(getattr(jops, f"sddmm_spmm_{kind}")(*_j(*args)))
    oracle = getattr(ref, f"sddmm_spmm_{kind}")(*_t(*args)).numpy()
    np.testing.assert_allclose(got, want, **TOL_KERNEL)
    np.testing.assert_allclose(got, oracle, **TOL_KERNEL)
    assert got.shape == ((v_r, n) if kind == "type1" else (n,))
    assert got.dtype == np.float32
    if kind == "type1":
        assert np.all(got[-2:] == 0)       # pad query rows: exact zeros
    # the single-query plain version is the batched one at Q = 1
    batched = getattr(sddmm_spmm, f"sddmm_spmm_{kind}_batch_plain")(
        *[t[None] if i < 3 else t for i, t in enumerate(_t(*args))])[0]
    assert torch.equal(torch.from_numpy(got), batched)


@pytest.mark.parametrize("m,v,w", [(11, 320, 24), (32, 129, 40)])
def test_cdist_kexp_three_way(m, v, w):
    rng = np.random.default_rng(m)
    b = rng.normal(scale=1.3, size=(v, w)).astype(np.float32)
    a = b[rng.choice(v, m, replace=False)]
    a[0] += 0.5                                    # one off-vocab row
    k, km = ops.cdist_kexp(*_t(a, b), lamb=1.0)
    jk, jkm = jops.cdist_kexp(*_j(a, b), lamb=1.0, v_tile=128)
    ok, okm = ref.cdist_kexp(*_t(a, b), lamb=1.0)
    # a row against its own word: the expansion cancels to round-off of
    # M ~ sqrt(eps * |a|^2), so those entries get an absolute bound
    near = ok.numpy() > np.exp(-1.0)
    for got, want in ((k, jk), (k, ok), (km, jkm), (km, okm)):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_allclose(got[~near], want[~near], **TOL_KERNEL)
        assert np.all(np.abs(got - want)[near] <= 5e-2)
    assert k.shape == km.shape == (m, v) and k.dtype == torch.float32
    # one query's stripe is a block of rows: the row kexp's bits
    for x, y in zip((k, km), ops.cdist_kexp_rows(*_t(a, b), lamb=1.0)):
        assert torch.equal(x, y)


def test_chunked_driver_matches_reference_and_monolithic():
    """S = 4 vocab chunks (the reference's `tests/test_kernels.py:163`):
    within rtol 1e-4 of the monolithic type1 (the sum is reordered) and of
    the reference's chunked driver."""
    v, n, v_r, shards = 128, 24, 9, 4
    k_pad, _, r, u, _, _ = _problem(3, v_r, v, n, 8)
    rng = np.random.default_rng(4)
    c = np.zeros((v, n), np.float32)
    for j in range(n):
        c[rng.choice(v, rng.integers(3, 12), replace=False), j] = 1.0
    ell = tf.ell_from_dense(c / c.sum(0))
    rb = tf.rebucket_for_vocab_shards(ell, shards)
    vloc = v // shards
    k_chunks = np.stack([np.pad(k_pad[:, s * vloc:(s + 1) * vloc],
                                ((0, 0), (0, 1))) for s in range(shards)])
    got = ops.sddmm_spmm_chunked(*_t(k_chunks, r, u, rb.cols, rb.vals))
    want = np.asarray(jops.sddmm_spmm_chunked(*_j(k_chunks, r, u, rb.cols,
                                                  rb.vals)))
    full = ops.sddmm_spmm_type1(*_t(k_pad, r, u, ell.cols, ell.vals))
    np.testing.assert_allclose(got.numpy(), want, **TOL_KERNEL)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **TOL_KERNEL)
    assert got.shape == (v_r, n)


def test_single_query_cuda_wrappers_refuse_cpu_tensors():
    """The CUDA entry points launch or raise: a CPU tensor is refused and
    no launch is counted (nothing falls back to the plain version)."""
    k_pad, km_pad, r, u, cols, vals = _t(*_problem(5, 7, 64, 9, 8))
    _build.reset_launches()
    with pytest.raises(ValueError):
        sddmm_spmm.sddmm_spmm_type1(k_pad, r, u, cols, vals)
    with pytest.raises(ValueError):
        sddmm_spmm.sddmm_spmm_type2(k_pad, km_pad, u, cols, vals)
    with pytest.raises(ValueError):
        kexp.cdist_kexp(torch.ones(2, 3), torch.ones(4, 3), lamb=1.0)
    assert sum(_build.launches.values()) == 0


# -- the solvers on the golden corpus ----------------------------------------

@functools.lru_cache(maxsize=1)
def _corpus():
    """The golden corpus (`tests/test_golden.py::_corpus`), numpy only."""
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


def _queries():
    _, _, rs = _corpus()
    return [tsk.select_query(r) for r in rs]


@functools.lru_cache(maxsize=None)
def _jax_single(impl):
    """The golden routes ``single_*``, live (`tests/test_golden.py:80`)."""
    vecs, ell, _ = _corpus()
    return np.stack([np.asarray(jss.sinkhorn_wmd_sparse(
        jnp.asarray(s), jnp.asarray(rr), jnp.asarray(ell.cols),
        jnp.asarray(ell.vals), jnp.asarray(vecs), LAMB, MAX_ITER, impl=impl))
        for s, rr in _queries()])


def _port_single(impl):
    vecs, ell, _ = _corpus()
    return np.stack([tss.sinkhorn_wmd_sparse(
        *_t(s, rr, ell.cols, ell.vals, vecs), LAMB, MAX_ITER,
        impl=impl).numpy() for s, rr in _queries()])


@pytest.mark.parametrize("impl", ["fused", "unfused", "kernel"])
def test_sparse_single_matches_live_jax(impl):
    got = _port_single(impl)
    want = _jax_single(impl)
    assert got.shape == want.shape == (3, 24) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


def test_single_fused_matches_dense_oracle():
    """The reference's engine-vs-engine check (`tests/test_golden.py:234`)
    on the port: single_fused against the dense oracle, and every single
    route against single_fused."""
    vecs, ell, _ = _corpus()
    c = torch.from_numpy(ell.to_dense())
    dense = np.stack([tsk.sinkhorn_wmd_dense(
        *_t(s, rr), c, torch.from_numpy(vecs), LAMB, MAX_ITER).numpy()
        for s, rr in _queries()])
    fused = _port_single("fused")
    np.testing.assert_allclose(fused, dense, **TOL)
    for impl in ("unfused", "kernel"):
        np.testing.assert_allclose(_port_single(impl), fused, **TOL)


@pytest.mark.parametrize("tol", [1e-3, 1e-5, 1e-6])
def test_converged_matches_live_jax(tol):
    """Equal iteration counts, distances within the engine tolerance. At
    tol = 1e-6 the relative delta sits at fp32 round-off (query 0: 9.9e-7
    after 24 iterations in the reference, 5.0e-7 after 25 in the port, each
    crossing at its own step), so there the counts may differ by one."""
    vecs, ell, _ = _corpus()
    slack = 1 if tol < 1e-5 else 0
    for s, rr in _queries():
        got = tconv.sinkhorn_wmd_converged(
            *_t(s, rr, ell.cols, ell.vals, vecs), LAMB, 50, tol=tol)
        want = jconv.sinkhorn_wmd_converged(
            *_j(s, rr, ell.cols, ell.vals, vecs), LAMB, 50, tol=tol)
        assert abs(int(got.n_iter) - int(want.n_iter)) <= slack
        np.testing.assert_allclose(got.wmd.numpy(), np.asarray(want.wmd),
                                   **TOL)
        assert float(got.delta) < tol or int(got.n_iter) == 50
    # run to its end, it is the fixed loop of the fused solver, bitwise
    s, rr = _queries()[0]
    full = tconv.sinkhorn_wmd_converged(*_t(s, rr, ell.cols, ell.vals, vecs),
                                        LAMB, MAX_ITER, tol=0.0)
    assert int(full.n_iter) == MAX_ITER
    assert torch.equal(full.wmd, torch.from_numpy(_port_single("fused")[0]))


@pytest.mark.parametrize("impl", ["fused", "unfused", "kernel"])
def test_converged_batch_matches_live_jax(impl):
    vecs, ell, _ = _corpus()
    sels, rsels = zip(*_queries())
    sel_b, r_b, mask_b = tdist.pad_query_batch(sels, rsels, V_R_BUCKET)
    args = (sel_b, r_b, ell.cols, ell.vals, vecs)
    got = tconv.sinkhorn_wmd_converged_batch(
        *_t(*args), LAMB, 40, tol=1e-3, row_mask=torch.from_numpy(mask_b),
        impl=impl, docs_chunk=7)
    want = jconv.sinkhorn_wmd_converged_batch(
        *_j(*args), LAMB, 40, tol=1e-3, row_mask=jnp.asarray(mask_b),
        impl=impl, docs_chunk=7)
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(want.n_iter))
    np.testing.assert_allclose(got.wmd.numpy(), np.asarray(want.wmd), **TOL)
    assert got.wmd.shape == (3, 24) and bool((got.n_iter < 40).any())


def test_dense_history_matches_live_jax():
    vecs, ell, _ = _corpus()
    s, rr = _queries()[2]
    wmd, deltas = tsk.sinkhorn_wmd_dense_history(
        *_t(s, rr, ell.to_dense(), vecs), LAMB, MAX_ITER)
    jwmd, jdeltas = jsk.sinkhorn_wmd_dense_history(
        *_j(s, rr, ell.to_dense(), vecs), LAMB, MAX_ITER)
    np.testing.assert_allclose(wmd.numpy(), np.asarray(jwmd), **TOL)
    assert deltas.shape == (MAX_ITER,)
    np.testing.assert_allclose(deltas.numpy(), np.asarray(jdeltas),
                               rtol=1e-2, atol=1e-6)
    # the history's distances are the dense oracle's
    assert torch.equal(wmd, tsk.sinkhorn_wmd_dense(
        *_t(s, rr, ell.to_dense(), vecs), LAMB, MAX_ITER))


@functools.lru_cache(maxsize=None)
def _jax_wmd_fn(use_kernel):
    vecs, ell, _ = _corpus()
    rb = tf.rebucket_for_vocab_shards(ell, 1)
    mesh = make_mesh((1, 1), ("data", "model"))
    fn = jdist.build_wmd_fn(mesh, lamb=LAMB, max_iter=MAX_ITER,
                            use_kernel=use_kernel)
    placed = jdist.shard_wmd_inputs(mesh, vecs, rb.cols, rb.vals)
    out = []
    for s, rr in _queries():
        sel_p, r_p, mask = tdist.pad_query(s, rr, V_R_BUCKET)
        out.append(np.asarray(fn(jnp.asarray(vecs[sel_p]), jnp.asarray(r_p),
                                 jnp.asarray(mask), *placed)))
    return np.stack(out)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("kexp_impl", ["kernel", "jnp"])
def test_build_wmd_fn_matches_live_jax(use_kernel, kexp_impl):
    vecs, ell, _ = _corpus()
    rb = tf.rebucket_for_vocab_shards(ell, 1)
    fn = tdist.build_wmd_fn(lamb=LAMB, max_iter=MAX_ITER,
                            use_kernel=use_kernel, kexp_impl=kexp_impl)
    vecs_t = torch.from_numpy(vecs)
    got = []
    for s, rr in _queries():
        sel_p, r_p, mask = tdist.pad_query(s, rr, V_R_BUCKET)
        got.append(fn(vecs_t[torch.from_numpy(sel_p).long()],
                      *_t(r_p, mask), vecs_t, *_t(rb.cols, rb.vals)).numpy())
    np.testing.assert_allclose(np.stack(got), _jax_wmd_fn(use_kernel), **TOL)


def test_masked_k_spellings_and_pad_rows():
    """On the CPU #5's plain version is the matmul spelling: the two
    ``kexp_impl`` give the same bits; pad rows are exact zeros."""
    vecs, _, _ = _corpus()
    s, rr = _queries()[0]
    sel_p, _, mask = tdist.pad_query(s, rr, V_R_BUCKET)
    a = torch.from_numpy(vecs[sel_p])
    k, km = tdist.masked_k(a, torch.from_numpy(vecs), LAMB,
                           torch.from_numpy(mask), "kernel")
    k2, km2 = tdist.masked_k(a, torch.from_numpy(vecs), LAMB,
                             torch.from_numpy(mask), "jnp")
    assert torch.equal(k, k2) and torch.equal(km, km2)
    assert torch.all(k[s.size:] == 0) and torch.all(km[s.size:] == 0)
    with pytest.raises(ValueError):
        tdist.masked_k(a, torch.from_numpy(vecs), LAMB,
                       torch.from_numpy(mask), "pallas")


# -- the service --------------------------------------------------------------

def _cfg(cls):
    vecs, ell, _ = _corpus()
    return cls(name="golden", vocab_size=vecs.shape[0], embed_dim=8,
               num_docs=ell.num_docs, nnz_max=ell.nnz_max, v_r=V_R_BUCKET,
               lamb=LAMB, max_iter=MAX_ITER)


@functools.lru_cache(maxsize=1)
def _jax_service():
    vecs, ell, rs = _corpus()
    svc = JService(mesh=make_mesh((1, 1), ("data", "model")),
                   cfg=_cfg(JConfig), vecs=vecs, ell=ell)
    return (np.stack([svc.query(r) for r in rs]),
            [svc.top_k(r, TOP_K) for r in rs])


@pytest.mark.parametrize("impl,kexp_impl", [("kernel", "kernel"),
                                            ("fused", "jnp")])
def test_service_query_and_top_k_match_live_jax(impl, kexp_impl):
    vecs, ell, rs = _corpus()
    svc = WMDService(cfg=_cfg(WMDConfig), vecs=vecs, ell=ell, device="cpu",
                     impl=impl, kexp_impl=kexp_impl)
    want_d, want_top = _jax_service()
    got = np.stack([svc.query(r) for r in rs])
    assert got.shape == (3, 24) and got.dtype == np.float32
    np.testing.assert_allclose(got, want_d, **TOL)
    np.testing.assert_array_equal(svc.query_batch_sequential(rs), got)
    for r, (want_idx, want_dist) in zip(rs, want_top):
        idx, dist = svc.top_k(r, TOP_K)
        np.testing.assert_array_equal(idx, want_idx)
        np.testing.assert_allclose(dist, want_dist, **TOL)


def test_query_runs_the_per_query_program_only():
    """query / top_k / query_batch_sequential never reach the batched
    engine or the K cache; the program is keyed by (impl, kexp_impl,
    lamb)."""
    vecs, ell, rs = _corpus()
    svc = WMDService(cfg=_cfg(WMDConfig), vecs=vecs, ell=ell, device="cpu",
                     cache_capacity=64)

    def refuse(*args, **kwargs):
        raise AssertionError("the per-query path reached the batched engine")

    svc._batch_fn = svc._stripe_fn = refuse
    svc._kcache.stripes_for_batch = refuse
    d = svc.query(rs[0])
    idx, dist = svc.top_k(rs[1], TOP_K)
    seq = svc.query_batch_sequential(rs)
    np.testing.assert_array_equal(seq[0], d)
    np.testing.assert_array_equal(dist, seq[1][idx])
    assert list(svc._single_fns) == [("kernel", "kernel", LAMB)]
    assert svc.cache_stats.miss_rows == 0 and svc.cache_resident == 0
    with pytest.raises(TypeError):
        svc.top_k(rs[0], TOP_K, impl="fused")
    svc.cfg = WMDConfig(**{**svc.cfg.__dict__, "lamb": 0.5})
    svc.kexp_impl = "jnp"
    d_half = svc.query(rs[0])
    assert ("kernel", "jnp", 0.5) in svc._single_fns
    fresh = WMDService(cfg=svc.cfg, vecs=vecs, ell=ell, device="cpu",
                       kexp_impl="jnp")
    np.testing.assert_array_equal(fresh.query(rs[0]), d_half)
    assert not np.allclose(d_half, d)
