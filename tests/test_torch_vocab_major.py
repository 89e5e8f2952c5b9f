"""The vocab-major K layout of kernels #3, #4 and #1 on the CPU.

The kernel route copies the (Q, v_r, V+1) K and K.*M stripes into a
vocab-major (Q, V+1, v_r) layout once per stripe set (`ops.k_vocab_major`)
and runs every type1 (`ops.sddmm_spmm_type1_batch_vm`) and the type2
(`ops.sddmm_spmm_type2_batch_vm`) of the Sinkhorn loop on those copies; the
per-query program copies its query's K stripe once and runs its type1s on
it (`ops.sddmm_spmm_type1_vm`). On the CPU the plain versions gather
``k_vm[:, cols]``, the very tensor the reference layout's gather builds, so:

* the vocab-major plain route equals the reference-layout plain route,
  bitwise (type2 and the single-query type1: `test_torch_vocab_major_type2`);
* the batched solve loops on the new plumbing still match live JAX within
  the reference's engine tolerance (``rtol=2e-3, atol=1e-5``,
  `tests/test_golden.py:234-241`);
* the copies are made once per solve (per stripe set on the pruned
  reranks, once a query in the per-query program), never once per launch:
  counted by wrapping the `ops` entry points.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import convergence as jconv
from repro.core import sparse_sinkhorn as jss
from repro_torch.configs.sinkhorn_wmd import WMDConfig
from repro_torch.core import convergence as tconv
from repro_torch.core import distributed as tdist
from repro_torch.core import formats as tf
from repro_torch.core import sinkhorn as tsk
from repro_torch.core import sparse_sinkhorn as tss
from repro_torch.kernels import ops
from repro_torch.kernels import sddmm_spmm as sk
from repro_torch.serving import WMDService

LAMB, MAX_ITER, V_R_BUCKET = 1.0, 8, 12
TOL = dict(rtol=2e-3, atol=1e-5)


def _problem(seed, q, v_r, v, n, nnz, pad_rows=2, filler=True):
    """Stripes with pad query rows (zero K, r = 1), a Q-filler (all-zero K,
    the last query), ELL pad slots (col V, val 0) and a zero pad column."""
    rng = np.random.default_rng(seed)
    k = rng.random((q, v_r, v + 1)).astype(np.float32)
    k[:, :, v] = 0.0
    k[:, v_r - pad_rows:] = 0.0
    if filler:
        k[q - 1] = 0.0
    r = rng.random((q, v_r)).astype(np.float32) + 0.1
    r[:, v_r - pad_rows:] = 1.0
    u = (rng.random((q, v_r, n)) * 2 + 0.1).astype(np.float32)
    cols = np.full((n, nnz), v, np.int32)
    vals = np.zeros((n, nnz), np.float32)
    for j in range(n):
        m = int(rng.integers(1, nnz + 1))
        cols[j, :m] = rng.choice(v, m, replace=False)
        vals[j, :m] = rng.random(m).astype(np.float32) + 0.05
    return [torch.from_numpy(a) for a in (k, r, u, cols, vals)]


@pytest.mark.parametrize("shape", [(1, 20, 64, 9, 8), (3, 11, 320, 45, 16),
                                   (4, 32, 500, 70, 24),
                                   (2, 40, 257, 13, 8)])
def test_vocab_major_plain_route_is_reference_layout_route_bitwise(shape):
    k, r, u, cols, vals = _problem(0, *shape, filler=shape[0] > 1)
    k_vm = ops.k_vocab_major(k)
    q, v_r, vp1 = k.shape
    assert k_vm.shape == (q, vp1, v_r) and k_vm.is_contiguous()
    assert torch.equal(k_vm, k.transpose(1, 2))
    want = sk.sddmm_spmm_type1_batch_plain(k, r, u, cols, vals)
    assert torch.equal(ops.sddmm_spmm_type1_batch_vm(k_vm, r, u, cols, vals),
                       want)
    assert torch.equal(ops.sddmm_spmm_type1_batch(k, r, u, cols, vals), want)
    # pad query rows and the filler come out exact zeros on this route too
    assert torch.all(want[:, v_r - 2:] == 0)
    if q > 1:
        assert torch.all(want[q - 1] == 0)


@pytest.mark.parametrize("q", [1, 3])
def test_vocab_major_route_per_query_is_the_single_query_route(q):
    """#3 == #1 query by query, the card's bitwise contract, on the plain
    versions: the vocab-major batch row is the single-query iterate."""
    k, r, u, cols, vals = _problem(1, q, 11, 200, 30, 8, filler=q > 1)
    x = ops.sddmm_spmm_type1_batch_vm(ops.k_vocab_major(k), r, u, cols, vals)
    for i in range(q):
        assert torch.equal(x[i], ops.sddmm_spmm_type1(k[i], r[i], u[i], cols,
                                                      vals))


# -- the batched solve loops on the new plumbing, against live JAX ----------

@functools.lru_cache(maxsize=1)
def _corpus():
    """The golden corpus recipe (`tests/test_golden.py::_corpus`, seed
    1234), numpy only: (vecs, ell, rs)."""
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
def _stripes():
    """The port's (Q, v_r, V+1) stripes of the golden batch, as numpy, and
    the padded batch they came from."""
    vecs, ell, rs = _corpus()
    sels, rsels = zip(*[tsk.select_query(r) for r in rs])
    sel_b, r_b, mask_b = tdist.pad_query_batch(sels, rsels, V_R_BUCKET)
    pre = tss.precompute_batch(torch.from_numpy(sel_b), torch.from_numpy(r_b),
                               torch.from_numpy(vecs), LAMB,
                               torch.from_numpy(mask_b))
    return (tss.pad_k(pre.K).numpy(), tss.pad_k(pre.KM).numpy(), r_b,
            (sel_b, r_b, mask_b))


@functools.lru_cache(maxsize=None)
def _jax_stripes(docs_chunk, tol):
    _, ell, _ = _corpus()
    k, km, r, _ = _stripes()
    return np.asarray(jss.sinkhorn_wmd_sparse_batch_stripes(
        jnp.asarray(k), jnp.asarray(km), jnp.asarray(r),
        jnp.asarray(ell.cols), jnp.asarray(ell.vals), MAX_ITER,
        docs_chunk=docs_chunk, tol=tol))


@pytest.mark.parametrize("docs_chunk,tol", [(None, 0.0), (7, 0.0),
                                            (None, 1e-3)])
def test_stripes_solve_loop_matches_live_jax(docs_chunk, tol):
    """`core.sparse_sinkhorn._solve_batch_stripes` (one copy, then every
    type1 on it)."""
    _, ell, _ = _corpus()
    k, km, r, _ = _stripes()
    got = tss.sinkhorn_wmd_sparse_batch_stripes(
        torch.from_numpy(k), torch.from_numpy(km), torch.from_numpy(r),
        torch.from_numpy(ell.cols), torch.from_numpy(ell.vals), MAX_ITER,
        impl="kernel", docs_chunk=docs_chunk, tol=tol).numpy()
    np.testing.assert_allclose(got, _jax_stripes(docs_chunk, tol), **TOL)


@pytest.mark.parametrize("placement,docs_chunk", [("solve", None),
                                                  ("solve", 7),
                                                  ("iteration", 7)])
@pytest.mark.parametrize("given_copy", [False, True])
def test_local_batched_solve_matches_live_jax(placement, docs_chunk,
                                              given_copy):
    """`core.distributed._batched_solve` on one device through the stripes
    program, with the copies made inside or handed in by the caller (the
    reranks)."""
    _, ell, _ = _corpus()
    k, km, r, _ = _stripes()
    rb = tf.rebucket_for_vocab_shards(ell, 1)
    k_b, km_b = torch.from_numpy(k)[None], torch.from_numpy(km)[None]
    fn = tdist.build_wmd_batch_fn_stripes(max_iter=MAX_ITER, impl="kernel",
                                          docs_chunk=docs_chunk,
                                          chunk_placement=placement)
    vm = (tdist.vocab_major_stripes(k_b, km_b, "kernel") if given_copy
          else None)
    got = fn(k_b, km_b, torch.from_numpy(r), torch.from_numpy(rb.cols),
             torch.from_numpy(rb.vals), vm=vm).numpy()
    np.testing.assert_allclose(got, _jax_stripes(None, 0.0), **TOL)
    assert torch.equal(torch.from_numpy(got), fn(
        k_b, km_b, torch.from_numpy(r), torch.from_numpy(rb.cols),
        torch.from_numpy(rb.vals)))


def test_converged_batch_loop_matches_live_jax():
    vecs, ell, _ = _corpus()
    sel_b, r_b, mask_b = _stripes()[3]
    got = tconv.sinkhorn_wmd_converged_batch(
        torch.from_numpy(sel_b), torch.from_numpy(r_b),
        torch.from_numpy(ell.cols), torch.from_numpy(ell.vals),
        torch.from_numpy(vecs), LAMB, MAX_ITER, tol=1e-3,
        row_mask=torch.from_numpy(mask_b), impl="kernel")
    want = jconv.sinkhorn_wmd_converged_batch(
        jnp.asarray(sel_b), jnp.asarray(r_b), jnp.asarray(ell.cols),
        jnp.asarray(ell.vals), jnp.asarray(vecs), LAMB, MAX_ITER, tol=1e-3,
        row_mask=jnp.asarray(mask_b))
    np.testing.assert_allclose(got.wmd.numpy(), np.asarray(want.wmd), **TOL)
    np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(want.n_iter))


def test_plain_impls_make_no_copy(counts):
    k = torch.zeros((2, 3, 5))
    for impl in ("fused", "unfused"):
        assert tss.batched_contractions(impl, k, k) == tuple(
            tss._resolve_impl(kind, impl) for kind in ("type1", "type2"))
        assert tss.query_contractions(impl, k[0], k[0]) == tuple(
            tss._resolve_impl(kind, impl, False)
            for kind in ("type1", "type2"))
        assert tdist.vocab_major_stripes(k[None], k[None], impl) is None
    # the plain impls' solves run without a copy or a kernel-route call
    vecs, ell, rs = _corpus()
    k, km, r, _ = _stripes()
    sel, r_sel = tsk.select_query(rs[0])
    for impl in ("fused", "unfused"):
        tss.sinkhorn_wmd_sparse_batch_stripes(
            torch.from_numpy(k), torch.from_numpy(km), torch.from_numpy(r),
            torch.from_numpy(ell.cols), torch.from_numpy(ell.vals), MAX_ITER,
            impl=impl)
        tss.sinkhorn_wmd_sparse(
            torch.from_numpy(sel), torch.from_numpy(r_sel),
            torch.from_numpy(ell.cols), torch.from_numpy(ell.vals),
            torch.from_numpy(vecs), LAMB, MAX_ITER, impl=impl)
    assert counts == _counted()


# -- the copies are made once per stripe set, never once per launch ---------

_COUNTED = {"copy": "k_vocab_major", "type1": "sddmm_spmm_type1_batch_vm",
            "type2": "sddmm_spmm_type2_batch_vm",
            "type1_q": "sddmm_spmm_type1_vm",
            "type2_q": "sddmm_spmm_type2_vm"}


def _counted(**kw):
    """The counter dict `counts` should hold: zeros but for ``kw``."""
    return {**dict.fromkeys(_COUNTED, 0), **kw}


@pytest.fixture
def counts(monkeypatch):
    """Wrap `ops.k_vocab_major` (the K and K.*M copies), the batched
    type1 / type2 on the copies and the single-query type1 / type2 on the
    query's copies with call counters; returns the live counter dict."""
    seen = _counted()

    def counted(key, fn):
        def wrapper(*a, **kw):
            seen[key] += 1
            return fn(*a, **kw)
        return wrapper

    for key, name in _COUNTED.items():
        monkeypatch.setattr(ops, name, counted(key, getattr(ops, name)))
    return seen


@pytest.mark.parametrize("docs_chunk", [None, 7])
def test_stripes_solve_copies_once(counts, docs_chunk):
    _, ell, _ = _corpus()
    k, km, r, _ = _stripes()
    tss.sinkhorn_wmd_sparse_batch_stripes(
        torch.from_numpy(k), torch.from_numpy(km), torch.from_numpy(r),
        torch.from_numpy(ell.cols), torch.from_numpy(ell.vals), MAX_ITER,
        impl="kernel", docs_chunk=docs_chunk)
    chunks = 1 if docs_chunk is None else -(-ell.num_docs // docs_chunk)
    # one pair of copies (K, K.*M) for every chunk
    assert counts == _counted(copy=2, type1=MAX_ITER * chunks, type2=chunks)


@pytest.mark.parametrize("placement", ["solve", "iteration"])
def test_batch_program_copies_once(counts, placement):
    vecs, ell, _ = _corpus()
    sel_b, r_b, mask_b = _stripes()[3]
    rb = tf.rebucket_for_vocab_shards(ell, 1)
    fn = tdist.build_wmd_batch_fn(lamb=LAMB, max_iter=MAX_ITER,
                                  docs_chunk=7, chunk_placement=placement)
    vecs_t = torch.from_numpy(vecs)
    fn(vecs_t[torch.from_numpy(sel_b).long()], torch.from_numpy(r_b),
       torch.from_numpy(mask_b), vecs_t, torch.from_numpy(rb.cols),
       torch.from_numpy(rb.vals))
    chunks = -(-ell.num_docs // 7) if placement == "solve" else 1
    assert counts == _counted(copy=2, type1=MAX_ITER * chunks, type2=chunks)


def test_converged_batch_copies_once(counts):
    vecs, ell, _ = _corpus()
    sel_b, r_b, mask_b = _stripes()[3]
    out = tconv.sinkhorn_wmd_converged_batch(
        torch.from_numpy(sel_b), torch.from_numpy(r_b),
        torch.from_numpy(ell.cols), torch.from_numpy(ell.vals),
        torch.from_numpy(vecs), LAMB, MAX_ITER, tol=0.0,
        row_mask=torch.from_numpy(mask_b))
    assert counts == _counted(copy=2, type1=int(out.n_iter.max()), type2=1)


def _service(**kw):
    vecs, ell, _ = _corpus()
    cfg = WMDConfig(name="golden", vocab_size=vecs.shape[0], embed_dim=8,
                    num_docs=ell.num_docs, nnz_max=ell.nnz_max,
                    v_r=V_R_BUCKET, lamb=LAMB, max_iter=MAX_ITER)
    return WMDService(cfg=cfg, vecs=vecs, ell=ell, device="cpu", **kw)


@pytest.mark.parametrize("cache_capacity", [0, 64])
def test_query_batch_copies_once_a_batch(counts, cache_capacity):
    _, _, rs = _corpus()
    svc = _service(cache_capacity=cache_capacity)
    svc.query_batch(rs)
    assert counts == _counted(copy=2, type1=MAX_ITER, type2=1)


@pytest.mark.parametrize("rerank", ["per_query", "union"])
def test_pruned_rerank_copies_once_per_stripe_set(counts, rerank):
    """per_query: one stripe set (and one pair of copies, K and K.*M) a
    query, for all of its (1, chunk) programs; union: one for the whole
    batch."""
    _, _, rs = _corpus()
    svc = _service(cache_capacity=64, prune_chunk=4)
    idx, dist = svc.top_k_batch(rs, 5, prune=True, rerank=rerank)
    programs = svc.last_prune_stats["rerank_programs"]
    stripe_sets = len(rs) if rerank == "per_query" else 1
    assert programs > stripe_sets          # k = 5 needs two 4-doc blocks
    assert counts == _counted(copy=2 * stripe_sets, type1=MAX_ITER * programs,
                              type2=programs)
    # and the answer is the top-k of the full rows of the same route
    full = svc.query_batch(rs)
    np.testing.assert_array_equal(idx, svc._top_k(full, 5))
    np.testing.assert_array_equal(dist, np.take_along_axis(full, idx, -1))


def test_per_query_program_copies_once_a_query(counts):
    """The per-query program (`query(r)`, `top_k(r)`,
    `query_batch_sequential`, `sinkhorn_wmd_sparse`) copies its query's K
    and K.*M stripes once (two `k_vocab_major` calls, `vocab_major_pair`)
    and runs its ``max_iter`` type1s (#1) and its one type2 (#2) on those
    copies."""
    vecs, ell, rs = _corpus()
    svc = _service()
    svc.query(rs[0])
    svc.top_k(rs[1], 5)
    svc.query_batch_sequential(rs)
    nq = 2 + len(rs)
    assert counts == _counted(copy=2 * nq, type1_q=MAX_ITER * nq, type2_q=nq)
    sel, r_sel = tsk.select_query(rs[0])
    tss.sinkhorn_wmd_sparse(torch.from_numpy(sel), torch.from_numpy(r_sel),
                            torch.from_numpy(ell.cols),
                            torch.from_numpy(ell.vals),
                            torch.from_numpy(vecs), LAMB, MAX_ITER)
    assert counts == _counted(copy=2 * (nq + 1), type1_q=MAX_ITER * (nq + 1),
                              type2_q=nq + 1)
