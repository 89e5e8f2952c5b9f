"""The port's retrieval cascade on the CPU: the tiers of `repro_torch.core.
cascade` against `repro.core.cascade` on identical inputs, the bound chain
tier0 <= LC == doc-side <= the port's engine distance, and the bitwise
contracts of the pruned service inside the port (pruned == scan == union,
tier toggles, M cache on == off).

Tolerance for the tiers: ``rtol=1e-5, atol=1e-6``, the reference's own
cross-spelling slack (tests/test_cascade_properties.py:47). The bound chain
is checked as ``bound <= d * (1 + 1e-5) + 1e-6``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cascade as jcascade
from repro.core import rwmd as jrwmd
from repro_torch.configs.sinkhorn_wmd import WMDConfig
from repro_torch.core import cascade, rwmd
from repro_torch.core.distributed import pad_query_batch
from repro_torch.core.formats import ell_from_dense
from repro_torch.core.sinkhorn import select_query
from repro_torch.core.sparse_sinkhorn import sinkhorn_wmd_sparse_batch
from repro_torch.data.corpus import make_corpus, zipf_query_stream
from repro_torch.kernels import ref
from repro_torch.serving import WMDService

RTOL, ATOL = 1e-5, 1e-6
TOL = dict(rtol=RTOL, atol=ATOL)


def _problem(seed, *, v=96, w=8, n=20, vr_bucket=8, q=3):
    """Random batched WMD problem (tests/test_cascade_properties.py:54):
    (sel_b, r_b, mask_b, ell, vecs), numpy."""
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(v, w)).astype(np.float32)
    c = np.zeros((v, n), np.float32)
    for j in range(n):
        widx = rng.choice(v, rng.integers(2, 9), replace=False)
        c[widx, j] = rng.random(widx.size).astype(np.float32)
        c[:, j] /= c[:, j].sum()
    ell = ell_from_dense(c)
    rs = []
    for _ in range(q):
        r = np.zeros(v, np.float32)
        idx = rng.choice(v, int(rng.integers(3, vr_bucket + 1)),
                         replace=False)
        r[idx] = rng.random(idx.size).astype(np.float32) + 0.1
        r /= r.sum()
        rs.append(r)
    sels, rsels = zip(*[select_query(r) for r in rs])
    sel_b, r_b, mask_b = pad_query_batch(sels, rsels, vr_bucket)
    return sel_b, r_b, mask_b, ell, vecs


def _t(*arrs):
    return [torch.from_numpy(np.asarray(a)) for a in arrs]


def _tier_bounds(sel_b, r_b, mask_b, ell, vecs, *, impl="kernel"):
    """The port's (tier0, lc, doc_side) bound matrices, (Q, N) numpy."""
    cols, vals, vecs_t = _t(ell.cols, ell.vals, vecs)
    g, m = cascade.doc_centroids(cols, vals, vecs_t)
    lb0 = cascade.centroid_bound_batch(*_t(sel_b, r_b, mask_b), vecs_t, g, m)
    m_pad = rwmd.assemble_m_stripes(sel_b, mask_b, vecs_t, rows_bucket=8)
    lb_lc = cascade.lc_rwmd_bound_batch(cascade.min_cost_vectors(m_pad),
                                        cols, vals, impl=impl)
    lb_doc = rwmd.rwmd_bound_batch(m_pad, cols, vals, impl=impl)
    return lb0.numpy(), lb_lc.numpy(), lb_doc.numpy()


@pytest.mark.parametrize("impl", ["fused", "unfused", "kernel"])
@pytest.mark.parametrize("max_iter", [1, 3, 15])
def test_bound_chain_all_impls_all_budgets(impl, max_iter):
    """tier0 <= LC == doc-side <= the engine's distance at any fixed budget
    (tests/test_cascade_properties.py:118, on the port's engine)."""
    sel_b, r_b, mask_b, ell, vecs = _problem(seed=max_iter * 13 + 5)
    bound_impl = "fused" if impl == "unfused" else impl
    lb0, lb_lc, lb_doc = _tier_bounds(sel_b, r_b, mask_b, ell, vecs,
                                      impl=bound_impl)
    np.testing.assert_array_equal(lb_lc, lb_doc)
    assert np.all(lb0 <= lb_lc * (1 + RTOL) + ATOL), \
        f"tier0 exceeds LC by {np.max(lb0 - lb_lc)}"
    d = sinkhorn_wmd_sparse_batch(*_t(sel_b, r_b, ell.cols, ell.vals, vecs),
                                  1.0, max_iter,
                                  row_mask=torch.from_numpy(mask_b),
                                  impl=impl).numpy()
    assert np.all(lb_doc <= d * (1 + RTOL) + ATOL), \
        f"doc-side bound exceeds engine output by {np.max(lb_doc - d)}"


def test_tiers_match_reference_on_identical_inputs():
    """Each tier against the reference's fused spelling on the same M
    stripes (the reference's own) and the same moments inputs."""
    sel_b, r_b, mask_b, ell, vecs = _problem(seed=17)
    jcols, jvals, jvecs = (jnp.asarray(x) for x in (ell.cols, ell.vals, vecs))
    cols, vals, vecs_t = _t(ell.cols, ell.vals, vecs)
    m_pad = np.array(jrwmd.assemble_m_stripes(sel_b, mask_b, jvecs,
                                              rows_bucket=8))
    minm = cascade.min_cost_vectors(torch.from_numpy(m_pad))
    jminm = jcascade.min_cost_vectors(jnp.asarray(m_pad))
    np.testing.assert_array_equal(minm.numpy(), np.asarray(jminm))
    lc = cascade.lc_rwmd_bound_batch(minm, cols, vals, impl="fused")
    np.testing.assert_allclose(lc.numpy(), np.asarray(
        jcascade.lc_rwmd_bound_batch(jminm, jcols, jvals)), **TOL)
    np.testing.assert_allclose(lc.numpy(), ref.lc_rwmd_bound_batch(
        minm, cols, vals).numpy(), **TOL)
    for chunk in (7, 64):
        assert torch.equal(cascade.lc_rwmd_bound_batch(
            minm, cols, vals, impl="fused", docs_chunk=chunk), lc)
    assert torch.equal(cascade.lc_rwmd_bound_batch(minm, cols, vals), lc)
    g, m = cascade.doc_centroids(cols, vals, vecs_t)
    jg, jm = jcascade.doc_centroids(jcols, jvals, jvecs)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), **TOL)
    lb0 = cascade.centroid_bound_batch(*_t(sel_b, r_b, mask_b), vecs_t, g, m)
    want = jcascade.centroid_bound_batch(
        jnp.asarray(sel_b), jnp.asarray(r_b), jnp.asarray(mask_b), jvecs,
        jg, jm)
    np.testing.assert_allclose(lb0.numpy(), np.asarray(want), **TOL)
    r_t = torch.from_numpy(r_b)
    qs = rwmd.rwmd_query_side_bound(torch.from_numpy(m_pad), r_t, cols, vals)
    np.testing.assert_allclose(qs.numpy(), np.asarray(
        jrwmd.rwmd_query_side_bound(jnp.asarray(m_pad), jnp.asarray(r_b),
                                    jcols, jvals)), **TOL)


def test_cascade_pads_and_empties_inert():
    """Filler queries and empty docs score exactly 0 in every tier."""
    sel_b, r_b, mask_b, ell, vecs = _problem(seed=23, n=12)
    sel_f = np.concatenate([sel_b, np.zeros((1, 8), sel_b.dtype)])
    r_f = np.concatenate([r_b, np.zeros((1, 8), r_b.dtype)])
    mask_f = np.concatenate([mask_b, np.zeros((1, 8), mask_b.dtype)])
    nnz = ell.cols.shape[1]
    ell_e = type(ell)(
        cols=np.concatenate([ell.cols, np.full((1, nnz), ell.num_vocab,
                                               ell.cols.dtype)]),
        vals=np.concatenate([ell.vals, np.zeros((1, nnz), ell.vals.dtype)]),
        num_vocab=ell.num_vocab)
    for lb in _tier_bounds(sel_f, r_f, mask_f, ell_e, vecs):
        assert np.all(lb[-1] == 0.0)        # filler query row
        assert np.all(lb[:, -1] == 0.0)     # empty doc column
        assert np.isfinite(lb).all()


def test_tier0_zero_on_isotropic_positive_on_clustered():
    """Tier 0 is geometry: strictly positive when query and corpus words sit
    in different clusters, 0 on isotropic random embeddings."""
    rng = np.random.default_rng(29)
    v, w, nq = 64, 8, 12
    vecs = np.empty((v, w), np.float32)
    vecs[:nq] = 0.05 * rng.normal(size=(nq, w))
    far = rng.normal(size=(v - nq, w))
    far /= np.linalg.norm(far, axis=1, keepdims=True)
    vecs[nq:] = 10.0 * far + 0.05 * rng.normal(size=(v - nq, w))
    c = np.zeros((v, 6), np.float32)
    for j in range(6):
        widx = nq + rng.choice(v - nq, 5, replace=False)
        c[widx, j] = rng.random(5).astype(np.float32)
        c[:, j] /= c[:, j].sum()
    ell = ell_from_dense(c)
    rs = []
    for _ in range(2):
        r = np.zeros(v, np.float32)
        idx = rng.choice(nq, 4, replace=False)
        r[idx] = rng.random(4).astype(np.float32) + 0.1
        rs.append(r / r.sum())
    sels, rsels = zip(*[select_query(r) for r in rs])
    sel_b, r_b, mask_b = pad_query_batch(sels, rsels, 8)
    lb0, lb_lc, _ = _tier_bounds(sel_b, r_b, mask_b, ell, vecs)
    assert np.all(lb0[:2] > 1.0)
    assert np.all(lb0 <= lb_lc * (1 + RTOL) + ATOL)
    data = make_corpus(vocab_size=256, embed_dim=32, num_docs=16,
                       num_queries=0, query_words=11, mean_words=30.0,
                       seed=31)
    qs = _queries(256, 2, seed=31)
    sels, rsels = zip(*[select_query(r) for r in qs])
    sel_i, r_i, mask_i = pad_query_batch(sels, rsels, 16)
    lb0_iso, _, _ = _tier_bounds(sel_i, r_i, mask_i, data.ell, data.vecs)
    assert float(lb0_iso.max()) == 0.0


# -- the pruned service, bitwise inside the port ------------------------------

@functools.lru_cache(maxsize=None)
def _data(seed, docs, vocab=512):
    return make_corpus(vocab_size=vocab, embed_dim=32, num_docs=docs,
                       num_queries=1, query_words=11, mean_words=12.0,
                       seed=seed)


def _service(seed, *, docs=64, vocab=512, capacity=0, mcache=0,
             prune_chunk=16, **kw):
    data = _data(seed, docs, vocab)
    cfg = WMDConfig(name="cascade-prop", vocab_size=vocab, embed_dim=32,
                    num_docs=docs, nnz_max=64, v_r=16, lamb=1.0, max_iter=8)
    return WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell, device="cpu",
                      cache_capacity=capacity, mcache_capacity=mcache,
                      prune_chunk=prune_chunk, bound_docs_chunk=None, **kw)


def _queries(vocab, q, seed):
    stream = zipf_query_stream(vocab_size=vocab, query_words=11, s=1.2,
                               seed=seed)
    return [next(stream) for _ in range(q)]


@pytest.mark.parametrize("chunk", [4, 16])
@pytest.mark.parametrize("k", [1, 5, 50])
def test_pruned_equals_scan_bitwise(k, chunk):
    svc = _service(seed=37, docs=40, prune_chunk=chunk, capacity=64)
    qs = _queries(512, 3, seed=37)
    idx_p, d_p = svc.top_k_batch(qs, k, prune=True)
    stats = dict(svc.last_prune_stats)
    idx_s, d_s = svc.top_k_scan_batch(qs, k)
    np.testing.assert_array_equal(idx_p, idx_s)
    np.testing.assert_array_equal(d_p, d_s)
    assert idx_p.shape == (3, min(k, 40))
    assert svc.last_prune_stats["solves_avoided"] == 0.0
    assert stats["exact_solves"] <= 3 * 40 and stats["chunk"] == chunk
    assert stats["kcache_misses"] and len(stats["kcache_misses"]) == 3


def test_union_equals_per_query_and_unpruned():
    svc = _service(seed=41, capacity=64)
    qs = _queries(512, 3, seed=41)
    idx_p, d_p = svc.top_k_batch(qs, 5, prune=True)
    programs = svc.last_prune_stats["rerank_programs"]
    idx_u, d_u = svc.top_k_batch(qs, 5, prune=True, rerank="union")
    assert svc.last_prune_stats["rerank"] == "union"
    assert svc.last_prune_stats["rerank_programs"] <= programs
    np.testing.assert_array_equal(idx_u, idx_p)
    np.testing.assert_array_equal(d_u, d_p)
    idx_1, d_1 = svc.top_k(qs[1], 5, prune=True)
    np.testing.assert_array_equal(idx_1, idx_p[1])
    np.testing.assert_array_equal(d_1, d_p[1])
    # the exhaustive one-program scan selects the same set
    idx_f, d_f = svc.top_k_batch(qs, 5)
    np.testing.assert_array_equal(idx_f, idx_p)
    np.testing.assert_allclose(d_f, d_p, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        svc.top_k_batch(qs, 5, rerank="union")
    with pytest.raises(ValueError):
        svc.top_k_batch(qs, 5, prune=True, rerank="offline")


@pytest.mark.parametrize("cfg_kw", [
    {"tier0": False},
    {"lc_impl": None},
    {"tier2_cap": 0},
    {"tier0": False, "lc_impl": None, "tier2_cap": 0},   # no pruning at all
    {"lc_impl": "fused", "bound_impl": "fused"},
    {"tier2_cap": 8},
])
def test_tier_toggle_bitwise_invariant(cfg_kw):
    base = _service(seed=37)
    qs = _queries(512, 3, seed=37)
    idx_b, d_b = base.top_k_batch(qs, 5, prune=True)
    svc = _service(seed=37, **cfg_kw)
    idx_t, d_t = svc.top_k_batch(qs, 5, prune=True)
    np.testing.assert_array_equal(idx_t, idx_b)
    np.testing.assert_array_equal(d_t, d_b)
    if len(cfg_kw) == 3:
        # all tiers off: zero bounds prune nothing, the scan in disguise
        assert svc.last_prune_stats["solves_avoided"] == 0.0
        assert svc.last_prune_stats["tiers"] == []


def test_tier_funnel_stats_shape():
    svc = _service(seed=41)
    qs = _queries(512, 3, seed=41)
    svc.top_k_batch(qs, 5, prune=True)
    ps = svc.last_prune_stats
    assert [t["tier"] for t in ps["tiers"]] == ["centroid", "lc_rwmd", "rwmd"]
    cum = [t["cascade_solves_avoided"] for t in ps["tiers"]]
    assert all(b >= a for a, b in zip(cum, cum[1:]))
    assert ps["solves_avoided"] > 0.0
    assert ps["bound_s"] >= 0.0 and ps["rerank_s"] >= 0.0


def test_service_mcache_on_off_bitwise_with_evictions():
    svc = _service(seed=47, mcache=24)
    svc_off = _service(seed=47)
    for s in (47, 48, 47):
        qs = _queries(512, 3, seed=s)
        idx_on, d_on = svc.top_k_batch(qs, 5, prune=True)
        idx_nc, d_nc = svc.top_k_batch(qs, 5, prune=True, use_cache=False)
        idx_off, d_off = svc_off.top_k_batch(qs, 5, prune=True)
        for idx, d in ((idx_nc, d_nc), (idx_off, d_off)):
            np.testing.assert_array_equal(idx_on, idx)
            np.testing.assert_array_equal(d_on, d)
    assert svc.mcache_stats.hit_rows > 0 and svc.mcache_stats.evictions > 0
    resident = svc.mcache_resident
    assert 0 < resident <= 24
    assert svc.invalidate_embedding_rows(range(512)) == resident
    assert svc.mcache_resident == 0


def test_bounds_tier_is_sound_and_selects_by_bound():
    svc = _service(seed=53, capacity=64)
    qs = _queries(512, 3, seed=53)
    lb = svc.query_batch_bounds(qs)
    assert svc.last_batch_stats["degraded"] is True
    d = svc.query_batch(qs)
    assert lb.shape == d.shape == (3, 64)
    assert np.all(lb <= d * (1 + RTOL) + ATOL)
    idx, dist = svc.top_k_batch_bounds(qs, 4)
    np.testing.assert_array_equal(idx, svc._top_k(lb, 4))
    np.testing.assert_array_equal(dist, np.take_along_axis(lb, idx, -1))
    assert svc.query_batch_bounds([]).shape == (0, 64)
    assert svc.top_k_batch([], 3, prune=True)[0].shape == (0, 3)
