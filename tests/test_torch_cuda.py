"""Card tests of the port's CUDA kernels: each kernel against its plain
PyTorch version on the same CUDA tensors.

Marked ``cuda``; every test decides inside its body whether a card is
present and skips when there is none (never at import, so all pytest
workers collect the same tests). Run on a machine with an NVIDIA GPU:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import repro_torch  # noqa: F401  (precision pins)

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _problem(seed, q, v_r, v, n, nnz, pad_rows=2, filler=1):
    """Stripes with pad query rows (zero K, r = 1), Q-filler (all-zero K),
    ELL pad slots (col V, val 0) and a zero pad column."""
    rng = np.random.default_rng(seed)
    k = rng.random((q, v_r, v + 1)).astype(np.float32)
    k[:, :, v] = 0.0
    k[:, v_r - pad_rows:] = 0.0
    k[q - filler:] = 0.0
    km = (k * rng.random(k.shape).astype(np.float32) * 3).astype(np.float32)
    r = rng.random((q, v_r)).astype(np.float32) + 0.1
    r[:, v_r - pad_rows:] = 1.0
    u = (rng.random((q, v_r, n)) * 2 + 0.1).astype(np.float32)
    cols = np.full((n, nnz), v, np.int32)
    vals = np.zeros((n, nnz), np.float32)
    for j in range(n):
        m = int(rng.integers(1, nnz + 1))
        cols[j, :m] = rng.choice(v, m, replace=False)
        vals[j, :m] = rng.random(m).astype(np.float32) + 0.05
    return k, km, r, u, cols, vals


@pytest.mark.parametrize("shape", [(3, 11, 320, 45, 16), (4, 32, 1000, 70, 24),
                                   (2, 40, 257, 9, 8), (5, 128, 300, 33, 8)])
@pytest.mark.parametrize("docs_blk", [1, 7, 8, 64])
def test_sddmm_spmm_batch_kernels_match_plain(shape, docs_blk):
    dev = _card()
    from repro_torch.kernels import sddmm_spmm as sk
    q, v_r, v, n, nnz = shape
    arrs = [torch.from_numpy(a).to(dev) for a in _problem(0, *shape)]
    k, km, r, u, cols, vals = arrs
    x = sk.sddmm_spmm_type1_batch(k, r, u, cols, vals, docs_blk=docs_blk)
    x_ref = sk.sddmm_spmm_type1_batch_plain(k, r, u, cols, vals)
    torch.cuda.synchronize()
    # sums over v_r and nnz run in another order: fp32 reassociation
    torch.testing.assert_close(x, x_ref, rtol=1e-4, atol=1e-6)
    d = sk.sddmm_spmm_type2_batch(k, km, u, cols, vals, docs_blk=docs_blk)
    d_ref = sk.sddmm_spmm_type2_batch_plain(k, km, u, cols, vals)
    torch.cuda.synchronize()
    torch.testing.assert_close(d, d_ref, rtol=1e-4, atol=1e-6)
    # pad query rows and the Q-filler come out as exact zeros
    assert torch.all(x[:, v_r - 2:] == 0) and torch.all(x[q - 1] == 0)
    assert torch.all(d[q - 1] == 0)


def test_sddmm_spmm_kernel_bits_do_not_depend_on_docs_blk():
    dev = _card()
    from repro_torch.kernels import sddmm_spmm as sk
    arrs = [torch.from_numpy(a).to(dev) for a in _problem(1, 4, 32, 500, 61, 16)]
    k, km, r, u, cols, vals = arrs
    xs = [sk.sddmm_spmm_type1_batch(k, r, u, cols, vals, docs_blk=b)
          for b in (1, 8, 61)]
    ds = [sk.sddmm_spmm_type2_batch(k, km, u, cols, vals, docs_blk=b)
          for b in (1, 8, 61)]
    for x in xs[1:]:
        assert torch.equal(x, xs[0])
    for d in ds[1:]:
        assert torch.equal(d, ds[0])


@pytest.mark.parametrize("m,v,w", [(13, 320, 24), (128, 1000, 300),
                                   (64, 64, 16), (1, 77, 5)])
def test_cdist_kexp_rows_kernel_matches_plain(m, v, w):
    dev = _card()
    from repro_torch.kernels import kexp
    rng = np.random.default_rng(2)
    b = torch.from_numpy(rng.normal(scale=1.3, size=(v, w))
                         .astype(np.float32)).to(dev)
    ids = torch.from_numpy(rng.choice(v, m, replace=False)).to(dev)
    a = b[ids].contiguous()
    k, km = kexp.cdist_kexp_rows(a, b, lamb=1.0)
    k_ref, km_ref = kexp.cdist_kexp_rows_plain(a, b, lamb=1.0)
    torch.cuda.synchronize()
    # near the diagonal |a|^2 + |b|^2 - 2ab cancels to round-off in both
    # spellings (M(i, i) ~ 1e-2 instead of 0 at w = 300), so K there
    # differs by up to a few 1e-2 absolute; elsewhere only the
    # reassociated dot products differ
    m_ref = torch.where(k_ref > 0, km_ref / k_ref, 0.0)
    near = m_ref < 1.0
    assert torch.all((k - k_ref).abs()[near] <= 5e-2)
    torch.testing.assert_close(k[~near], k_ref[~near], rtol=1e-3, atol=0.0)
    torch.testing.assert_close(km[~near], km_ref[~near], rtol=1e-3,
                               atol=0.0)


def test_kexp_row_bits_do_not_depend_on_chunk_mates():
    dev = _card()
    from repro_torch.kernels import kexp
    rng = np.random.default_rng(3)
    b = torch.from_numpy(rng.normal(size=(700, 300)).astype(np.float32)) \
        .to(dev)
    ids_a = torch.arange(0, 128, device=dev)
    ids_b = torch.cat([torch.arange(64, 128, device=dev),
                       torch.arange(300, 364, device=dev)])
    ka, kma = kexp.cdist_kexp_rows(b[ids_a].contiguous(), b, lamb=1.0)
    kb, kmb = kexp.cdist_kexp_rows(b[ids_b].contiguous(), b, lamb=1.0)
    # rows 64..127 sit at positions 64.. in the first call, 0.. in the second
    assert torch.equal(ka[64:], kb[:64]) and torch.equal(kma[64:], kmb[:64])


def test_ops_dispatch_launches_on_cuda_and_counts():
    dev = _card()
    from repro_torch.kernels import _build, ops
    arrs = [torch.from_numpy(a).to(dev) for a in _problem(4, 2, 8, 50, 10, 8)]
    k, km, r, u, cols, vals = arrs
    _build.reset_launches()
    ops.sddmm_spmm_type1_batch(k, r, u, cols, vals)
    ops.sddmm_spmm_type2_batch(k, km, u, cols, vals)
    ops.cdist_kexp_rows(torch.ones(3, 4, device=dev),
                        torch.ones(9, 4, device=dev), lamb=1.0)
    torch.cuda.synchronize()
    assert _build.launches["sddmm_spmm_type1_batch"] == 1
    assert _build.launches["sddmm_spmm_type2_batch"] == 1
    assert _build.launches["cdist_kexp_rows"] == 1


def test_service_kernel_route_matches_fused_on_card():
    dev = _card()
    from repro_torch.configs.sinkhorn_wmd import WMDConfig
    from repro_torch.data.corpus import make_corpus, zipf_query_stream
    from repro_torch.serving import WMDService
    data = make_corpus(vocab_size=2048, embed_dim=32, num_docs=200,
                       num_queries=1, seed=5)
    cfg = WMDConfig(name="t", vocab_size=2048, embed_dim=32, num_docs=200,
                    nnz_max=data.ell.nnz_max, v_r=32, lamb=1.0, max_iter=10)
    stream = zipf_query_stream(vocab_size=2048, seed=6)
    rs = [next(stream) for _ in range(5)]
    svc = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell, device=dev,
                     cache_capacity=256)
    d = svc.query_batch(rs)
    d_off = svc.query_batch(rs, use_cache=False)
    np.testing.assert_array_equal(d, d_off)
    base = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell, device=dev,
                      cache_capacity=256, impl="fused", kexp_impl="jnp")
    np.testing.assert_allclose(d, base.query_batch(rs), rtol=2e-3,
                               atol=1e-5)


# -- slice 2: the bound tiers' kernels (cdist, rwmd_bound_batch, lc) ----------

def _near(d2_ref):
    # a row against its own word: the plain spelling keeps the expansion's
    # round-off (M up to ~2.5e-2 at w = 300), the kernel cancels exactly
    return d2_ref < 1.0


@pytest.mark.parametrize("m,v,w", [(13, 320, 24), (128, 1000, 300),
                                   (64, 64, 16), (1, 77, 5), (70, 2049, 33)])
@pytest.mark.parametrize("squared", [False, True])
def test_cdist_kernel_matches_plain(m, v, w, squared):
    dev = _card()
    from repro_torch.kernels import cdist
    rng = np.random.default_rng(7)
    b = torch.from_numpy(rng.normal(scale=1.3, size=(v, w))
                         .astype(np.float32)).to(dev)
    ids = torch.from_numpy(rng.choice(v, m, replace=False)).to(dev)
    a = b[ids].contiguous()
    got = cdist.cdist(a, b, squared=squared)
    want = cdist.cdist_plain(a, b, squared=squared)
    d2 = cdist.cdist_plain(a, b, squared=True)
    torch.cuda.synchronize()
    near = _near(d2)
    # the norms and products are summed in another order (rtol 1e-4,
    # atol 1e-5); near the diagonal the plain spelling's round-off
    assert torch.all((got - want).abs()[near] <= (1e-3 if squared else 5e-2))
    torch.testing.assert_close(got[~near], want[~near], rtol=1e-4,
                               atol=1e-5)
    # a row's own word is exactly 0
    assert torch.all(got[torch.arange(m, device=dev), ids] == 0.0)


def test_cdist_m_is_the_m_that_kexp_exponentiates():
    """The distance epilogue shares the exp epilogue's tile loop and M
    expression: K.*M == K * M bitwise wherever K has not underflowed."""
    dev = _card()
    from repro_torch.kernels import cdist, kexp
    rng = np.random.default_rng(8)
    b = torch.from_numpy(rng.normal(size=(3000, 300)).astype(np.float32)) \
        .to(dev)
    a = b[torch.arange(100, 228, device=dev)].contiguous()
    m = cdist.cdist(a, b)
    k, km = kexp.cdist_kexp_rows(a, b, lamb=1.0)
    torch.cuda.synchronize()
    live = k > 0
    assert int(live.sum()) > 0
    assert torch.equal(km[live], (k * m)[live])
    assert torch.equal(torch.sqrt(cdist.cdist(a, b, squared=True)), m)


def _bound_problem(seed, q, v_r, v, n, nnz, pad_rows=2, filler=True):
    """M stripes with +inf pad rows and an all-+inf filler query (the
    last, unless ``filler`` is False), ELL pad slots and an empty doc (the
    last)."""
    rng = np.random.default_rng(seed)
    m = (rng.random((q, v_r, v + 1)) * 4).astype(np.float32)
    m[:, :, v] = 0.0
    m[:, v_r - pad_rows:] = np.inf
    if filler:
        m[q - 1] = np.inf
    cols = np.full((n, nnz), v, np.int32)
    vals = np.zeros((n, nnz), np.float32)
    for j in range(n - 1):
        c = int(rng.integers(1, nnz + 1))
        cols[j, :c] = rng.choice(v, c, replace=False)
        vals[j, :c] = rng.random(c).astype(np.float32) + 0.05
    return m, cols, vals


@pytest.mark.parametrize("shape", [(3, 11, 320, 45, 16), (4, 32, 1000, 70, 24),
                                   (2, 40, 257, 9, 8), (5, 128, 300, 33, 8)])
@pytest.mark.parametrize("docs_blk", [1, 7, 8, 256])
def test_rwmd_kernels_match_plain_and_each_other(shape, docs_blk):
    dev = _card()
    from repro_torch.core.cascade import min_cost_vectors
    from repro_torch.kernels import lcrwmd, ops
    from repro_torch.kernels import rwmd as kr
    m, cols, vals = (torch.from_numpy(a).to(dev)
                     for a in _bound_problem(0, *shape))
    minm = min_cost_vectors(m)
    lb = kr.rwmd_bound_batch(m, cols, vals, docs_blk=docs_blk)
    lc = lcrwmd.lc_rwmd_bound_batch(minm, cols, vals, docs_blk=docs_blk)
    torch.cuda.synchronize()
    # the same min and the same accumulation step: bitwise equal
    assert torch.equal(lb, lc)
    fin = ops.rwmd_bound_batch(m, cols, vals, docs_blk=docs_blk)
    plain = ops._finite(kr.rwmd_bound_batch_plain(m, cols, vals))
    # slot sums in another order (fma chain vs torch's sum)
    torch.testing.assert_close(fin, plain, rtol=1e-5, atol=1e-6)
    plain_lc = ops._finite(lcrwmd.lc_rwmd_bound_batch_plain(minm, cols, vals))
    assert torch.equal(plain, plain_lc)
    # the filler query and the empty doc score exactly 0
    assert torch.all(fin[-1] == 0) and torch.all(fin[:, -1] == 0)
    assert torch.isfinite(fin).all()


def test_rwmd_kernel_bits_do_not_depend_on_docs_blk():
    dev = _card()
    from repro_torch.kernels import lcrwmd
    from repro_torch.kernels import rwmd as kr
    m, cols, vals = (torch.from_numpy(a).to(dev)
                     for a in _bound_problem(1, 4, 32, 500, 61, 16))
    minm = torch.amin(m, dim=1)
    lbs = [kr.rwmd_bound_batch(m, cols, vals, docs_blk=b) for b in (1, 8, 61)]
    lcs = [lcrwmd.lc_rwmd_bound_batch(minm, cols, vals, docs_blk=b)
           for b in (1, 8, 300)]
    for x in lbs[1:] + lcs:
        assert torch.equal(x, lbs[0])


def test_pruned_service_on_card_is_exact_and_counts_launches():
    dev = _card()
    from repro_torch.configs.sinkhorn_wmd import WMDConfig
    from repro_torch.data.corpus import make_corpus, zipf_query_stream
    from repro_torch.kernels import _build
    from repro_torch.serving import WMDService
    data = make_corpus(vocab_size=2048, embed_dim=32, num_docs=300,
                       num_queries=1, seed=9)
    cfg = WMDConfig(name="t", vocab_size=2048, embed_dim=32, num_docs=300,
                    nnz_max=data.ell.nnz_max, v_r=32, lamb=1.0, max_iter=10)
    stream = zipf_query_stream(vocab_size=2048, seed=10)
    rs = [next(stream) for _ in range(5)]
    svc = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell, device=dev,
                     cache_capacity=256, mcache_capacity=256, prune_chunk=16)
    _build.reset_launches()
    idx, d = svc.top_k_batch(rs, 5, prune=True)
    launches = dict(_build.launches)
    ps = svc.last_prune_stats
    assert launches["sddmm_spmm_type2_batch"] == ps["rerank_programs"]
    assert launches["sddmm_spmm_type1_batch"] == 10 * ps["rerank_programs"]
    assert launches["lc_rwmd_bound_batch"] == 1
    assert launches["rwmd_bound_batch"] == 1
    # one miss chunk (<= 128 rows) per lookup that missed
    assert launches["cdist"] == 1
    assert launches["cdist_kexp_rows"] == sum(
        1 for x in ps["kcache_misses"] if x)
    for other in (svc.top_k_scan_batch(rs, 5),
                  svc.top_k_batch(rs, 5, prune=True, rerank="union")):
        np.testing.assert_array_equal(other[0], idx)
        np.testing.assert_array_equal(other[1], d)
    lb = svc.query_batch_bounds(rs)
    full = svc.query_batch(rs)
    assert np.all(lb <= full * (1 + 1e-5) + 1e-6)
    np.testing.assert_array_equal(idx, svc._top_k(full, 5))


# -- slice 3: the per-query program's kernels (#1, #2, #5) -------------------

@pytest.mark.parametrize("shape", [(11, 320, 45, 16), (32, 1000, 70, 24),
                                   (40, 257, 9, 8), (128, 300, 33, 8)])
@pytest.mark.parametrize("docs_blk", [1, 7, 8, 64])
def test_single_query_kernels_match_plain(shape, docs_blk):
    dev = _card()
    from repro_torch.kernels import sddmm_spmm as sk
    v_r = shape[0]
    k, km, r, u, cols, vals = (torch.from_numpy(a).to(dev) for a in
                               _problem(5, 1, *shape, filler=0))
    k, km, r, u = k[0], km[0], r[0], u[0]
    x = sk.sddmm_spmm_type1(k, r, u, cols, vals, docs_blk=docs_blk)
    d = sk.sddmm_spmm_type2(k, km, u, cols, vals, docs_blk=docs_blk)
    x_ref = sk.sddmm_spmm_type1_plain(k, r, u, cols, vals)
    d_ref = sk.sddmm_spmm_type2_plain(k, km, u, cols, vals)
    torch.cuda.synchronize()
    # sums over v_r and nnz run in another order: fp32 reassociation
    torch.testing.assert_close(x, x_ref, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(d, d_ref, rtol=1e-4, atol=1e-6)
    assert x.shape == (v_r, shape[2]) and d.shape == (shape[2],)
    assert torch.all(x[v_r - 2:] == 0)     # pad query rows: exact zeros


def test_single_query_kernels_are_the_batched_ones_at_q1_bitwise():
    """#1 / #2 share #3 / #4's per-(query, doc) step: a query's output is
    the batched kernels' row for it, bit for bit, at any docs_blk."""
    dev = _card()
    from repro_torch.kernels import sddmm_spmm as sk
    k, km, r, u, cols, vals = (torch.from_numpy(a).to(dev) for a in
                               _problem(6, 4, 32, 500, 61, 16))
    xb = sk.sddmm_spmm_type1_batch(k, r, u, cols, vals)
    db = sk.sddmm_spmm_type2_batch(k, km, u, cols, vals)
    for q in range(4):
        for blk in (1, 8, 61):
            x = sk.sddmm_spmm_type1(k[q], r[q], u[q], cols, vals,
                                    docs_blk=blk)
            d = sk.sddmm_spmm_type2(k[q], km[q], u[q], cols, vals,
                                    docs_blk=blk)
            assert torch.equal(x, xb[q]) and torch.equal(d, db[q])


@pytest.mark.parametrize("m,v,w", [(32, 1000, 300), (19, 320, 24),
                                   (5, 77, 5), (70, 2049, 33)])
def test_cdist_kexp_kernel_matches_plain_and_the_row_kernel(m, v, w):
    dev = _card()
    from repro_torch.kernels import kexp
    rng = np.random.default_rng(11)
    b = torch.from_numpy(rng.normal(scale=1.3, size=(v, w))
                         .astype(np.float32)).to(dev)
    ids = torch.from_numpy(rng.choice(v, m, replace=False)).to(dev)
    a = b[ids].contiguous()
    k, km = kexp.cdist_kexp(a, b, lamb=1.0)
    k_rows, km_rows = kexp.cdist_kexp_rows(a, b, lamb=1.0)
    k_ref, km_ref = kexp.cdist_kexp_plain(a, b, lamb=1.0)
    torch.cuda.synchronize()
    # the same tile loop and epilogue on another tile: the same bits
    assert torch.equal(k, k_rows) and torch.equal(km, km_rows)
    # near the diagonal the plain spelling keeps the expansion's round-off
    m_ref = torch.where(k_ref > 0, km_ref / k_ref, 0.0)
    near = m_ref < 1.0
    assert torch.all((k - k_ref).abs()[near] <= 5e-2)
    torch.testing.assert_close(k[~near], k_ref[~near], rtol=1e-3, atol=0.0)
    torch.testing.assert_close(km[~near], km_ref[~near], rtol=1e-3,
                               atol=0.0)
    assert torch.all(k[torch.arange(m, device=dev), ids] == 1.0)


def test_chunked_driver_on_card_matches_monolithic():
    dev = _card()
    from repro_torch.core import formats
    from repro_torch.kernels import ops
    v, n, shards = 512, 70, 4
    k, _, r, u, cols, vals = _problem(7, 1, 24, v, n, 16, filler=0)
    c = np.zeros((v, n), np.float32)
    for j in range(n):
        live = vals[j] != 0
        c[cols[j][live], j] = vals[j][live]
    ell = formats.ell_from_dense(c)
    rb = formats.rebucket_for_vocab_shards(ell, shards)
    vloc = v // shards
    k_chunks = np.stack([np.pad(k[0][:, s * vloc:(s + 1) * vloc],
                                ((0, 0), (0, 1))) for s in range(shards)])
    to = lambda a: torch.from_numpy(a).to(dev)        # noqa: E731
    got = ops.sddmm_spmm_chunked(to(k_chunks), to(r[0]), to(u[0]),
                                 to(rb.cols), to(rb.vals))
    full = ops.sddmm_spmm_type1(to(k[0]), to(r[0]), to(u[0]),
                                to(ell.cols), to(ell.vals))
    torch.cuda.synchronize()
    torch.testing.assert_close(got, full, rtol=1e-4, atol=1e-6)


def test_service_query_is_the_batched_row_bitwise_and_counts_launches():
    dev = _card()
    from repro_torch.configs.sinkhorn_wmd import WMDConfig
    from repro_torch.data.corpus import make_corpus, zipf_query_stream
    from repro_torch.kernels import _build
    from repro_torch.serving import WMDService
    data = make_corpus(vocab_size=2048, embed_dim=32, num_docs=200,
                       num_queries=1, seed=12)
    cfg = WMDConfig(name="t", vocab_size=2048, embed_dim=32, num_docs=200,
                    nnz_max=data.ell.nnz_max, v_r=32, lamb=1.0, max_iter=10)
    stream = zipf_query_stream(vocab_size=2048, seed=13)
    rs = [next(stream) for _ in range(5)]
    svc = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell, device=dev,
                     cache_capacity=256)
    rows = svc.query_batch(rs)
    _build.reset_launches()
    single = np.stack([svc.query(r) for r in rs])
    launches = dict(_build.launches)
    # the vocab-major copies of each query's K and K.*M stripes, for its
    # 10 type1s and its type2
    assert launches == {"cdist_kexp": 5, "k_vocab_major": 10,
                        "sddmm_spmm_type1": 50, "sddmm_spmm_type2": 5}
    np.testing.assert_array_equal(single, rows)
    # a cache-less service: the transient stripes route gives the same bits
    off = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell, device=dev)
    for r, row in zip(rs, rows):
        np.testing.assert_array_equal(off.query(r), row)
        np.testing.assert_array_equal(
            off.query_batch([r], use_cache=False)[0], row)


# -- slice 4: the redesigned #3 (vocab-major) and #9 --------------------------

@pytest.mark.parametrize("v_r", [20, 32, 40, 128])
@pytest.mark.parametrize("q", [1, 3, 16])
@pytest.mark.parametrize("nnz", [16, 100])
def test_type1_vocab_major_is_the_single_query_kernel_bitwise(v_r, q, nnz):
    """#3 on the vocab-major copy == #1 on each query's reference-layout
    stripe, bitwise: the two tiles share the per-slot step. N = 45 is no
    multiple of the doc tile; nnz 100 spans four 32-slot stages; pad query
    rows, a filler query (Q > 1) and ELL pad slots are in the problem."""
    dev = _card()
    from repro_torch.kernels import sddmm_spmm as sk
    k, _, r, u, cols, vals = (torch.from_numpy(a).to(dev)
                              for a in _problem(20, q, v_r, 320, 45, nnz,
                                                filler=int(q > 1)))
    k_vm = sk.k_vocab_major(k)
    x = sk.sddmm_spmm_type1_batch_vm(k_vm, r, u, cols, vals)
    singles = [sk.sddmm_spmm_type1(k[i], r[i], u[i], cols, vals)
               for i in range(q)]
    torch.cuda.synchronize()
    assert torch.equal(k_vm, k.transpose(1, 2).contiguous())
    for i in range(q):
        assert torch.equal(x[i], singles[i])
    torch.testing.assert_close(
        x, sk.sddmm_spmm_type1_batch_plain(k, r, u, cols, vals), rtol=1e-4,
        atol=1e-6)
    assert torch.all(x[:, v_r - 2:] == 0)
    if q > 1:
        assert torch.all(x[q - 1] == 0)


def test_type1_vocab_major_bits_do_not_depend_on_docs_blk():
    dev = _card()
    from repro_torch.kernels import sddmm_spmm as sk
    k, _, r, u, cols, vals = (torch.from_numpy(a).to(dev)
                              for a in _problem(21, 3, 40, 500, 61, 40))
    k_vm = sk.k_vocab_major(k)
    xs = [sk.sddmm_spmm_type1_batch_vm(k_vm, r, u, cols, vals, docs_blk=b)
          for b in (1, 7, 8, 61, 300)]
    torch.cuda.synchronize()
    for x in xs[1:]:
        assert torch.equal(x, xs[0])


@pytest.mark.parametrize("q", [1, 3, 17, 33])
@pytest.mark.parametrize("nnz", [16, 144, 301])
def test_lc_kernel_is_the_rwmd_kernel_bitwise(q, nnz):
    """#9 (all queries a block, vocab-major minm) == #8, bitwise, past one
    query group (Q = 33 > 32), with pad slots, a filler query (the last, for
    Q > 1), an empty doc, nnz a multiple of 4 (16-byte staging) or not,
    nnz past one shared-memory stage, and several docs_blk."""
    dev = _card()
    from repro_torch.core.cascade import min_cost_vectors
    from repro_torch.kernels import lcrwmd, ops
    from repro_torch.kernels import rwmd as kr
    m, cols, vals = (torch.from_numpy(a).to(dev)
                     for a in _bound_problem(22, q, 32, 1000, 300, nnz,
                                             filler=q > 1))
    minm = min_cost_vectors(m)
    lb = kr.rwmd_bound_batch(m, cols, vals)
    lcs = [lcrwmd.lc_rwmd_bound_batch(minm, cols, vals, docs_blk=b)
           for b in (None, 1, 7, 256, 300)]
    torch.cuda.synchronize()
    for lc in lcs:
        assert torch.equal(lc, lb)
    plain = ops._finite(lcrwmd.lc_rwmd_bound_batch_plain(minm, cols, vals))
    torch.testing.assert_close(ops._finite(lcs[0]), plain, rtol=1e-5,
                               atol=1e-6)
    assert torch.all(ops._finite(lcs[0])[:, -1] == 0)


def test_service_copies_k_once_per_stripe_set_on_card():
    dev = _card()
    from repro_torch.configs.sinkhorn_wmd import WMDConfig
    from repro_torch.data.corpus import make_corpus, zipf_query_stream
    from repro_torch.kernels import _build
    from repro_torch.serving import WMDService
    data = make_corpus(vocab_size=2048, embed_dim=32, num_docs=300,
                       num_queries=1, seed=23)
    cfg = WMDConfig(name="t", vocab_size=2048, embed_dim=32, num_docs=300,
                    nnz_max=data.ell.nnz_max, v_r=32, lamb=1.0, max_iter=10)
    stream = zipf_query_stream(vocab_size=2048, seed=24)
    rs = [next(stream) for _ in range(5)]
    svc = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell, device=dev,
                     cache_capacity=256, mcache_capacity=256, prune_chunk=16)
    # a pair of copies (K and K.*M) per stripe set
    _build.reset_launches()
    full = svc.query_batch(rs)
    assert _build.launches["k_vocab_major"] == 2
    assert _build.launches["sddmm_spmm_type1_batch"] == 10
    assert _build.launches["sddmm_spmm_type2_batch"] == 1
    for rerank, sets in (("per_query", len(rs)), ("union", 1)):
        _build.reset_launches()
        idx, d = svc.top_k_batch(rs, 5, prune=True, rerank=rerank)
        programs = svc.last_prune_stats["rerank_programs"]
        assert _build.launches["k_vocab_major"] == 2 * sets
        assert _build.launches["sddmm_spmm_type1_batch"] == 10 * programs
        assert _build.launches["sddmm_spmm_type2_batch"] == programs
        np.testing.assert_array_equal(idx, svc._top_k(full, 5))
        np.testing.assert_array_equal(d, np.take_along_axis(full, idx, -1))


# -- slice 5: the redesigned #4 and #1 (vocab-major) --------------------------

def _with_empty_doc(arrs, v):
    """The problem with its last document all pad slots (col V, val 0)."""
    cols, vals = arrs[4], arrs[5]
    cols[-1] = v
    vals[-1] = 0.0
    return arrs


@pytest.mark.parametrize("v_r", [8, 32, 40, 96, 128])
@pytest.mark.parametrize("q", [1, 3, 16])
@pytest.mark.parametrize("nnz", [1, 33, 144])
def test_type2_vocab_major_is_the_single_query_kernel_bitwise(v_r, q, nnz):
    """#4 on the vocab-major copies == #2 on each query's reference-layout
    stripes, bitwise: the same per-slot step, the K.*M columns folded in
    slot order. N = 45 is no multiple of the doc tile; nnz 33 and 144 span
    two and five 32-slot stages; pad query rows, a filler query (Q > 1),
    ELL pad slots and an all-pad document (the last) are in the problem."""
    dev = _card()
    from repro_torch.kernels import sddmm_spmm as sk
    k, km, _, u, cols, vals = (torch.from_numpy(a).to(dev) for a in
                               _with_empty_doc(_problem(50, q, v_r, 320, 45,
                                                        nnz,
                                                        filler=int(q > 1)),
                                               320))
    k_vm, km_vm = sk.k_vocab_major(k), sk.k_vocab_major(km)
    d = sk.sddmm_spmm_type2_batch_vm(k_vm, km_vm, u, cols, vals)
    singles = [sk.sddmm_spmm_type2(k[i], km[i], u[i], cols, vals)
               for i in range(q)]
    torch.cuda.synchronize()
    for i in range(q):
        assert torch.equal(d[i], singles[i])
    # sums over v_r and nnz run in another order: fp32 reassociation
    torch.testing.assert_close(
        d, sk.sddmm_spmm_type2_batch_vm_plain(k_vm, km_vm, u, cols, vals),
        rtol=1e-4, atol=1e-6)
    assert torch.all(d[:, -1] == 0)          # the all-pad document
    if q > 1:
        assert torch.all(d[q - 1] == 0)      # the filler query


def test_type2_vocab_major_bits_do_not_depend_on_docs_blk():
    dev = _card()
    from repro_torch.kernels import sddmm_spmm as sk
    k, km, _, u, cols, vals = (torch.from_numpy(a).to(dev)
                               for a in _problem(51, 3, 40, 500, 61, 40))
    k_vm, km_vm = sk.k_vocab_major(k), sk.k_vocab_major(km)
    ds = [sk.sddmm_spmm_type2_batch_vm(k_vm, km_vm, u, cols, vals,
                                       docs_blk=b)
          for b in (1, 7, 8, 61, 300)]
    torch.cuda.synchronize()
    for d in ds[1:]:
        assert torch.equal(d, ds[0])


@pytest.mark.parametrize("v_r", [8, 32, 40, 96, 128])
@pytest.mark.parametrize("docs_blk", [1, 4, 8, 16, 61])
def test_type1_single_query_is_the_batched_kernel_at_q1_bitwise(v_r,
                                                                docs_blk):
    """#1 on one query's vocab-major copy == #3 at Q = 1, bitwise, at any
    doc tile; within the kernel tolerance of its plain version; pad query
    rows come out exact zeros; launches counted as #1's, not #3's."""
    dev = _card()
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import sddmm_spmm as sk
    k, _, r, u, cols, vals = (torch.from_numpy(a).to(dev) for a in
                              _problem(52, 1, v_r, 320, 61, 40, filler=0))
    k_vm = sk.k_vocab_major(k)
    _build.reset_launches()
    x = ops.sddmm_spmm_type1_vm(k_vm[0], r[0], u[0], cols, vals,
                                docs_blk=docs_blk)
    assert dict(_build.launches) == {"sddmm_spmm_type1": 1}
    xb = sk.sddmm_spmm_type1_batch_vm(k_vm, r, u, cols, vals)
    torch.cuda.synchronize()
    assert torch.equal(x, xb[0])
    torch.testing.assert_close(
        x, sk.sddmm_spmm_type1_vm_plain(k_vm[0], r[0], u[0], cols, vals),
        rtol=1e-4, atol=1e-6)
    assert torch.all(x[v_r - 2:] == 0)


# -- slice 6: the pipelined cost-row kernels (#5, #6, #7) --------------------

_VOCAB = {}


def _vocab(dev, v, w):
    """A seeded (v, w) vocabulary on the card; the last one made is kept
    (100,001 x 300 floats is 120 MB)."""
    if (v, w) not in _VOCAB:
        _VOCAB.clear()
        g = torch.Generator(device=dev).manual_seed(7919 * w + v)
        _VOCAB[(v, w)] = torch.randn((v, w), generator=g, device=dev) * 1.3
    return _VOCAB[(v, w)]


@pytest.mark.parametrize("w", [5, 300])
@pytest.mark.parametrize("v", [77, 1000, 100_001])
@pytest.mark.parametrize("m", [1, 13, 32, 127, 128, 129])
def test_cost_row_kernels_are_the_naive_oracle_bitwise(m, v, w):
    """#6, #5 and #7 against `cost_rows_naive` (one thread an output, the
    same fma chains and epilogue, no tiling): tiles, the cp.async
    zero-fill of the tail of w (w = 300 is 18 full steps of 16 and one of
    12; w = 5 takes the 4-byte copies), of rows past m and of the last
    column tile must change no bit."""
    dev = _card()
    from repro_torch.kernels import cdist, kexp
    b = _vocab(dev, v, w)
    ids = torch.from_numpy(np.random.default_rng(m).choice(
        v, m, replace=m > v)).to(dev)
    a = b[ids].contiguous()
    k_n, km_n = kexp.cost_rows_naive(a, b, epilogue="kexp", lamb=1.0)
    (m_n,) = kexp.cost_rows_naive(a, b, epilogue="dist")
    (d2_n,) = kexp.cost_rows_naive(a, b, epilogue="dist_squared")
    k6, km6 = kexp.cdist_kexp_rows(a, b, lamb=1.0)
    k5, km5 = kexp.cdist_kexp(a, b, lamb=1.0)
    m7 = cdist.cdist(a, b)
    d2_7 = cdist.cdist(a, b, squared=True)
    torch.cuda.synchronize()
    for name, got, want in (("#6 K", k6, k_n), ("#6 K.*M", km6, km_n),
                            ("#5 K", k5, k_n), ("#5 K.*M", km5, km_n),
                            ("#7 M", m7, m_n), ("#7 M^2", d2_7, d2_n)):
        assert torch.equal(got, want), name


def test_cost_row_kernels_own_word_is_exactly_zero():
    dev = _card()
    from repro_torch.kernels import cdist, kexp
    b = _vocab(dev, 100_001, 300)
    ids = torch.arange(5, 100_001, 781, device=dev)
    a = b[ids].contiguous()
    own = (torch.arange(ids.numel(), device=dev), ids)
    k6, km6 = kexp.cdist_kexp_rows(a, b, lamb=1.0)
    k5, km5 = kexp.cdist_kexp(a, b, lamb=1.0)
    m7 = cdist.cdist(a, b)
    d2_7 = cdist.cdist(a, b, squared=True)
    torch.cuda.synchronize()
    for k, km in ((k6, km6), (k5, km5)):
        assert torch.all(k[own] == 1.0) and torch.all(km[own] == 0.0)
    assert torch.all(m7[own] == 0.0) and torch.all(d2_7[own] == 0.0)


def test_cost_row_kernels_take_unaligned_rows_bitwise():
    """Rows that do not start 16-byte aligned take the 4-byte copies: the
    same bits as the 16-byte ones."""
    dev = _card()
    from repro_torch.kernels import cdist, kexp
    b = _vocab(dev, 1000, 300)
    m, w = 13, 300
    a = b[100:100 + m].contiguous()
    buf_a = torch.empty(m * w + 1, device=dev)
    buf_b = torch.empty(b.numel() + 1, device=dev)
    a_u = buf_a[1:].view(m, w)
    b_u = buf_b[1:].view(b.shape)
    a_u.copy_(a)
    b_u.copy_(b)
    assert a_u.data_ptr() % 16 and b_u.data_ptr() % 16
    for fn in (kexp.cdist_kexp_rows, kexp.cdist_kexp):
        got, want = fn(a_u, b_u, lamb=1.0), fn(a, b, lamb=1.0)
        assert all(torch.equal(g, x) for g, x in zip(got, want))
    assert torch.equal(cdist.cdist(a_u, b_u), cdist.cdist(a, b))


@pytest.mark.parametrize("kernel,rows", [("cdist_kexp_rows", 65535 * 128 + 1),
                                         ("cdist_kexp", 65535 * 32 + 1),
                                         ("cdist", 65535 * 128 + 1)])
def test_cost_row_kernels_raise_on_a_refused_launch(kernel, rows):
    """A grid the card refuses (more than 65,535 row tiles) raises from the
    wrapper, is not counted and falls back to nothing."""
    dev = _card()
    from repro_torch.kernels import _build, cdist, kexp
    a = torch.zeros((rows, 1), device=dev)
    b = torch.zeros((1, 1), device=dev)
    fn = {"cdist_kexp_rows": lambda: kexp.cdist_kexp_rows(a, b, lamb=1.0),
          "cdist_kexp": lambda: kexp.cdist_kexp(a, b, lamb=1.0),
          "cdist": lambda: cdist.cdist(a, b)}[kernel]
    _build.reset_launches()
    with pytest.raises(RuntimeError, match="failed to launch"):
        fn()
    assert _build.launches[kernel] == 0


def test_tiling_keywords_change_no_bits_on_card():
    """The reference's tiling keywords reach every entry point and change
    no bit of what the CUDA kernels return."""
    dev = _card()
    from repro_torch.kernels import cdist, kexp, lcrwmd, ops, rwmd, sddmm_spmm
    b = _vocab(dev, 1000, 300)
    a = b[:40].contiguous()
    pairs = [
        (ops.cdist_kexp(a, b, lamb=1.0),
         ops.cdist_kexp(a, b, lamb=1.0, v_tile=7)),
        (ops.cdist_kexp_rows(a, b, lamb=1.0),
         ops.cdist_kexp_rows(a, b, lamb=1.0, rows_blk=3, v_tile=64)),
        ((ops.cdist(a, b),), (ops.cdist(a, b, v_tile=128),)),
        (kexp.cdist_kexp(a, b, lamb=1.0),
         kexp.cdist_kexp(a, b, lamb=1.0, v_tile=256, interpret=True)),
        (kexp.cdist_kexp_rows(a, b, lamb=1.0),
         kexp.cdist_kexp_rows(a, b, lamb=1.0, rows_blk=16, v_tile=128,
                              interpret=True)),
        ((cdist.cdist(a, b),), (cdist.cdist(a, b, v_tile=64,
                                            interpret=True),)),
    ]
    k, km, r, u, cols, vals = (torch.from_numpy(x).to(dev)
                               for x in _problem(21, 3, 11, 320, 45, 16))
    m_pad = torch.where(k > 0, km, float("inf"))
    minm = m_pad.min(dim=1).values
    pairs += [
        ((ops.sddmm_spmm_type1_batch(k, r, u, cols, vals),),
         (ops.sddmm_spmm_type1_batch(k, r, u, cols, vals, q_blk=2),)),
        ((ops.sddmm_spmm_type2_batch(k, km, u, cols, vals),),
         (ops.sddmm_spmm_type2_batch(k, km, u, cols, vals, q_blk=4),)),
        ((ops.rwmd_bound_batch(m_pad, cols, vals),),
         (ops.rwmd_bound_batch(m_pad, cols, vals, q_blk=1),)),
        ((ops.lc_rwmd_bound_batch(minm, cols, vals),),
         (ops.lc_rwmd_bound_batch(minm, cols, vals, q_blk=8),)),
        ((sddmm_spmm.sddmm_spmm_type1_batch(k, r, u, cols, vals),),
         (sddmm_spmm.sddmm_spmm_type1_batch(k, r, u, cols, vals, q_blk=3,
                                            interpret=True),)),
        ((sddmm_spmm.sddmm_spmm_type2_batch(k, km, u, cols, vals),),
         (sddmm_spmm.sddmm_spmm_type2_batch(k, km, u, cols, vals, q_blk=3,
                                            interpret=True),)),
        ((sddmm_spmm.sddmm_spmm_type1(k[0], r[0], u[0], cols, vals),),
         (sddmm_spmm.sddmm_spmm_type1(k[0], r[0], u[0], cols, vals,
                                      interpret=True),)),
        ((sddmm_spmm.sddmm_spmm_type2(k[0], km[0], u[0], cols, vals),),
         (sddmm_spmm.sddmm_spmm_type2(k[0], km[0], u[0], cols, vals,
                                      interpret=True),)),
        ((rwmd.rwmd_bound_batch(m_pad, cols, vals),),
         (rwmd.rwmd_bound_batch(m_pad, cols, vals, q_blk=8,
                                interpret=True),)),
        ((lcrwmd.lc_rwmd_bound_batch(minm, cols, vals),),
         (lcrwmd.lc_rwmd_bound_batch(minm, cols, vals, q_blk=8,
                                     interpret=True),)),
    ]
    torch.cuda.synchronize()
    for i, (want, got) in enumerate(pairs):
        assert all(torch.equal(g, x) for g, x in zip(got, want)), i


# -- slice 7: #2 on vocab-major copies, #8's two routes ----------------------

@pytest.mark.parametrize("v_r", [8, 32, 40, 96, 128])
@pytest.mark.parametrize("nnz", [1, 33, 144])
def test_type2_single_query_is_the_oracle_and_the_batched_kernel(v_r, nnz):
    """#2 on one query's vocab-major copies == the reference-layout oracle
    `sddmm_spmm_type2_naive` == #4 at Q = 1, bitwise; the reference-layout
    entry (copies + #2) too. N = 61 is no multiple of the doc tile; nnz 33
    and 144 span two and five 32-slot stages; pad query rows, ELL pad
    slots and an all-pad document (the last) are in the problem."""
    dev = _card()
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import sddmm_spmm as sk
    k, km, _, u, cols, vals = (torch.from_numpy(a).to(dev) for a in
                               _with_empty_doc(_problem(70, 1, v_r, 320, 61,
                                                        nnz, filler=0),
                                               320))
    k_vm, km_vm = sk.k_vocab_major(k), sk.k_vocab_major(km)
    _build.reset_launches()
    d = ops.sddmm_spmm_type2_vm(k_vm[0], km_vm[0], u[0], cols, vals)
    assert dict(_build.launches) == {"sddmm_spmm_type2": 1}
    oracle = sk.sddmm_spmm_type2_naive(k[0], km[0], u[0], cols, vals)
    batched = sk.sddmm_spmm_type2_batch_vm(k_vm, km_vm, u, cols, vals)[0]
    ref_layout = sk.sddmm_spmm_type2(k[0], km[0], u[0], cols, vals)
    torch.cuda.synchronize()
    assert torch.equal(d, oracle) and torch.equal(d, batched)
    assert torch.equal(ref_layout, d)
    torch.testing.assert_close(
        d, sk.sddmm_spmm_type2_vm_plain(k_vm[0], km_vm[0], u[0], cols, vals),
        rtol=1e-4, atol=1e-6)
    assert d[-1] == 0 and torch.all(d[:-1] > 0)


def test_type2_single_query_bits_do_not_depend_on_docs_blk():
    dev = _card()
    from repro_torch.kernels import sddmm_spmm as sk
    k, km, _, u, cols, vals = (torch.from_numpy(a).to(dev)
                               for a in _problem(71, 1, 40, 500, 61, 40,
                                                 filler=0))
    k_vm, km_vm = sk.k_vocab_major(k)[0], sk.k_vocab_major(km)[0]
    ds = [sk.sddmm_spmm_type2_vm(k_vm, km_vm, u[0], cols, vals, docs_blk=b)
          for b in (1, 4, 7, 8, 16, 61, 300)]
    ds += [sk.sddmm_spmm_type2_naive(k[0], km[0], u[0], cols, vals,
                                     docs_blk=b) for b in (1, 8, 61)]
    torch.cuda.synchronize()
    for d in ds[1:]:
        assert torch.equal(d, ds[0])


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _route_problem(seed, q, v_r, v=1000, n=300, nnz=40):
    """M stripes with +inf pad query rows (one, where v_r > 1), an
    all-+inf filler query (the last, for Q > 1), a NaN in query 0's M on
    the column of document 0's first slot, ELL pad slots and empty
    documents (every 50th)."""
    rng = np.random.default_rng(seed)
    m = (rng.random((q, v_r, v + 1)) * 4).astype(np.float32)
    m[:, :, v] = 0.0
    if v_r > 1:
        m[:, v_r - 1] = np.inf
    if q > 1:
        m[q - 1] = np.inf
    cols = np.full((n, nnz), v, np.int32)
    vals = np.zeros((n, nnz), np.float32)
    for j in range(n):
        if j % 50 == 49:
            continue
        c = int(rng.integers(1, nnz + 1))
        cols[j, :c] = rng.choice(v, c, replace=False)
        vals[j, :c] = rng.random(c).astype(np.float32) + 0.05
    m[0, 0, cols[0, 0]] = np.nan
    return m, cols, vals


@pytest.mark.parametrize("v_r", [1, 31, 32, 33, 100, 128])
@pytest.mark.parametrize("q", [1, 3, 16, 17])
def test_rwmd_routes_are_the_lc_kernel_bitwise(v_r, q):
    """#8's dense route (column mins, then #9's walk) == its gather route
    == #9 on `min_cost_vectors`, bitwise, at several doc tiles; each call
    is one counted rwmd_bound_batch launch; the NaN reaches the documents
    that use its column on both routes (NaN wins the min, as in
    torch.amin); the empty documents score 0; the filler query is +inf,
    which ops finite-izes to 0."""
    dev = _card()
    from repro_torch.core.cascade import min_cost_vectors
    from repro_torch.kernels import _build, lcrwmd, ops
    from repro_torch.kernels import rwmd as kr
    m, cols, vals = (torch.from_numpy(a).to(dev)
                     for a in _route_problem(72 + v_r, q, v_r))
    lc = lcrwmd.lc_rwmd_bound_batch(min_cost_vectors(m), cols, vals)
    for blk in (1, 8, 61):
        for route in ("dense", "gather"):
            _build.reset_launches()
            lb = kr.rwmd_bound_batch_route(m, cols, vals, route,
                                           docs_blk=blk)
            assert dict(_build.launches) == {"rwmd_bound_batch": 1}
            torch.cuda.synchronize()
            assert _same_bits(lb, lc), (route, blk)
    lb = kr.rwmd_bound_batch(m, cols, vals)
    torch.cuda.synchronize()
    assert _same_bits(lb, lc)
    nan_docs = (cols == cols[0, 0]).any(dim=1) & (vals != 0).any(dim=1)
    assert torch.isnan(lb[0, nan_docs]).all()
    assert not torch.isnan(lb[1:]).any() and not torch.isnan(
        lb[0, ~nan_docs]).any()
    assert torch.all(lb[:, 49::50] == 0)
    if q > 1:
        assert torch.isinf(lb[q - 1, :49]).all()
    fin = ops.rwmd_bound_batch(m, cols, vals)
    plain = ops._finite(kr.rwmd_bound_batch_plain(m, cols, vals))
    torch.testing.assert_close(fin, plain, rtol=1e-5, atol=1e-6)


def test_column_min_is_torch_amin_bitwise():
    """The dense route's first pass: minm == torch.amin(M, 1), NaN and all,
    laid out vocab-major like `min_cost_vectors`."""
    dev = _card()
    from repro_torch.kernels import _build
    from repro_torch.kernels import rwmd as kr
    for q, v_r, v in ((1, 1, 77), (3, 33, 1000), (16, 32, 4097),
                      (17, 128, 301)):
        m = torch.from_numpy(_route_problem(73, q, v_r, v=v,
                                            n=2)[0]).to(dev)
        _build.reset_launches()
        minm = kr.column_min(m)
        assert dict(_build.launches) == {"column_min": 1}
        want = torch.amin(m, dim=1)
        torch.cuda.synchronize()
        assert minm.shape == want.shape and minm.T.is_contiguous()
        torch.testing.assert_close(minm, want, rtol=0, atol=0,
                                   equal_nan=True)
        assert torch.isnan(minm[0]).sum() == 1


# -- slice 8: the async serving front-end on the card -------------------------

def _async_stack(dev):
    from repro_torch.configs.sinkhorn_wmd import WMDConfig
    from repro_torch.data.corpus import make_corpus, zipf_query_stream
    from repro_torch.serving import WMDService
    data = make_corpus(vocab_size=2048, embed_dim=32, num_docs=300,
                       num_queries=1, seed=31)
    cfg = WMDConfig(name="t", vocab_size=2048, embed_dim=32, num_docs=300,
                    nnz_max=data.ell.nnz_max, v_r=32, lamb=1.0, max_iter=10)
    stream = zipf_query_stream(vocab_size=2048, seed=32)
    rs = [next(stream) for _ in range(12)]
    svc = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell, device=dev,
                     cache_capacity=256, mcache_capacity=256, prune_chunk=16)
    return svc, rs


def test_coalesced_query_batch_is_the_direct_call_bitwise_on_card():
    """Coalesced rows == the direct query_batch of each logged batch and
    == one direct call over all queries (on the card a row does not depend
    on its batch); the dispatches went through the kernels."""
    dev = _card()
    from repro_torch.kernels import _build
    svc, rs = _async_stack(dev)
    full = svc.query_batch(rs)
    _build.reset_launches()
    with svc.async_service(window_ms=10_000.0, max_batch=4) as co:
        futs = co.submit_many(rs)
        co.drain(timeout=120)
        rows = np.stack([f.result(timeout=120) for f in futs])
        top = [co.submit_top_k(r, 5) for r in rs[:4]]
        co.drain(timeout=120)
    launches = dict(_build.launches)
    np.testing.assert_array_equal(rows, full)
    for group in co.batch_log:
        if group[0] < len(rs):
            np.testing.assert_array_equal(
                rows[list(group)], svc.query_batch([rs[i] for i in group]))
    for i, f in enumerate(top):
        idx, d = f.result(timeout=120)
        np.testing.assert_array_equal(idx, svc._top_k(full[i], 5))
        np.testing.assert_array_equal(d, full[i][idx])
    assert launches["sddmm_spmm_type1_batch"] >= 10 * 3
    assert launches["lc_rwmd_bound_batch"] == launches["rwmd_bound_batch"] \
        == 1
    assert "sddmm_spmm_type2_naive" not in launches


def test_guarded_coalesced_run_has_zero_demotions_on_card():
    """The resilience guard in front of the kernels: a fault-free run is
    served by rung 0 only (no retry, no demotion, nothing degraded) and
    gives the unguarded bits."""
    dev = _card()
    from repro_torch.serving import EngineGuard
    svc, rs = _async_stack(dev)
    full = svc.query_batch(rs)
    guard = EngineGuard(svc)
    with svc.async_service(window_ms=2.0, max_batch=8,
                           resilience=guard) as co:
        futs = co.submit_many(rs) + [co.submit_top_k(r, 5) for r in rs]
        co.drain(timeout=120)
        st = co.stats()
    gs = guard.stats()
    assert (gs.retries, gs.demoted, gs.degraded, gs.failures) == (0, 0, 0, 0)
    assert st.degraded == 0 and st.completed == 2 * len(rs)
    assert all(rung == 0 for _, rung, _ in guard.dispatch_log)
    np.testing.assert_array_equal(
        np.stack([f.result() for f in futs[:len(rs)]]), full)
    for i, f in enumerate(futs[len(rs):]):
        idx, d = f.result()
        np.testing.assert_array_equal(idx, svc._top_k(full[i], 5))


def test_guard_on_card_never_reaches_a_plain_rung(monkeypatch):
    """A kernel that refuses to launch (rung 0 raising) and a watchdog trip
    on a CUDA service: the guard stays on the kernels. Every exact call
    keeps the service impl; past the kernel rungs the answer is the bound
    tier's, through its kernels, and counted as degraded."""
    dev = _card()
    from repro_torch.distributed.fault_tolerance import (FaultPolicy,
                                                         ServingWatchdog)
    from repro_torch.kernels import _build
    from repro_torch.serving import (DegradedResult, EngineGuard,
                                     ResiliencePolicy)
    from repro_torch.serving.faultinject import FaultSchedule, FaultyEngine
    svc, rs = _async_stack(dev)
    qs = rs[:4]
    want = svc.query_batch_bounds(qs)
    eng = FaultyEngine(svc, FaultSchedule())
    guard = EngineGuard(eng, ResiliencePolicy(max_retries=1,
                                              breaker_failures=2),
                        sleep=lambda s: None)
    assert set(guard.stats().breaker_states) == {"plain/0", "top_k/0",
                                                 "top_k/1"}
    real = _build.check_launch

    def refuse(name, err):
        if name == "sddmm_spmm_type1_batch":
            raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                               f"refused by the test")
        real(name, err)

    monkeypatch.setattr(_build, "check_launch", refuse)
    _build.reset_launches()
    plain = guard.dispatch("plain", qs)
    top = guard.dispatch("top_k", qs, k=5)
    launches = dict(_build.launches)
    monkeypatch.undo()
    assert isinstance(plain, DegradedResult)
    assert isinstance(top, DegradedResult)
    assert "failed to launch" in plain.reason
    np.testing.assert_array_equal(plain.value, want)
    assert "sddmm_spmm_type1_batch" not in launches
    assert launches.get("rwmd_bound_batch", 0) \
        + launches.get("column_min", 0) >= 2
    assert all(c.kwargs.get("impl") in (None, "kernel")
               for c in eng.dispatch_log)
    st = guard.stats()
    assert st.demoted == 0 and st.degraded == 2
    # a straggler trip opens the only plain rung: the bound tier answers
    guard = EngineGuard(eng, ResiliencePolicy(), sleep=lambda s: None)
    wd = ServingWatchdog(FaultPolicy(straggler_strikes=1),
                         on_strike=guard.trip)
    wd.beat("plain", 0.01, False)
    n = len(eng.dispatch_log)
    _build.reset_launches()
    res = guard.dispatch("plain", qs)
    assert isinstance(res, DegradedResult)
    np.testing.assert_array_equal(res.value, want)
    assert len(eng.dispatch_log) == n and sum(_build.launches.values()) >= 1
    assert guard.stats().demoted == 0


def _live_stack(dev, layout, tmp_path):
    """A live service and the static service over the same docs (the
    `_async_stack` corpus), the live one assembled as ``layout`` says:
    "two_segments" (docs 0-199 compacted into the base, 200-299 in the
    delta), "small_delta" (docs 0-279 in the base, 20 in a 32-row delta),
    "empty_base" (every doc in the delta, an 8-row all-pad base) or
    "wide_delta" (the shorter half compacted, the longer half in a delta
    whose nnz_max exceeds the base's)."""
    from repro_torch.core import formats
    from repro_torch.data import LiveCorpus
    from repro_torch.serving import WMDService
    svc, rs = _async_stack(dev)
    docs = formats.doc_lists_from_ell(svc.ell)
    lc = LiveCorpus(str(tmp_path / layout), svc.ell.num_vocab,
                    normalize=False)
    if layout == "empty_base":
        first = list(range(len(docs)))
    elif layout in ("two_segments", "small_delta"):
        first = list(range(200 if layout == "two_segments" else 280))
    else:
        lens = np.array([len(d) for d in docs])
        first = np.nonzero(lens <= np.median(lens))[0].tolist()
    lc.add_docs(first, [docs[i] for i in first])
    if layout != "empty_base":
        lc.compact()
        rest = sorted(set(range(len(docs))) - set(first))
        lc.add_docs(rest, [docs[i] for i in rest])
    if layout == "wide_delta":
        assert lc.delta_ell.nnz_max > lc.base_ell.nnz_max
    live = WMDService.from_live(None, svc.cfg, svc.vecs, lc, device=dev,
                                cache_capacity=256, mcache_capacity=256,
                                prune_chunk=16)
    return live, svc, rs


@pytest.mark.parametrize("layout", ["two_segments", "empty_base",
                                    "wide_delta"])
def test_live_query_batch_is_the_static_service_bitwise_on_card(layout,
                                                                 tmp_path):
    """Live rows (one program per non-empty segment, dead and pad rows
    solved but never gathered) and live pruned top-k are the static
    service's, bitwise, through the kernels: one pair of vocab-major
    copies per live query_batch, 10 #3 and one #4 per segment."""
    dev = _card()
    from repro_torch.kernels import _build
    live, svc, rs = _live_stack(dev, layout, tmp_path)
    want = svc.query_batch(rs)
    live.query_batch(rs[:2])                       # warms the K cache
    _build.reset_launches()
    got = live.query_batch(rs)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    segments = live.last_batch_stats["segments"]
    assert segments == (1 if layout == "empty_base" else 2)
    assert launches.get("k_vocab_major") == 2
    assert launches.get("sddmm_spmm_type1_batch") == 10 * segments
    assert launches.get("sddmm_spmm_type2_batch") == segments
    np.testing.assert_array_equal(got, want)
    for a, b in zip(live.top_k_batch(rs[:4], 5, prune=True),
                    svc.top_k_batch(rs[:4], 5)):
        np.testing.assert_array_equal(a, b)


def test_live_bounds_take_both_routes_and_equal_static_on_card(
        monkeypatch, tmp_path):
    """#8 picks its route from the shapes: the 512-row base takes the
    dense route, the 32-row delta the gather route, the static 300-doc
    corpus the dense one. Live bounds equal the static bounds bitwise
    (the contract #8 by either route == #9), and lie under the live
    distances."""
    dev = _card()
    from repro_torch.kernels import rwmd as krwmd
    live, svc, rs = _live_stack(dev, "small_delta", tmp_path)
    routes = []
    real = krwmd.rwmd_bound_batch_route

    def spy(m_pad, cols, vals, route, **kw):
        routes.append((cols.shape[0], route))
        return real(m_pad, cols, vals, route, **kw)

    monkeypatch.setattr(krwmd, "rwmd_bound_batch_route", spy)
    lb = live.query_batch_bounds(rs)
    assert routes == [(512, "dense"), (32, "gather")], routes
    monkeypatch.undo()
    np.testing.assert_array_equal(lb, svc.query_batch_bounds(rs))
    d = live.query_batch(rs)
    assert (lb <= d * (1 + 1e-5) + 1e-6).all()


# -- slice 10: the single-controller mesh, its shards on one card -----------

def _mesh_stack(dev):
    from repro_torch.configs.sinkhorn_wmd import WMDConfig
    from repro_torch.data.corpus import make_corpus, zipf_query_stream
    data = make_corpus(vocab_size=2048, embed_dim=64, num_docs=256,
                       num_queries=1, seed=11)
    cfg = WMDConfig(name="t", vocab_size=2048, embed_dim=64, num_docs=256,
                    nnz_max=data.ell.nnz_max, v_r=32, lamb=1.0, max_iter=10)
    stream = zipf_query_stream(vocab_size=2048, seed=12)
    return data, cfg, [next(stream) for _ in range(6)]


def test_mesh_kcache_rows_are_the_one_shard_rows_split_on_card():
    """At S = 2 each shard's #6 rows against its 1,024-word stripe are the
    S = 1 rows split at column 1,024, bitwise (each output column is one
    thread's fma chain whatever its tile); the launches are one a shard a
    128-row chunk."""
    dev = _card()
    from repro_torch.core.kcache import KCache
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh
    data, cfg, _ = _mesh_stack(dev)
    mesh = make_mesh((2, 2), ("data", "model"), devices=[dev] * 4)
    sel_b = np.arange(300).reshape(10, 30) * 6 % 2048
    mask_b = np.ones(sel_b.shape, np.float32)
    mask_b[:, -3:] = 0.0
    one = KCache(512, data.vecs, 1.0, device=dev)
    two = KCache(512, data.vecs, 1.0, mesh=mesh)
    k1, km1, info = one.stripes_for_batch(sel_b, mask_b)
    _build.reset_launches()
    k2, km2, _ = two.stripes_for_batch(sel_b, mask_b)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {
        "cdist_kexp_rows": 2 * -(-info["misses"] // 128)}
    for whole, parts in ((k1[0], k2), (km1[0], km2)):
        for s, part in enumerate(parts):
            assert part.device == mesh.device(0, s)
            assert torch.equal(part[..., :-1],
                               whole[..., s * 1024:(s + 1) * 1024])
            assert torch.all(part[..., -1] == 0)


def test_mesh_4x1_service_is_the_one_device_service_on_card():
    """Four doc shards on one card: rows, per-query rows, pruned top-k and
    bounds bitwise the one-device service's; the launches of a warm
    query_batch are 10 #3 and one #4 a doc shard and one pair of copies."""
    dev = _card()
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving import WMDService
    data, cfg, rs = _mesh_stack(dev)
    kw = dict(cache_capacity=512, mcache_capacity=512)
    one = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell, device=dev, **kw)
    mesh = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell, **kw,
                      mesh=make_mesh((4, 1), ("data", "model"),
                                     devices=[dev] * 4))
    want = one.query_batch(rs)
    mesh.query_batch(rs)                           # warms the K cache
    _build.reset_launches()
    got = mesh.query_batch(rs)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"sddmm_spmm_type1_batch": 40,
                                     "sddmm_spmm_type2_batch": 4,
                                     "k_vocab_major": 2}
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.stack([mesh.query(r) for r in rs]),
                                  want)
    for a, b in zip(mesh.top_k_batch(rs, 10, prune=True),
                    one.top_k_batch(rs, 10, prune=True)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mesh.query_batch_bounds(rs),
                                  one.query_batch_bounds(rs))


def test_mesh_2x2_service_on_card():
    """Two stripes, two doc shards on one card: cache on == off, pruned ==
    scan, query(r) == query_batch rows, bitwise; rows within the engine
    tolerance of the one-device service."""
    dev = _card()
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving import WMDService
    data, cfg, rs = _mesh_stack(dev)
    kw = dict(cache_capacity=512, mcache_capacity=512)
    one = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell, device=dev, **kw)
    svc = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell, **kw,
                     mesh=make_mesh((2, 2), ("data", "model"),
                                    devices=[dev] * 4))
    rows = svc.query_batch(rs)
    np.testing.assert_array_equal(rows, svc.query_batch(rs, use_cache=False))
    np.testing.assert_array_equal(rows, np.stack([svc.query(r) for r in rs]))
    for a, b in zip(svc.top_k_batch(rs, 10, prune=True),
                    svc.top_k_scan_batch(rs, 10)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(rows, one.query_batch(rs), rtol=2e-3,
                               atol=1e-5)


# -- the language model: chip_smoke.py phase 12's full-width checks -----------

def _lm_tokens(vocab, b=4, t=64):
    return np.random.default_rng(0).integers(0, vocab, (b, t)).astype(
        np.int32)


@pytest.mark.parametrize("router", ["topk", "sinkhorn"])
def test_lm_full_config_on_card_decodes_repeatably(router):
    """deepseek-moe-16b as published (16.4 B float32 parameters on the
    card): prefill 4 x 64 tokens, then 8 greedy decode steps twice from
    the same cache; finite logits, tokens in range, the two loops bitwise
    equal (the MoE combine has a fixed order)."""
    dev = _card()
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.lm import _tree_map
    from repro_torch.serving import build_serve_fns
    cfg = get_config("deepseek-moe-16b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           router=router))
    model = build_model(cfg, q_block=16, kv_block=16)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    try:
        prefill_for, decode_for = build_serve_fns(model, None, max_len=72)
        logits, cache = prefill_for(4)(params, {"tokens": _lm_tokens(
            cfg.vocab_size)})
        runs = []
        for _ in range(2):
            c = _tree_map(torch.clone, cache)
            tok = logits[:, -1].argmax(-1)[:, None]
            outs = []
            for _ in range(8):
                out, c = decode_for(4)(params, c, tok)
                tok = out[:, -1].argmax(-1)[:, None]
                outs.append(out)
            runs.append(torch.cat(outs, 1))
        assert torch.isfinite(runs[0].float()).all()
        assert torch.equal(runs[0], runs[1])
        assert 0 <= int(runs[0].argmax(-1).min()) and \
            int(runs[0].argmax(-1).max()) < cfg.vocab_size
    finally:
        del params
        gc.collect()
        torch.cuda.empty_cache()


@pytest.mark.parametrize("dtype,bound", [("bfloat16", 2e-2),
                                         ("float32", 1e-4)])
def test_lm_two_full_width_layers_card_matches_cpu(dtype, bound):
    """Layer 0 (dense) and one MoE layer of deepseek-moe-16b at full width,
    one numpy tree on the CPU and the card: prefill logits within ``bound``
    of the largest |logit|."""
    dev = _card()
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import build_model
    from repro_torch.models.lm import _tree_map
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), num_layers=2,
                              compute_dtype=dtype)
    tree = _tree_map(lambda x: x.numpy(),
                     build_model(cfg, device="cpu").init(1))
    batch = {"tokens": _lm_tokens(cfg.vocab_size)}
    want, _ = build_model(cfg, q_block=16, kv_block=16, device="cpu").prefill(
        lm_params_from_numpy(tree, device="cpu"), batch, max_len=64)
    got, _ = build_model(cfg, q_block=16, kv_block=16, device=dev).prefill(
        lm_params_from_numpy(tree, device=dev), batch, max_len=64)
    a, r = got.float().cpu().numpy(), want.float().numpy()
    assert np.abs(a - r).max() <= bound * np.abs(r).max()


# -- the remaining mixers: chip_smoke.py phase 13's checks at smoke size ------

MIXER_ARCHS = ("minicpm3-4b", "recurrentgemma-9b", "xlstm-125m",
               "whisper-small")


def _mixer_batch(cfg, b=2, t=16):
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(
        np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.normal(size=(
            b, cfg.encoder.num_positions, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", MIXER_ARCHS)
@pytest.mark.parametrize("dtype,bound", [("bfloat16", 2e-2),
                                         ("float32", 1e-4)])
def test_mixers_on_card_match_cpu(arch, dtype, bound):
    """One numpy tree on the CPU and the card: prefill logits, then 3
    decode steps from the CPU's cache, each within ``bound`` of the
    largest |logit| (whisper's decoder prefill runs in bfloat16 at either
    compute dtype, as the reference's: its prefill logits at 2e-2)."""
    dev = _card()
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import build_model
    from repro_torch.models.lm import _tree_map
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=dtype)
    tree = _tree_map(lambda x: x.numpy(),
                     build_model(cfg, device="cpu").init(1))
    p_cpu = lm_params_from_numpy(tree, device="cpu")
    p_gpu = lm_params_from_numpy(tree, device=dev)
    m_cpu = build_model(cfg, q_block=8, kv_block=8, device="cpu")
    m_gpu = build_model(cfg, q_block=8, kv_block=8, device=dev)
    batch = _mixer_batch(cfg)

    def rel(a, r):
        a, r = a.float().cpu().numpy(), r.float().numpy()
        return np.abs(a - r).max() / np.abs(r).max()

    l_cpu, c_cpu = m_cpu.prefill(p_cpu, batch, max_len=24)
    l_gpu, _ = m_gpu.prefill(p_gpu, batch, max_len=24)
    assert rel(l_gpu, l_cpu) <= (2e-2 if cfg.family == "audio" else bound)
    c_gpu = _tree_map(lambda x: x.to(dev), c_cpu)
    tok = l_cpu[:, -1].argmax(-1)[:, None]
    for _ in range(3):
        d_cpu, c_cpu = m_cpu.decode(p_cpu, c_cpu, tok)
        d_gpu, c_gpu = m_gpu.decode(p_gpu, c_gpu, tok.to(dev))
        assert rel(d_gpu, d_cpu) <= bound
        tok = d_cpu[:, -1].argmax(-1)[:, None]


@pytest.mark.parametrize("arch", MIXER_ARCHS)
def test_mixers_on_card_decode_repeatably(arch):
    """Two decode loops of 8 greedy steps from one cache, one donated and
    one not, are bitwise equal; the loop without donation leaves its cache
    as it was."""
    dev = _card()
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.models.lm import _leaves, _tree_map
    cfg = get_smoke_config(arch)
    model = build_model(cfg, q_block=8, kv_block=8, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    logits, cache = model.prefill(params, _mixer_batch(cfg), max_len=24)
    snap = _tree_map(torch.clone, cache)
    runs = []
    for donate, c in ((True, _tree_map(torch.clone, cache)), (False, cache)):
        tok = logits[:, -1].argmax(-1)[:, None]
        outs = []
        for _ in range(8):
            out, c = model.decode(params, c, tok, donate=donate)
            tok = out[:, -1].argmax(-1)[:, None]
            outs.append(out)
        runs.append(torch.cat(outs, 1))
    assert torch.isfinite(runs[0].float()).all()
    assert torch.equal(runs[0], runs[1])
    assert all(torch.equal(x, y) for x, y in zip(_leaves(cache),
                                                 _leaves(snap), strict=True))


# -- training: chip_smoke.py phase 14's checks at the smoke size ---------------

TRAIN_ARCHS = ("deepseek-moe-16b", "xlstm-125m", "whisper-small")


def _train_setup(arch, dev, *, router=None, dtype=None):
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, warmup_cosine
    cfg = get_smoke_config(arch)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    if router is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, router=router))
    model = build_model(cfg, q_block=16, kv_block=16, device=dev)
    opt = adamw(warmup_cosine(3e-4, warmup_steps=1, total_steps=10))
    return cfg, model, opt, TokenPipeline(cfg, batch=8, seq_len=32)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_on_card_matches_cpu(arch, monkeypatch):
    """One float32 train step from one numpy tree on the card and the CPU:
    loss and grad_norm within 1e-5 relative, the update criterion
    ||dp_card - dp_cpu|| / ||dp_cpu|| per leaf within 1e-2. Whisper's
    decoder runs in bfloat16 at any compute dtype (the reference's
    design); its embedding's default dtype (`embedding.mesh_embed`'s, the
    decoder's lookup) is lifted to float32 here, as
    `tests/test_torch_train_grads_mixers.py` does against JAX."""
    dev = _card()
    import functools

    from repro_torch import _tree
    from repro_torch.models.layers import embedding
    monkeypatch.setattr(embedding, "mesh_embed", functools.partial(
        embedding.mesh_embed, dtype=torch.float32))
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models.lm import _tree_map
    from repro_torch.train import TrainState, build_train_step
    cfg, m_gpu, opt, pipe = _train_setup(arch, dev, dtype="float32")
    _, m_cpu, _, _ = _train_setup(arch, "cpu", dtype="float32")
    tree = _tree_map(lambda x: x.numpy(), m_cpu.init(0))
    batch = pipe.batch_at(0)
    out = {}
    for d, model in (("cpu", m_cpu), (dev, m_gpu)):
        p = lm_params_from_numpy(tree, device=d)
        s, m = build_train_step(model, opt, None, donate=False)(
            TrainState(params=p, opt=opt.init(p), comp=None), batch)
        out[str(d)] = ([x.cpu().double() for x in _tree.leaves(s.params)],
                       float(m["loss"]), float(m["grad_norm"]))
    (pc, lc, nc), (pg, lg, ng) = out["cpu"], out[str(dev)]
    assert abs(lg - lc) <= 1e-5 * abs(lc) and abs(ng - nc) <= 1e-5 * nc
    p0 = [torch.from_numpy(x).double() for x in _tree.leaves(tree)]
    for a, b, c in zip(p0, pg, pc, strict=True):
        assert float(((b - a) - (c - a)).norm()) <= \
            1e-2 * max(float((c - a).norm()), 1e-30)


@pytest.mark.parametrize("router", ["topk", "sinkhorn"])
def test_two_train_steps_from_one_state_on_card_are_bitwise_equal(router):
    """deepseek-moe-16b's smoke config in bfloat16: the MoE dispatch reads
    each token top_k times and the Zipf batch repeats token 0 (the
    embedding's gradient sums its duplicates): two steps from one state
    through two build_train_step calls give the same bits."""
    dev = _card()
    from repro_torch import _tree
    from repro_torch.train import build_train_step, init_state
    cfg, model, opt, pipe = _train_setup("deepseek-moe-16b", dev,
                                         router=router)
    batch = pipe.batch_at(0)
    assert int((batch["tokens"] == 0).sum()) > 20
    state = init_state(model, opt, torch.Generator(device=dev).manual_seed(0))
    runs = [build_train_step(model, opt, None, donate=False)(state, batch)
            for _ in range(2)]
    for a, b in zip(_tree.leaves(runs[0]), _tree.leaves(runs[1]),
                    strict=True):
        assert torch.equal(a, b)
    assert torch.isfinite(runs[0][1]["loss"])


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_trainer_resume_on_card_is_bitwise(arch, tmp_path, monkeypatch):
    """8 steps checkpointed every 4 with a failure injected at step 6; a
    fresh Trainer resumes at step 4 and ends bitwise where an
    uninterrupted run ends."""
    dev = _card()
    monkeypatch.delenv("REPRO_FAILED_ONCE", raising=False)
    from repro_torch import _tree
    from repro_torch.launch.mesh import one_device_mesh
    from repro_torch.train import Trainer
    _, model, opt, pipe = _train_setup(arch, dev)
    mesh = one_device_mesh(dev)

    def trainer(d):
        return Trainer(model, opt, mesh, pipe, ckpt_dir=str(tmp_path / d),
                       ckpt_every=4, log_fn=lambda s: None)

    with pytest.raises(RuntimeError, match="injected"):
        trainer("a").run(0, 8, fail_at=6)
    out = trainer("a").run(0, 8)
    ref = trainer("b").run(0, 8)
    assert out["history"][0]["step"] == 4
    for a, b in zip(_tree.leaves(out["final_state"]),
                    _tree.leaves(ref["final_state"]), strict=True):
        assert a.device.type == "cuda" and torch.equal(a, b)


# -- the language-model mesh (logical shards of one card) ---------------------

def _card_mesh(dev, shape):
    from repro_torch.launch.mesh import make_mesh
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return make_mesh(shape, axes,
                     devices=[dev] * int(np.prod(shape)))


@pytest.mark.parametrize("arch,router", [("deepseek-moe-16b", "topk"),
                                         ("deepseek-moe-16b", "sinkhorn"),
                                         ("gemma-2b", None),
                                         ("olmo-1b", None)])
def test_lm_mesh_on_card_matches_one_device(arch, router):
    """Smoke configs in float32 on a (2, 2) mesh of logical shards of the
    card: prefill logits and a train step's loss, grad_norm and update
    against the one-device run (float32 tolerances)."""
    dev = _card()
    import dataclasses

    from repro_torch import _tree
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import partitioning
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.serving import build_serve_fns
    from repro_torch.train import build_train_step, init_state
    from repro_torch.train import state_shardings
    from repro_torch.train.step import place
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    if router:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, router=router))
    model = build_model(cfg, q_block=8, kv_block=8, device=dev)
    mesh = _card_mesh(dev, (2, 2))
    params = model.init(0)
    toks = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32)}
    one = build_serve_fns(model, None, max_len=20)[0](4)(params, toks)[0]
    got = build_serve_fns(model, mesh, max_len=20)[0](4)(params, toks)[0]
    torch.testing.assert_close(got, one, rtol=1e-4, atol=1e-5)
    opt = adamw(1e-3)
    batch = TokenPipeline(cfg, batch=8, seq_len=16).batch_at(0)
    state = init_state(model, opt, torch.Generator(device=dev).manual_seed(0))
    s1, m1 = build_train_step(model, opt, None, donate=False)(state, batch)
    sm, mm = build_train_step(model, opt, mesh, donate=False)(
        place(state, state_shardings(mesh, state)), batch)
    for k in ("loss", "grad_norm"):
        assert abs(float(mm[k]) - float(m1[k])) <= 1e-5 * abs(float(m1[k]))
    for a, b, c in zip(_tree.leaves(state.params),
                       _tree.leaves(partitioning.unshard(sm.params)),
                       _tree.leaves(s1.params), strict=True):
        da, dc = (b - a).double(), (c - a).double()
        assert float((da - dc).norm()) <= 1e-3 * max(float(dc.norm()), 1e-30)


@pytest.mark.parametrize("router", ["topk", "sinkhorn"])
def test_two_mesh_train_steps_on_card_are_bitwise_equal(router):
    """deepseek-moe-16b's smoke config in bfloat16 on a (2, 2) mesh of
    logical shards of the card: two steps from one placed state give the
    same bits (fixed-order folds, no float atomics)."""
    dev = _card()
    from repro_torch import _tree
    from repro_torch.distributed import partitioning
    from repro_torch.train import build_train_step, init_state
    from repro_torch.train import state_shardings
    from repro_torch.train.step import place
    cfg, model, opt, pipe = _train_setup("deepseek-moe-16b", dev,
                                         router=router)
    mesh = _card_mesh(dev, (2, 2))
    batch = pipe.batch_at(0)
    state = init_state(model, opt, torch.Generator(device=dev).manual_seed(0))
    placed = place(state, state_shardings(mesh, state))
    runs = [build_train_step(model, opt, mesh, donate=False)(placed, batch)
            for _ in range(2)]
    for a, b in zip(_tree.leaves(partitioning.unshard(runs[0])),
                    _tree.leaves(partitioning.unshard(runs[1])),
                    strict=True):
        assert torch.equal(a, b)
    assert torch.isfinite(runs[0][1]["loss"])
