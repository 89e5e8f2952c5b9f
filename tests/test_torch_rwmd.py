"""The port's bound-tier kernels and M rows on the CPU: `repro_torch.kernels.
ops.cdist`, `ops.rwmd_bound_batch` and `ops.lc_rwmd_bound_batch` (each
kernel's plain version for CPU tensors) against the JAX package's
`repro.kernels.ops` (Pallas, interpret mode) and the port's dense oracles
`repro_torch.kernels.ref`; `core.rwmd` against `repro.core.rwmd` on
identical M stripes; the port's `MCache` against the reference's.

Tolerances: bounds ``rtol=1e-5, atol=1e-6``, the reference's own
cross-spelling slack (tests/test_cascade_properties.py:47): the same fp32
math, slot sums in another order. cdist ``rtol=1e-4, atol=1e-5``: the
norms and the products are summed in another order, and the expansion
``|a|^2 + |b|^2 - 2ab`` cancels where two words are close, so entries near
0 (a row's own word) are held to an absolute bound instead: there each
spelling keeps its own round-off, of order sqrt(eps * |a|^2) in M.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rwmd as jrwmd
from repro.core.kcache import MCache as JMCache
from repro.kernels import ops as jops
from repro_torch.core import rwmd
from repro_torch.core.cascade import min_cost_vectors
from repro_torch.core.distributed import pad_query_batch
from repro_torch.core.kcache import MCache
from repro_torch.core.sinkhorn import select_query
from repro_torch.data.corpus import zipf_query_stream
from repro_torch.kernels import _build, cdist, lcrwmd, ops, ref
from repro_torch.kernels import rwmd as krwmd
from repro_torch.obs.metrics import MetricsRegistry

TOL_BOUND = dict(rtol=1e-5, atol=1e-6)
TOL_CDIST = dict(rtol=1e-4, atol=1e-5)


def _t(*arrs):
    return [torch.from_numpy(np.asarray(a)) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


def _bound_problem(seed, q=3, v_r=11, v=320, n=45, nnz=16, pad_rows=3):
    """M stripes with +inf pad query rows and one all-+inf filler query
    (the last), a zero pad column, ELL pad slots and one empty doc (the
    last)."""
    rng = np.random.default_rng(seed)
    m_pad = (rng.random((q + 1, v_r, v + 1)) * 4).astype(np.float32)
    m_pad[:, :, v] = 0.0
    m_pad[:, v_r - pad_rows:] = np.inf
    m_pad[q] = np.inf
    cols = np.full((n, nnz), v, np.int32)
    vals = np.zeros((n, nnz), np.float32)
    for j in range(n - 1):
        c = int(rng.integers(1, nnz - 2))
        cols[j, :c] = rng.choice(v, c, replace=False)
        vals[j, :c] = rng.random(c).astype(np.float32) + 0.05
    return m_pad, cols, vals


def _near_split(got, want, oracle_d2, *, squared):
    near = oracle_d2 < 1e-2                 # a row against its own word
    np.testing.assert_allclose(got[~near], want[~near], **TOL_CDIST)
    assert np.all(np.abs(got - want)[near] <= (1e-4 if squared else 1e-2))
    return int(near.sum())


@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("m,v,w", [(13, 320, 24), (1, 77, 5), (20, 129, 40)])
def test_cdist_three_way(m, v, w, squared):
    rng = np.random.default_rng(m + w)
    b = rng.normal(scale=1.3, size=(v, w)).astype(np.float32)
    a = b[rng.choice(v, m, replace=False)]
    a[0] += 0.5                                    # one off-vocab row
    got = ops.cdist(*_t(a, b), squared=squared).numpy()
    want = np.asarray(jops.cdist(*_j(a, b), squared=squared))
    oracle = ref.cdist(*_t(a, b), squared=squared).numpy()
    oracle_d2 = ref.cdist(*_t(a, b), squared=True).numpy()
    assert got.shape == (m, v) and got.dtype == np.float32
    assert np.all(got >= 0)
    _near_split(got, want, oracle_d2, squared=squared)
    near = _near_split(got, oracle, oracle_d2, squared=squared)
    assert near >= m - 1                          # the own-word entries


@pytest.mark.parametrize("seed", [0, 1])
def test_rwmd_and_lc_bounds_three_way(seed):
    m_pad, cols, vals = _bound_problem(seed)
    lb = ops.rwmd_bound_batch(*_t(m_pad, cols, vals)).numpy()
    want = np.asarray(jops.rwmd_bound_batch(*_j(m_pad, cols, vals)))
    oracle = ref.rwmd_bound_batch(*_t(m_pad, cols, vals)).numpy()
    np.testing.assert_allclose(lb, want, **TOL_BOUND)
    np.testing.assert_allclose(lb, oracle, **TOL_BOUND)
    minm = min_cost_vectors(torch.from_numpy(m_pad))
    lc = ops.lc_rwmd_bound_batch(minm, *_t(cols, vals)).numpy()
    want_lc = np.asarray(jops.lc_rwmd_bound_batch(
        *_j(minm.numpy(), cols, vals)))
    oracle_lc = ref.lc_rwmd_bound_batch(minm, *_t(cols, vals)).numpy()
    np.testing.assert_allclose(lc, want_lc, **TOL_BOUND)
    np.testing.assert_allclose(lc, oracle_lc, **TOL_BOUND)
    # the LC hoist is an identity: bitwise equal to the doc-side bound
    np.testing.assert_array_equal(lc, lb)
    # the filler query and the empty doc score exactly 0, nothing is NaN
    assert lb.shape == (4, 45) and np.isfinite(lb).all()
    assert np.all(lb[-1] == 0.0) and np.all(lb[:, -1] == 0.0)
    assert np.all(lb[:-1, :-1] > 0.0)


def test_bound_spellings_and_chunking_bitwise():
    m_pad, cols, vals = (torch.from_numpy(a) for a in _bound_problem(2))
    base = rwmd.rwmd_bound_batch(m_pad, cols, vals, impl="fused")
    for kw in ({"impl": "kernel"}, {"impl": "fused", "docs_chunk": 7},
               {"impl": "kernel", "docs_chunk": 16}):
        assert torch.equal(rwmd.rwmd_bound_batch(m_pad, cols, vals, **kw),
                           base)
    raw = krwmd.rwmd_bound_batch_plain(m_pad, cols, vals)
    # the filler query's raw bounds are +inf (0 on the empty doc): only
    # the ops wrapper finite-izes them
    assert torch.isinf(raw[-1, :-1]).all() and raw[-1, -1] == 0.0
    with pytest.raises(ValueError):
        rwmd.rwmd_bound_batch(m_pad, cols, vals, impl="pallas")


def _queries(seed, q, v_r, vocab=512):
    stream = zipf_query_stream(vocab_size=vocab, query_words=11, seed=seed)
    rs = [next(stream) for _ in range(q)]
    sels, rsels = zip(*[select_query(r) for r in rs])
    return pad_query_batch(sels, rsels, v_r)


def _vecs(v=512, w=16, seed=11):
    return np.random.default_rng(seed).normal(scale=1.3, size=(v, w)) \
        .astype(np.float32)


@pytest.mark.parametrize("impl", ["kernel", "jnp"])
def test_assemble_m_stripes_matches_reference(impl):
    vecs = _vecs()
    sel_b, _, mask_b = _queries(5, 3, 16)
    got = rwmd.assemble_m_stripes(sel_b, mask_b, torch.from_numpy(vecs),
                                  rows_bucket=8, impl=impl).numpy()
    want = np.asarray(jrwmd.assemble_m_stripes(sel_b, mask_b,
                                               jnp.asarray(vecs),
                                               rows_bucket=8))
    assert got.shape == want.shape == (3, 16, 513)
    pad = mask_b == 0
    assert np.all(np.isinf(got[pad])) and np.all(np.isinf(want[pad]))
    assert np.all(got[~pad][:, -1] == 0.0)        # the pad column
    real = got[~pad][:, :-1]
    oracle_d2 = np.stack([((vecs[i] - vecs) ** 2).sum(-1)
                          for i in sel_b[~pad]])
    _near_split(real, want[~pad][:, :-1], oracle_d2, squared=False)


def test_m_rows_are_the_k_rows_geometry():
    """The M rows of the bound (kernel spelling) are the M that the K-row
    compute exponentiates: K.*M == K * M, bitwise (on the CPU both run the
    plain matmul spelling; on the card both run one kernel's tile loop)."""
    vecs = torch.from_numpy(_vecs())
    ids = torch.arange(0, 40)
    m = rwmd._m_row_block(ids, vecs, torch.sum(vecs * vecs, -1))
    k, km = ops.cdist_kexp_rows(vecs[ids], vecs, lamb=1.0)
    assert torch.equal(km, k * m[:, :-1])


@pytest.mark.parametrize("seed", [3, 4])
def test_query_side_bound_matches_reference(seed):
    m_pad, cols, vals = _bound_problem(seed)
    r = (np.random.default_rng(seed).random(m_pad.shape[:2]) + 0.1) \
        .astype(np.float32)
    got = rwmd.rwmd_query_side_bound(*_t(m_pad, r, cols, vals)).numpy()
    want = np.asarray(jrwmd.rwmd_query_side_bound(*_j(m_pad, r, cols,
                                                      vals)))
    np.testing.assert_allclose(got, want, **TOL_BOUND)
    chunked = rwmd.rwmd_query_side_bound(*_t(m_pad, r, cols, vals),
                                         docs_chunk=7).numpy()
    np.testing.assert_array_equal(chunked, got)
    assert np.all(got[:, -1] == 0.0)               # the empty doc


def test_rwmd_lower_bound_composes():
    vecs = _vecs()
    sel_b, _, mask_b = _queries(6, 2, 16)
    rng = np.random.default_rng(6)
    cols = rng.integers(0, 512, (20, 8)).astype(np.int32)
    vals = rng.random((20, 8)).astype(np.float32)
    vt = torch.from_numpy(vecs)
    got = rwmd.rwmd_lower_bound(sel_b, mask_b, *_t(cols, vals), vt,
                                rows_bucket=8)
    m_pad = rwmd.assemble_m_stripes(sel_b, mask_b, vt, rows_bucket=8)
    assert torch.equal(got, rwmd.rwmd_bound_batch(m_pad, *_t(cols, vals)))


def _stats(s):
    return (s.lookups, s.hit_rows, s.miss_rows, s.evictions, s.bypasses,
            s.invalidations)


@pytest.mark.parametrize("capacity", [40, 64, 0])
def test_mcache_bookkeeping_matches_reference(capacity):
    vecs = _vecs()
    tc = MCache(capacity, vecs, device="cpu", rows_bucket=16)
    jc = JMCache(capacity, jnp.asarray(vecs), rows_bucket=16)
    for seed in range(8):
        sel_b, _, mask_b = _queries(seed, 3, 24)
        _, info = tc.m_stripes_for_batch(sel_b, mask_b)
        _, jinfo = jc.m_stripes_for_batch(sel_b, mask_b)
        assert info == jinfo
        assert _stats(tc.stats) == _stats(jc.stats)
        assert tc.resident == jc.resident
    sel_b, _, mask_b = _queries(9, 2, 24)
    _, info = tc.m_stripes_for_batch(sel_b, mask_b, use_cache=False)
    _, jinfo = jc.m_stripes_for_batch(sel_b, mask_b, use_cache=False)
    assert info == jinfo and _stats(tc.stats) == _stats(jc.stats)
    ids = np.unique(sel_b)[:5]
    assert tc.invalidate_ids(ids) == jc.invalidate_ids(ids)
    assert _stats(tc.stats) == _stats(jc.stats)


@pytest.mark.parametrize("kexp_impl", ["kernel", "jnp"])
def test_mcache_on_off_bitwise_through_evictions(kexp_impl):
    vecs = _vecs(v=96, w=8, seed=43)
    rng = np.random.default_rng(43)
    mc = MCache(12, vecs, device="cpu", rows_bucket=4, kexp_impl=kexp_impl)
    oracle = MCache(0, vecs, device="cpu", rows_bucket=4,
                    kexp_impl=kexp_impl)
    seen = set()
    for step in range(15):
        q, v_r = int(rng.integers(1, 4)), 5
        sel = np.zeros((q, v_r), np.int32)
        mask = np.zeros((q, v_r), np.float32)
        for i in range(q):
            k = int(rng.integers(1, v_r + 1))
            sel[i, :k] = rng.choice(96, k, replace=False)
            mask[i, :k] = 1.0
        seen.update(np.unique(sel).tolist())
        got, _ = mc.m_stripes_for_batch(sel, mask)
        want, _ = oracle.m_stripes_for_batch(sel, mask)
        assert torch.equal(got, want), f"step {step}"
        assert torch.equal(mc.m_stripes_for_batch(sel, mask,
                                                  use_cache=False)[0], want)
    assert len(seen) > mc.capacity and mc.stats.evictions > 0
    assert mc.stats.hit_rows > 0 and mc.resident <= mc.capacity


def test_mcache_metrics_mirror_and_bad_impl():
    reg = MetricsRegistry()
    c = MCache(32, _vecs(), device="cpu", rows_bucket=16, metrics=reg)
    for seed in range(3):
        sel_b, _, mask_b = _queries(seed, 3, 24)
        c.m_stripes_for_batch(sel_b, mask_b)
    got = {name: reg.counter(f"wmd_mcache_{name}_total").value
           for name in ("lookups", "hit_rows", "miss_rows", "evictions")}
    assert got == {"lookups": c.stats.lookups, "hit_rows": c.stats.hit_rows,
                   "miss_rows": c.stats.miss_rows,
                   "evictions": c.stats.evictions}
    assert reg.gauge("wmd_mcache_resident_rows").value == c.resident
    with pytest.raises(ValueError):
        MCache(4, _vecs(), device="cpu", kexp_impl="pallas")


def test_cuda_wrappers_refuse_cpu_tensors_and_count_nothing():
    """The CUDA entry points launch or raise: a CPU tensor is refused and
    no launch is counted (nothing falls back to the plain version)."""
    m_pad, cols, vals = _t(*_bound_problem(5))
    _build.reset_launches()
    with pytest.raises(ValueError):
        cdist.cdist(torch.ones(2, 3), torch.ones(4, 3))
    with pytest.raises(ValueError):
        krwmd.rwmd_bound_batch(m_pad, cols, vals)
    with pytest.raises(ValueError):
        lcrwmd.lc_rwmd_bound_batch(m_pad[:, 0], cols, vals)
    assert sum(_build.launches.values()) == 0
    a, b = torch.ones(3, 4), torch.zeros(5, 4)
    assert torch.equal(ops.cdist(a, b), cdist.cdist_plain(a, b))
    assert torch.equal(ops.cdist(a, b, squared=True),
                       cdist.cdist_plain(a, b, squared=True))
