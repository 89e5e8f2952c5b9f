"""The port's K cache: bookkeeping identical to the JAX package's `KCache`
over a seeded Zipf stream, and the exactness contracts inside the port
(cache on == off == transient, hits == misses, evictions == off), bitwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.kcache import KCache as JKCache
from repro_torch.core.distributed import pad_query_batch
from repro_torch.core.kcache import KCache
from repro_torch.core.sinkhorn import select_query
from repro_torch.data.corpus import zipf_query_stream
from repro_torch.obs.metrics import MetricsRegistry

V, W, V_R = 512, 16, 24


def _vecs():
    return np.random.default_rng(11).normal(scale=1.3, size=(V, W)) \
        .astype(np.float32)


def _batches(n_batches, q, seed=3):
    stream = zipf_query_stream(vocab_size=V, seed=seed)
    out = []
    for _ in range(n_batches):
        rs = [next(stream) for _ in range(q)]
        sels, rsels = zip(*[select_query(r) for r in rs])
        sel_b, _, mask_b = pad_query_batch(sels, rsels, V_R)
        out.append((sel_b, mask_b))
    return out


def _stats(s):
    return (s.lookups, s.hit_rows, s.miss_rows, s.evictions, s.bypasses,
            s.invalidations)


@pytest.mark.parametrize("capacity,kexp_impl", [(40, "kernel"), (40, "jnp"),
                                                (64, "kernel"), (0, "kernel")])
def test_bookkeeping_matches_reference(capacity, kexp_impl):
    vecs = _vecs()
    tc = KCache(capacity, vecs, 1.0, device="cpu", rows_bucket=16,
                kexp_impl=kexp_impl)
    jc = JKCache(capacity, jnp.asarray(vecs), 1.0, rows_bucket=16)
    for sel_b, mask_b in _batches(8, 3):
        *_, info = tc.stripes_for_batch(sel_b, mask_b)
        *_, jinfo = jc.stripes_for_batch(sel_b, mask_b)
        assert info == jinfo
        assert _stats(tc.stats) == _stats(jc.stats)
        assert tc.resident == jc.resident
        assert tc.stats.hit_rate == jc.stats.hit_rate
    sel_b, mask_b = _batches(1, 2, seed=9)[0]
    *_, info = tc.stripes_for_batch(sel_b, mask_b, use_cache=False)
    *_, jinfo = jc.stripes_for_batch(sel_b, mask_b, use_cache=False)
    assert info == jinfo and _stats(tc.stats) == _stats(jc.stats)
    ids = np.unique(sel_b)[:5]
    assert tc.invalidate_ids(ids) == jc.invalidate_ids(ids)
    tc.ensure_lamb(2.0)
    jc.ensure_lamb(2.0)
    assert _stats(tc.stats) == _stats(jc.stats) and tc.resident == 0


def test_stripes_match_reference():
    vecs = _vecs()
    sel_b, mask_b = _batches(1, 3)[0]
    k_s, km_s, _ = KCache(64, vecs, 1.0, device="cpu",
                          rows_bucket=16).stripes_for_batch(sel_b, mask_b)
    # the port's list of the shards' stripes, stacked: the reference's
    # (S, Q, v_r, V+1) layout
    k_s, km_s = torch.stack(k_s), torch.stack(km_s)
    jk, jkm, _ = JKCache(64, jnp.asarray(vecs), 1.0,
                         rows_bucket=16).stripes_for_batch(sel_b, mask_b)
    assert k_s.shape == jk.shape == (1, 3, V_R, V + 1)
    # a word's row against its own column: |a|^2 + |b|^2 - 2ab cancels to
    # round-off, M(i, i) comes out ~1e-3 instead of 0 in either package
    # with different rounding, so K there gets an absolute bound
    near = np.asarray(jk) > np.exp(-1.0)
    for got, want in ((k_s, jk), (km_s, jkm)):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_allclose(got[~near], want[~near], rtol=1e-4,
                                   atol=1e-6)
        assert np.all(np.abs(got - want)[near] <= 5e-2)
    # pad query rows and the pad column are exact zeros
    pad = mask_b == 0
    assert torch.all(k_s[0][torch.from_numpy(pad)] == 0)
    assert torch.all(k_s[..., -1] == 0) and torch.all(km_s[..., -1] == 0)


@pytest.mark.parametrize("kexp_impl", ["kernel", "jnp"])
def test_cache_on_off_transient_hits_evictions_bitwise(kexp_impl):
    vecs = _vecs()
    batches = _batches(5, 3)
    off = KCache(0, vecs, 1.0, device="cpu", rows_bucket=16,
                 kexp_impl=kexp_impl)
    on = KCache(256, vecs, 1.0, device="cpu", rows_bucket=16,
                kexp_impl=kexp_impl)
    # fits one batch (<= 57 unique ids) but not the stream: evicts
    small = KCache(60, vecs, 1.0, device="cpu", rows_bucket=16,
                   kexp_impl=kexp_impl)
    for sel_b, mask_b in batches:
        k0, km0, _ = off.stripes_for_batch(sel_b, mask_b)
        k1, km1, i1 = on.stripes_for_batch(sel_b, mask_b)
        k2, km2, i2 = on.stripes_for_batch(sel_b, mask_b)        # all hits
        k3, km3, _ = on.stripes_for_batch(sel_b, mask_b, use_cache=False)
        k4, km4, _ = small.stripes_for_batch(sel_b, mask_b)
        assert i2["hits"] == i2["unique"] and i2["misses"] == 0
        for k, km in ((k1, km1), (k2, km2), (k3, km3), (k4, km4)):
            assert len(k) == len(k0) == 1
            assert torch.equal(k[0], k0[0]) and torch.equal(km[0], km0[0])
    assert small.stats.evictions > 0 and small.stats.bypasses == 0


def test_metrics_mirror_the_stats():
    reg = MetricsRegistry()
    c = KCache(32, _vecs(), 1.0, device="cpu", rows_bucket=16, metrics=reg)
    for sel_b, mask_b in _batches(3, 3):
        c.stripes_for_batch(sel_b, mask_b)
    got = {name: reg.counter(f"wmd_kcache_{name}_total").value
           for name in ("lookups", "hit_rows", "miss_rows", "evictions")}
    assert got == {"lookups": c.stats.lookups, "hit_rows": c.stats.hit_rows,
                   "miss_rows": c.stats.miss_rows,
                   "evictions": c.stats.evictions}
    assert reg.gauge("wmd_kcache_resident_rows").value == c.resident


def test_bad_kexp_impl_rejected():
    with pytest.raises(ValueError):
        KCache(4, _vecs(), 1.0, device="cpu", kexp_impl="pallas")
