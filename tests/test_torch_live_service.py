"""The port's live service (`WMDService.from_live` over
`repro_torch.data.LiveCorpus`, on the CPU) against the reference's live
service and against its own static service.

The golden table's live routes (`tests/test_golden.py`) run in both
packages on the golden corpus: a one-shot seeding (every doc in the delta
over an empty base), an incremental history (shuffled adds, a wrong doc
corrected by upsert, an extraneous doc added and removed, a compaction)
and a crash-recovered one (killed inside a compaction, reopened, finished,
compacted). In the port:

* ``live_oneshot`` == ``live_incremental`` == ``live_recovered`` == the
  static service's `query_batch`, bitwise; live pruned top-k == the live
  scan, bitwise; each route within ``rtol=2e-3, atol=1e-5`` of the live
  JAX route with equal top-k ids;
* live bounds are the static service's bounds, bitwise, and bounds;
* K-cache rows survive add / remove / compact and still hit; the union
  rerank on a live service falls back to the full scan and counts it;
* one pair of vocab-major copies (two `ops.k_vocab_major` calls) per live
  `query_batch`, whatever the number of segments;
* a compaction moves every piece of device state derived from the base
  (the rerank blocks' ELL included); segments of unusual shape (an empty
  base, a delta wider than the base) answer like the static service.
"""
import functools
import tempfile

import numpy as np
import pytest

from repro_torch.configs.sinkhorn_wmd import WMDConfig
from repro_torch.core import formats as tf
from repro_torch.data import LiveCorpus
from repro_torch.kernels import ops
from repro_torch.serving import WMDService
from repro_torch.serving.faultinject import CrashInjector, InjectedCrash
from test_torch_service import (TOL, TOP_K, _cfg, _corpus, _shares_word,
                                _svc)

SVC_KW = dict(cache_capacity=64, prune_chunk=8, bound_docs_chunk=None)


def _histories(pkg):
    """The golden table's three live histories through one package:
    (oneshot, incremental, recovered) services, the recovered one with a
    delta doc 999 added after its compaction for the pruned routes."""
    if pkg == "jax":
        from repro.configs.sinkhorn_wmd import WMDConfig as Cfg
        from repro.data.live_corpus import LiveCorpus as LC
        from repro.launch.mesh import make_mesh
        from repro.serving import WMDService as Svc
        from repro.serving.faultinject import CrashInjector as Inj
        from repro.serving.faultinject import InjectedCrash as Crash
        mesh = make_mesh((1, 1), ("data", "model"))

        def live_service(lc):
            return Svc.from_live(mesh, _cfg(Cfg), _corpus()[0], lc, **SVC_KW)
    else:
        LC, Inj, Crash = LiveCorpus, CrashInjector, InjectedCrash

        def live_service(lc):
            return WMDService.from_live(None, _cfg(WMDConfig), _corpus()[0],
                                        lc, device="cpu", **SVC_KW)
    vecs, ell, rs = _corpus()
    docs, v = tf.doc_lists_from_ell(ell), vecs.shape[0]

    def fresh(**kw):
        return LC(tempfile.mkdtemp(prefix=f"live-{pkg}-"), v,
                  normalize=False, **kw)

    lc1 = fresh()
    lc1.add_docs(range(len(docs)), docs)
    order = list(range(len(docs)))
    np.random.default_rng(7).shuffle(order)
    lc2 = fresh()
    lc2.add_docs([order[0]], [[(0, 1.0)]])          # wrong content first
    for i in order[: len(order) // 2]:
        lc2.add_docs([i], [docs[i]])                # (order[0] corrected)
    lc2.add_docs([999], [docs[0]])                  # extraneous doc ...
    lc2.compact()
    lc2.remove_docs([999])                          # ... tombstoned again
    for i in order[len(order) // 2:]:
        lc2.add_docs([i], [docs[i]])
    hook = Inj()
    lc3 = fresh(crash_hook=hook)
    for i in order[:16]:
        lc3.add_docs([i], [docs[i]])
    hook.target = hook.count + 2                    # compact.snapshot.tmp
    with pytest.raises(Crash):
        lc3.compact()
    lc3 = LC(lc3.path, v, normalize=False)          # recover from disk
    for i in order[16:]:
        lc3.add_docs([i], [docs[i]])
    lc3.add_docs([order[0]], [docs[order[0]]])      # upsert to the delta
    lc3.compact()
    return [live_service(lc) for lc in (lc1, lc2, lc3)]


@functools.lru_cache(maxsize=2)
def _routes(pkg):
    rs = _corpus()[2]
    one, inc, rec = _histories(pkg)
    out = {"live_oneshot": one.query_batch(rs),
           "live_incremental": inc.query_batch(rs),
           "live_recovered": rec.query_batch(rs)}
    rec.add_docs([999], [tf.doc_lists_from_ell(_corpus()[1])[1]])
    out["live_pruned"] = rec.top_k_batch(rs, TOP_K, prune=True)
    out["live_pruned_stats"] = dict(rec.last_prune_stats)
    out["live_scan"] = rec.top_k_scan_batch(rs, TOP_K)
    out["live_topk"] = rec.top_k_batch(rs, TOP_K)
    out["live_rows"] = rec.query_batch(rs)
    out["live_bounds"] = rec.query_batch_bounds(rs)
    out["live_ids"] = rec.live_doc_ids
    return out


def _live(path_docs=None, **kw):
    """A port live service over the golden docs, all in the delta."""
    vecs, ell, _ = _corpus()
    docs = tf.doc_lists_from_ell(ell) if path_docs is None else path_docs
    lc = LiveCorpus(tempfile.mkdtemp(prefix="live-port-"), vecs.shape[0],
                    normalize=False)
    lc.add_docs(range(len(docs)), docs)
    return WMDService.from_live(None, _cfg(WMDConfig), vecs, lc,
                                device="cpu", **{**SVC_KW, **kw})


def test_live_histories_are_bitwise_the_static_service():
    rs = _corpus()[2]
    want = _svc(**SVC_KW).query_batch(rs)
    got = _routes("torch")
    for route in ("live_oneshot", "live_incremental", "live_recovered"):
        np.testing.assert_array_equal(got[route], want, err_msg=route)


def test_live_pruned_equals_live_scan_bitwise():
    got = _routes("torch")
    for a, b in zip(got["live_pruned"], got["live_scan"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got["live_pruned"], got["live_topk"]):
        np.testing.assert_array_equal(a, b)
    ps = got["live_pruned_stats"]
    assert ps["rerank"] == "live_pruned" and ps["delta_docs"] == 1
    assert ps["exact_solves"] < ps["scan_solves"]
    assert got["live_ids"].tolist() == list(range(24)) + [999]


@pytest.mark.parametrize("route", ["live_oneshot", "live_incremental",
                                   "live_recovered", "live_rows",
                                   "live_pruned", "live_scan", "live_topk"])
def test_live_routes_match_live_jax(route):
    got, want = _routes("torch")[route], _routes("jax")[route]
    if isinstance(got, tuple):                     # (ids, distances)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], **TOL)
    else:
        np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(_routes("torch")["live_ids"],
                                  _routes("jax")["live_ids"])


def test_live_bounds_are_static_bounds_and_bounds():
    """The live bounds (one min-SDDMM per segment) are the static
    service's bounds over the same docs, bitwise, lie under the live
    distances, and match the reference's live bounds as the static bounds
    do (`test_torch_service.test_query_batch_bounds_match_live_jax`)."""
    vecs, ell, rs = _corpus()
    got = _routes("torch")
    lb, d = got["live_bounds"], got["live_rows"]
    doc999 = tf.doc_lists_from_ell(ell)[1]
    ell25 = tf.ell_from_doc_lists(tf.doc_lists_from_ell(ell) + [doc999],
                                  vecs.shape[0], normalize=False)
    static = WMDService(cfg=_cfg(WMDConfig), vecs=vecs, ell=ell25,
                        device="cpu", **SVC_KW)
    np.testing.assert_array_equal(lb, static.query_batch_bounds(rs))
    np.testing.assert_array_equal(d, static.query_batch(rs))
    assert (lb <= d * (1 + 1e-5) + 1e-6).all()
    want = _routes("jax")["live_bounds"]
    share = _shares_word(rs, ell25)
    np.testing.assert_allclose(lb[~share], want[~share], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(lb[share], want[share], rtol=0, atol=1e-3)
    idx, dist = static.top_k_batch_bounds(rs, TOP_K)
    ids = got["live_ids"]
    np.testing.assert_array_equal(ids[idx], _bounds_topk_ids())
    np.testing.assert_array_equal(dist, np.take_along_axis(lb, idx, -1))


@functools.lru_cache(maxsize=1)
def _bounds_topk_ids():
    vecs, ell, rs = _corpus()
    svc = _live()
    svc.add_docs([999], [tf.doc_lists_from_ell(ell)[1]])
    return svc.top_k_batch_bounds(rs, TOP_K)[0]


def test_kcache_rows_survive_mutation_and_still_hit():
    """A K row is a function of (word id, lambda, vecs): add, remove and
    compact invalidate nothing, and the next batch hits every row."""
    vecs, ell, rs = _corpus()
    svc = _live()
    first = svc.query_batch(rs)
    resident = svc.cache_resident
    assert resident > 0
    svc.add_docs([80], [[(3, 1.0)]])
    svc.remove_docs([0])
    svc.compact()
    assert svc.cache_resident == resident
    again = svc.query_batch(rs)
    assert svc.last_batch_stats["misses"] == 0
    assert svc.last_batch_stats["hit_rate"] == 1.0
    # doc 0 gone, doc 80 (one word) appended: the other columns keep bits
    np.testing.assert_array_equal(again[:, :23], first[:, 1:])
    assert svc.invalidate_embedding_rows([int(np.flatnonzero(rs[0])[0])]) \
        >= 1


def test_union_rerank_on_live_falls_back_and_counts():
    rs = _corpus()[2]
    svc = _live()
    counter = svc.metrics.counter("wmd_prune_fallback_total")
    assert counter.value == 0
    idx, dist = svc.top_k_batch(rs, TOP_K, prune=True, rerank="union")
    assert counter.value == 1
    assert svc.last_prune_stats["rerank"] == "live_full_scan"
    want = svc.top_k_scan_batch(rs, TOP_K)
    np.testing.assert_array_equal(idx, want[0])
    np.testing.assert_array_equal(dist, want[1])
    assert counter.value == 1


@pytest.mark.parametrize("compact", [False, True],
                         ids=["delta_only", "two_segments"])
def test_one_pair_of_copies_per_live_query_batch(monkeypatch, compact):
    rs = _corpus()[2]
    svc = _live()
    if compact:
        svc.compact()
        svc.add_docs([50, 51], [[(1, 1.0)], [(2, 0.5), (3, 0.5)]])
    seen = {"copy": 0, "type1": 0, "type2": 0}
    for key, name in (("copy", "k_vocab_major"),
                      ("type1", "sddmm_spmm_type1_batch_vm"),
                      ("type2", "sddmm_spmm_type2_batch_vm")):
        def wrapper(*a, _fn=getattr(ops, name), _key=key, **kw):
            seen[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, wrapper)
    svc.query_batch(rs)
    segments = svc.last_batch_stats["segments"]
    assert segments == (2 if compact else 1)
    assert seen == {"copy": 2, "type1": 8 * segments, "type2": segments}


def test_rerank_state_follows_a_compaction():
    """Every piece of device state derived from the base moves with a
    compaction: the engine's ELL, the bound tiers' ELL, the rerank blocks'
    ELL with its pad doc, the empty-doc mask and the tier-0 moments."""
    vecs, ell, rs = _corpus()
    svc = _live()
    svc.top_k_batch(rs, TOP_K, prune=True)        # builds the moments
    before = svc._rerank_cols_d[0].clone()
    assert before.shape[0] == 9                   # empty base: 8 rows + pad
    svc.compact()
    svc.live_doc_ids                              # refreshes
    base = svc.live.base_ell
    assert svc._rerank_cols_d[0].shape[0] == base.num_docs + 1 == 33
    np.testing.assert_array_equal(svc._rerank_cols_d[0][:-1].numpy(),
                                  base.cols)
    assert (svc._rerank_cols_d[0][-1] == vecs.shape[0]).all()
    np.testing.assert_array_equal(svc._ell_cols_d.numpy(), base.cols)
    assert svc._cent is None and svc._empty_doc_mask.shape == (32,)
    idx, dist = svc.top_k_batch(rs, TOP_K, prune=True)
    want = _svc(**SVC_KW).top_k_batch(rs, TOP_K)
    np.testing.assert_array_equal(idx, want[0])
    np.testing.assert_array_equal(dist, want[1])


@pytest.mark.parametrize("layout", ["empty_base", "wide_delta",
                                    "wide_base"])
def test_unusual_segment_shapes_answer_like_the_static_service(layout):
    """An empty base (8 pad rows), a delta whose nnz_max exceeds the
    base's, and the reverse: rows, pruned top-k and bounds are the static
    service's over the same docs, bitwise."""
    vecs, ell, rs = _corpus()
    docs = tf.doc_lists_from_ell(ell)
    wide = [(w, 1.0 / 20) for w in range(20)]      # 20 words: nnz_max 24
    if layout == "wide_base":
        docs = docs + [wide]
    svc = _live(docs)
    if layout != "empty_base":
        svc.compact()
        svc.add_docs([len(docs)], [wide if layout == "wide_delta"
                                   else docs[2]])
        docs = docs + [svc.live.live_docs()[-1][1]]
    lc = svc.live
    if layout == "wide_delta":
        assert lc.delta_ell.nnz_max > lc.base_ell.nnz_max
    elif layout == "wide_base":
        assert lc.base_ell.nnz_max > lc.delta_ell.nnz_max
    else:
        assert lc.base_ell.num_docs == 8 and not lc.base_ell.vals.any()
    static = WMDService(cfg=_cfg(WMDConfig), vecs=vecs,
                        ell=tf.ell_from_doc_lists(docs, vecs.shape[0],
                                                  normalize=False),
                        device="cpu", **SVC_KW)
    np.testing.assert_array_equal(svc.query_batch(rs),
                                  static.query_batch(rs))
    np.testing.assert_array_equal(svc.query_batch_bounds(rs),
                                  static.query_batch_bounds(rs))
    for a, b in zip(svc.top_k_batch(rs, TOP_K, prune=True),
                    static.top_k_batch(rs, TOP_K)):
        np.testing.assert_array_equal(a, b)
