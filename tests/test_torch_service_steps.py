"""The service's step spans (`WMDService.tracer`, `repro_torch.obs.Tracer`)
on the CPU, over the golden corpus of `test_torch_service`:

* each batch route records one tree whose step spans have the documented
  names, in order, without overlap, inside the root;
* a raising guard closes its tree as failed, and nothing stays open;
* a bound tracer changes no bit of any route's answer;
* the default `NULL_TRACER` reads the clock only for the phase timers;
* the coalescer places its ``precompute`` / ``solve`` children where the
  service ran those phases.
"""
import tempfile
import time
import types

import numpy as np
import pytest

from repro_torch.configs.sinkhorn_wmd import WMDConfig
from repro_torch.core import formats as tf
from repro_torch.core.guards import InvalidQueryError
from repro_torch.data import LiveCorpus
from repro_torch.obs import Tracer
from repro_torch.serving import WMDService
from repro_torch.serving import wmd_service
from test_torch_service import TOP_K, _cfg, _corpus, _svc

PRUNE_KW = dict(cache_capacity=64, prune_chunk=8, bound_docs_chunk=None)
BULK = ["validate", "select_pad", "kcache", "km_guard", "solve", "d2h",
        "distance_guard"]
LEGACY = ["validate", "select_pad", "solve", "d2h", "distance_guard"]
LIVE = ["validate", "select_pad", "kcache", "km_guard", "solve", "d2h",
        "solve", "d2h", "distance_guard"]


def _per_query(q: int) -> list:
    return (["validate", "select_pad", "bounds"]
            + ["kcache", "km_guard", "order", "rerank"] * q
            + ["funnel", "distance_guard"])


UNION = ["validate", "select_pad", "bounds", "kcache", "km_guard", "rerank",
         "host_topk", "funnel", "distance_guard"]


def _live_svc(**kw):
    """A live service whose docs lie half in the base, half in the delta."""
    vecs, ell, _ = _corpus()
    docs = tf.doc_lists_from_ell(ell)
    lc = LiveCorpus(tempfile.mkdtemp(prefix="live-steps-"), vecs.shape[0],
                    normalize=False)
    half = len(docs) // 2
    lc.add_docs(range(half), docs[:half])
    lc.compact()
    lc.add_docs(range(half, len(docs)), docs[half:])
    return WMDService.from_live(None, _cfg(WMDConfig), vecs, lc,
                                device="cpu", **kw)


Q = len(_corpus()[2])
# route -> (service factory, call, op, route attr, step names)
ROUTES = {
    "cached": (lambda: _svc(cache_capacity=64),
               lambda s, rs: s.query_batch(rs),
               "query_batch", "stripes", BULK),
    "uncached": (lambda: _svc(),
                 lambda s, rs: s.query_batch(rs, use_cache=False),
                 "query_batch", "transient", BULK),
    "legacy_fused": (lambda: _svc(),
                     lambda s, rs: s.query_batch(rs),
                     "query_batch", "legacy_fused", LEGACY),
    "top_k": (lambda: _svc(cache_capacity=64),
              lambda s, rs: s.top_k_batch(rs, TOP_K),
              "top_k_batch", "stripes", BULK + ["host_topk"]),
    "pruned": (lambda: _svc(**PRUNE_KW),
               lambda s, rs: s.top_k_batch(rs, TOP_K, prune=True),
               "top_k_batch", "pruned", _per_query(Q)),
    "scan": (lambda: _svc(**PRUNE_KW),
             lambda s, rs: s.top_k_scan_batch(rs, TOP_K),
             "top_k_scan_batch", "scan", _per_query(Q)),
    "union": (lambda: _svc(**PRUNE_KW),
              lambda s, rs: s.top_k_batch(rs, TOP_K, prune=True,
                                          rerank="union"),
              "top_k_batch", "union", UNION),
    "live": (lambda: _live_svc(**PRUNE_KW),
             lambda s, rs: s.query_batch(rs),
             "query_batch", "live", LIVE),
    "live_pruned": (lambda: _live_svc(**PRUNE_KW),
                    lambda s, rs: s.top_k_batch(rs, TOP_K, prune=True),
                    "top_k_batch", "live_pruned", _per_query(Q)),
}


def _traced(make):
    svc = make()
    svc.tracer = Tracer()
    return svc


def _equal(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_step_spans_name_order_and_nest(route):
    make, call, op, route_attr, names = ROUTES[route]
    rs = _corpus()[2]
    svc = _traced(make)
    call(svc, rs)
    trees, _ = svc.tracer.snapshot()
    assert svc.tracer.open_count == 0
    assert len(trees) == 1                 # nested entry points: one tree
    tree = trees[0]
    assert tree["seq"] == "batch-1" and tree["status"] == "ok"
    assert tree["attrs"] == {"op": op, "q": Q, "q_pad": 4,
                             "route": route_attr}
    spans = tree["spans"]
    assert [s["name"] for s in spans] == names
    assert tree["t0"] <= spans[0]["t0"] and spans[-1]["t1"] <= tree["t1"]
    for a, b in zip(spans, spans[1:]):
        assert a["t0"] <= a["t1"] <= b["t0"]
    by = {s["name"]: s["attrs"] for s in spans}
    assert by["validate"] == {"queries": Q,
                              "bytes": sum(r.nbytes for r in rs)}
    assert by["select_pad"] == {"pad_rows": 1}
    if "solve" in by:
        assert by["solve"]["iters"] == svc.cfg.max_iter
        assert by["d2h"]["bytes"] > 0
    if "kcache" in by:
        assert set(by["kcache"]) == {"hits", "misses", "unique"}
    if "rerank" in by:
        assert set(by["rerank"]) == {"blocks", "solves", "topk_s"}
        assert by["rerank"]["blocks"] >= 1 and by["rerank"]["topk_s"] >= 0
    # a second call opens the next tree
    call(svc, rs)
    assert [t["seq"] for t in svc.tracer.snapshot()[0]] == \
        ["batch-1", "batch-2"]


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_tracer_on_is_bitwise_tracer_off(route):
    make, call, *_ = ROUTES[route]
    rs = _corpus()[2]
    _equal(call(_traced(make), rs), call(make(), rs))


@pytest.mark.parametrize("route", ["cached", "legacy_fused", "pruned"])
def test_raising_guard_closes_its_tree_as_failed(route):
    make, call, op, *_ = ROUTES[route]
    rs = list(_corpus()[2])
    rs[1] = np.full_like(rs[1], np.nan)
    svc = _traced(make)
    with pytest.raises(InvalidQueryError):
        call(svc, rs)
    assert svc.tracer.open_count == 0 and svc._tree is None
    (tree,) = svc.tracer.snapshot()[0]
    assert tree["status"] == "failed"
    assert tree["attrs"]["reason"] == "InvalidQueryError"
    assert tree["attrs"]["op"] == op and tree["spans"] == []
    # the service serves (and traces) on after the failure
    call(svc, _corpus()[2])
    assert [t["status"] for t in svc.tracer.snapshot()[0]] == \
        ["failed", "ok"]


@pytest.mark.parametrize("route,reads", [("cached", 4), ("uncached", 4),
                                         ("legacy_fused", 2)])
def test_null_tracer_reads_only_the_phase_clocks(monkeypatch, route, reads):
    """Off, a `query_batch` reads ``time.monotonic`` twice a phase (the
    start and end of precompute_s and of solve_s) and nothing else of the
    service module's clock."""
    make, call, *_ = ROUTES[route]
    svc = make()
    rs = _corpus()[2]
    call(svc, rs)                           # warm the caches and programs
    stamps = []

    def monotonic():
        stamps.append(time.monotonic())
        return stamps[-1]

    def perf_counter():
        raise AssertionError("perf_counter read on the service's path")

    monkeypatch.setattr(wmd_service, "time", types.SimpleNamespace(
        monotonic=monotonic, perf_counter=perf_counter))
    call(svc, rs)
    assert len(stamps) == reads
    st = svc.last_batch_stats
    assert st["solve_t0"] == stamps[-2]
    assert st["solve_s"] == stamps[-1] - stamps[-2]
    if reads == 4:
        assert st["precompute_t0"] == stamps[0]
        assert st["precompute_s"] == stamps[1] - stamps[0]


def test_coalescer_places_phases_where_they_ran():
    """With a slow validation, the dispatch's ``precompute`` child starts
    after the validation, and both children lie inside the dispatch."""
    rs = _corpus()[2]
    svc = _svc(cache_capacity=64)
    slow = 0.05
    validate = svc._validate_queries

    def slow_validate(qs):
        time.sleep(slow)
        return validate(qs)

    svc._validate_queries = slow_validate
    tr = Tracer()
    with svc.async_service(window_ms=10_000.0, max_batch=len(rs),
                           tracer=tr) as co:
        futs = [co.submit(r) for r in rs]
        co.drain(timeout=60.0)
    for f in futs:
        f.result(timeout=60.0)
    trees, _ = tr.snapshot()
    assert len(trees) == len(rs) and tr.open_count == 0
    for tree in trees:
        by = {s["name"]: s for s in tree["spans"]}
        disp, pre, solve = by["dispatch"], by["precompute"], by["solve"]
        assert pre["t0"] >= disp["t0"] + slow
        assert disp["t0"] <= pre["t0"] <= pre["t1"] <= solve["t0"]
        assert solve["t1"] <= disp["t1"]
