"""The port's `WMDService(device="cpu")` against the JAX package's
`WMDService(mesh=make_mesh((1, 1), ...))` on the golden corpus recipe:
the stripes (K cache), transient and legacy routes within the reference's
engine tolerance (``rtol=2e-3, atol=1e-5``), top-k ids equal, the port's
own bitwise contracts, and the serving launcher on the CPU (one-shot,
async serving loop and offline modes)."""
import functools
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs.sinkhorn_wmd import WMDConfig as JConfig
from repro.launch.mesh import make_mesh
from repro.serving import WMDService as JService
from repro_torch.configs.sinkhorn_wmd import WMDConfig
from repro_torch.convert import state_from_numpy
from repro_torch.core import formats as tf
from repro_torch.core.guards import InvalidQueryError
from repro_torch.serving import WMDService

LAMB, MAX_ITER, V_R_BUCKET, TOP_K = 1.0, 8, 12, 5
TOL = dict(rtol=2e-3, atol=1e-5)
ROOT = pathlib.Path(__file__).resolve().parents[1]


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


def _cfg(cls):
    vecs, ell, _ = _corpus()
    return cls(name="golden", vocab_size=vecs.shape[0], embed_dim=8,
               num_docs=ell.num_docs, nnz_max=ell.nnz_max, v_r=V_R_BUCKET,
               lamb=LAMB, max_iter=MAX_ITER)


def _svc(**kw):
    vecs, ell, _ = _corpus()
    return WMDService(cfg=_cfg(WMDConfig), vecs=vecs, ell=ell, device="cpu",
                      **kw)


@functools.lru_cache(maxsize=1)
def _reference():
    """Live JAX outputs of the golden service routes."""
    vecs, ell, rs = _corpus()
    mesh = make_mesh((1, 1), ("data", "model"))
    svc = JService(mesh=mesh, cfg=_cfg(JConfig), vecs=vecs, ell=ell,
                   cache_capacity=64, prune_chunk=8, bound_docs_chunk=None)
    out = {"service_stripes": svc.query_batch(rs),
           "service_transient": svc.query_batch(rs, use_cache=False)}
    out["topk_idx"], out["topk_dist"] = svc.top_k_batch(rs, TOP_K)
    out["pruned"] = svc.top_k_batch(rs, TOP_K, prune=True)
    out["union"] = svc.top_k_batch(rs, TOP_K, prune=True, rerank="union")
    out["scan"] = svc.top_k_scan_batch(rs, TOP_K)
    out["bounds_topk"] = svc.top_k_batch_bounds(rs, TOP_K)
    out["bounds"] = svc.query_batch_bounds(rs)
    legacy = JService(mesh=mesh, cfg=_cfg(JConfig), vecs=vecs, ell=ell)
    out["service_legacy"] = legacy.query_batch(rs)
    return out


@pytest.mark.parametrize("route", ["service_stripes", "service_transient",
                                   "service_legacy"])
def test_service_routes_match_live_jax(route):
    _, _, rs = _corpus()
    if route == "service_legacy":
        svc = _svc()
        got = svc.query_batch(rs)
        assert svc.last_batch_stats["route"] == "legacy_fused"
    else:
        svc = _svc(cache_capacity=64)
        got = svc.query_batch(rs, use_cache=(route == "service_stripes"))
        assert svc.last_batch_stats["cached"] == (route == "service_stripes")
    want = _reference()[route]
    assert got.shape == want.shape == (3, 24) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("impl", ["kernel", "fused", "unfused"])
def test_top_k_batch_ids_match_live_jax(impl):
    _, _, rs = _corpus()
    idx, dist = _svc(cache_capacity=64, impl=impl).top_k_batch(rs, TOP_K)
    np.testing.assert_array_equal(idx, _reference()["topk_idx"])
    np.testing.assert_allclose(dist, _reference()["topk_dist"], **TOL)


def _shares_word(rs, ell):
    """(Q, N) mask: doc j holds one of query q's words."""
    live = ell.vals != 0
    return np.stack([(np.isin(ell.cols, np.nonzero(r)[0]) & live).any(1)
                     for r in rs])


@pytest.mark.parametrize("route", ["pruned", "union", "scan", "bounds_topk"])
def test_cascade_routes_match_live_jax(route):
    """The golden service settings (tests/test_golden.py:107): the same doc
    ids as the reference, distances within the engine tolerance."""
    _, _, rs = _corpus()
    svc = _svc(cache_capacity=64, prune_chunk=8, bound_docs_chunk=None)
    call = {"pruned": lambda: svc.top_k_batch(rs, TOP_K, prune=True),
            "union": lambda: svc.top_k_batch(rs, TOP_K, prune=True,
                                             rerank="union"),
            "scan": lambda: svc.top_k_scan_batch(rs, TOP_K),
            "bounds_topk": lambda: svc.top_k_batch_bounds(rs, TOP_K)}[route]
    idx, dist = call()
    want_idx, want_dist = _reference()[route]
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_allclose(dist, want_dist, **TOL)
    if route != "bounds_topk":
        np.testing.assert_array_equal(idx, _reference()["topk_idx"])


def test_query_batch_bounds_match_live_jax():
    """On the same M stripes the bounds agree within the bound tolerance
    (``rtol=1e-5, atol=1e-6``). Against the reference service, which makes
    its own M rows, so do pairs whose doc holds none of the query's words;
    a pair sharing a word reads M on that word's own column, where each
    package keeps its own round-off of the expansion |a|^2 + |b|^2 - 2ab
    (of order sqrt(eps * |a|^2) ~ 1e-3 at w = 8, times the slot's mass),
    so those pairs are held to an absolute 1e-3."""
    import jax.numpy as jnp
    from repro.core.rwmd import rwmd_bound_batch as jbound
    vecs, ell, rs = _corpus()
    svc = _svc(bound_docs_chunk=None)
    lb = svc.query_batch_bounds(rs)
    assert lb.shape == (3, 24) and svc.last_batch_stats["degraded"]
    sel_b, _, mask_b = svc._padded_query_batch(rs)
    m_pad, _ = svc._mcache.m_stripes_for_batch(sel_b, mask_b)
    same_m = np.asarray(jbound(jnp.asarray(m_pad.numpy()),
                               jnp.asarray(ell.cols), jnp.asarray(ell.vals)))
    np.testing.assert_allclose(lb, same_m[:3], rtol=1e-5, atol=1e-6)
    want = _reference()["bounds"]
    share = _shares_word(rs, ell)
    np.testing.assert_allclose(lb[~share], want[~share], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(lb[share], want[share], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(
        _svc(bound_docs_chunk=5, bound_impl="fused").query_batch_bounds(rs),
        lb)


def test_cache_on_off_transient_bitwise_and_hits():
    _, _, rs = _corpus()
    svc = _svc(cache_capacity=64)
    first = svc.query_batch(rs)
    assert svc.last_batch_stats["misses"] > 0
    again = svc.query_batch(rs)
    assert svc.last_batch_stats["hit_rate"] == 1.0
    off = svc.query_batch(rs, use_cache=False)
    transient = _svc().query_batch(rs, use_cache=True)      # capacity 0
    small = _svc(cache_capacity=8).query_batch(rs)            # overflow
    for d in (again, off, transient, small):
        np.testing.assert_array_equal(d, first)
    assert svc.cache_stats.hit_rows > 0 and svc.cache_resident > 0


def test_chunked_service_equals_unchunked_bitwise():
    _, _, rs = _corpus()
    svc = _svc(cache_capacity=64)
    base = svc.query_batch(rs)
    for dc in (5, 7):
        np.testing.assert_array_equal(svc.query_batch(rs, docs_chunk=dc),
                                      base)
    np.testing.assert_array_equal(_svc(cache_capacity=64, docs_chunk=7)
                                  .query_batch(rs), base)


def test_query_and_sequential_match_batch():
    _, _, rs = _corpus()
    svc = _svc(cache_capacity=64)
    batch = svc.query_batch(rs)
    np.testing.assert_allclose(svc.query_batch_sequential(rs), batch, **TOL)
    idx, dist = svc.top_k(rs[1], TOP_K)
    np.testing.assert_array_equal(idx, _reference()["topk_idx"][1])
    assert svc.query(rs[0]).shape == (24,)


def test_lambda_change_invalidates_the_cache():
    _, _, rs = _corpus()
    svc = _svc(cache_capacity=64)
    svc.query_batch(rs)
    svc.cfg = WMDConfig(**{**svc.cfg.__dict__, "lamb": 0.5})
    d_half = svc.query_batch(rs)
    assert svc.last_batch_stats["hits"] == 0
    assert svc.cache_stats.invalidations == 1
    fresh = _svc(cache_capacity=64)
    fresh.cfg = svc.cfg
    np.testing.assert_array_equal(fresh.query_batch(rs), d_half)
    # the pruned path re-keys the cache too when it is the first call
    # after the change (its rerank builds K rows under the new lambda)
    svc.cfg = WMDConfig(**{**svc.cfg.__dict__, "lamb": 0.25})
    got = svc.top_k_batch(rs, 5, prune=True)
    assert svc.cache_stats.invalidations == 2
    fresh = _svc(cache_capacity=64)
    fresh.cfg = svc.cfg
    for g, w in zip(got, fresh.top_k_batch(rs, 5, prune=True)):
        np.testing.assert_array_equal(g, w)


def test_from_state_and_guards():
    vecs, ell, rs = _corpus()
    state = state_from_numpy(vecs, ell.cols, ell.vals, ell.num_vocab,
                             device="cpu")
    svc = WMDService.from_state(_cfg(WMDConfig), state, cache_capacity=64)
    assert svc.device == torch.device("cpu")
    np.testing.assert_array_equal(svc.query_batch(rs),
                                  _svc(cache_capacity=64).query_batch(rs))
    with pytest.raises(InvalidQueryError):
        svc.query_batch([np.zeros(vecs.shape[0], np.float32)])
    with pytest.raises(InvalidQueryError):
        svc.query_batch([np.ones(3, np.float32)])
    assert svc.query_batch([]).shape == (0, 24)


def test_unported_parts_raise_not_implemented():
    """The corpus mutators are ported (the name is kept from when they
    were stubs): on a service without a live corpus they raise the
    reference's ValueError, as does `live_doc_ids`; a service needs ell=
    or live=."""
    svc = _svc()
    for call in (lambda: svc.add_docs([0], [[(0, 1.0)]]),
                 lambda: svc.remove_docs([0]),
                 lambda: svc.compact(),
                 lambda: svc.live_doc_ids):
        with pytest.raises(ValueError, match="has no live corpus"):
            call()
    vecs, _, _ = _corpus()
    with pytest.raises(ValueError, match="either ell= or live="):
        WMDService(cfg=_cfg(WMDConfig), vecs=vecs, device="cpu")


def test_default_device_is_the_card():
    vecs, ell, _ = _corpus()
    if torch.cuda.is_available():
        svc = WMDService(cfg=_cfg(WMDConfig), vecs=vecs, ell=ell)
        assert svc.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="GPU"):
        WMDService(cfg=_cfg(WMDConfig), vecs=vecs, ell=ell)


@pytest.mark.parametrize("flags", [
    ["--batch-queries"], [], ["--top-k", "5", "--prune"],
    ["--coalesce-window-ms", "2", "--requests", "16", "--top-k", "5",
     "--resilience", "--warmup", "--stats-out", "{tmp}/stats.json"],
    ["--coalesce-window-ms", "2", "--requests", "12", "--rate-qps", "400",
     "--deadline-ms", "500", "--brownout-queue", "64", "--trace-out",
     "{tmp}/trace.json", "--metrics-port", "0", "--stats-out",
     "{tmp}/stats.json"],
    ["--offline", "{tmp}/queries.npz", "--offline-out", "{tmp}/scored.npz",
     "--top-k", "5"]])
def test_serve_launcher_runs_on_cpu(flags, tmp_path):
    from repro_torch.data import zipf_query_stream
    from repro_torch.serving import save_query_file
    flags = [f.replace("{tmp}", str(tmp_path)) for f in flags]
    stream = zipf_query_stream(vocab_size=512, query_words=7, seed=5)
    save_query_file(tmp_path / "queries.npz",
                    [next(stream) for _ in range(6)])
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "sinkhorn-wmd", "--smoke", "--device", "cpu", "--num-queries", "3",
         *flags], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=240)
    assert out.returncode == 0, out.stderr
    if "--coalesce-window-ms" in flags:
        n = int(flags[flags.index("--requests") + 1])
        assert f"served {n}/{n}" in out.stdout
        assert "resilience: retries=0 demoted=0 degraded=0" in out.stdout
        stats = json.loads((tmp_path / "stats.json").read_text())
        serving = stats["serving"]
        assert serving["completed"] == serving["submitted"] == n
        assert serving["degraded"] == serving["failed"] == 0
        assert stats["resilience"]["demoted"] == 0
        assert stats["resilience"]["retries"] == 0
        kinds = ("plain", "top_k") if "--top-k" in flags else ("plain",)
        assert set(stats["warmup"]["shapes"]) == {
            f"{kind}/q{q}" + ("/k5" if kind == "top_k" else "")
            for kind in kinds for q in (1, 2, 4, 8)}
        if "--trace-out" in flags:
            trace = json.loads((tmp_path / "trace.json").read_text())
            roots = [e for e in trace["traceEvents"]
                     if e["name"].startswith("request[")]
            assert len(roots) == n
            assert "/metrics" in out.stdout
        return
    if "--offline" in flags:
        assert "offline top_k: 6 queries in 1 batches" in out.stdout
        with np.load(tmp_path / "scored.npz") as z:
            assert z["topk_idx"].shape == (6, 5)
            assert np.isfinite(z["topk_dist"]).all()
        return
    assert out.stdout.count("top5 docs") == 3
    assert ("solves avoided" in out.stdout) == ("--prune" in flags)
    assert ("per-query Q=3" in out.stdout) == (flags == [])


def test_serve_launcher_ingest_mode_seeds_then_recovers_on_cpu(tmp_path):
    """The launcher's live-corpus mode on the CPU, twice on one
    --live-dir: the first run seeds the corpus, the second recovers it
    from its snapshot and WAL; every write op is acked both times, and the
    stats JSON carries the corpus's stats."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    live_dir = tmp_path / "live"
    outs = []
    for _ in range(2):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             "sinkhorn-wmd", "--smoke", "--device", "cpu",
             "--coalesce-window-ms", "2", "--requests", "12",
             "--ingest-stream", "4", "--compact-every", "2", "--live-dir",
             str(live_dir), "--stats-out", str(tmp_path / "stats.json")],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
        assert out.returncode == 0, out.stderr
        assert "ingest: 4/4 write ops acked" in out.stdout
        outs.append(out.stdout)
    assert "live corpus seeded: 64 docs" in outs[0]
    assert "live corpus recovered: " in outs[1]
    live = json.loads((tmp_path / "stats.json").read_text())["live_corpus"]
    assert live["gen"] == 4 and live["num_live"] > 64
    assert live["compacting"] is False
