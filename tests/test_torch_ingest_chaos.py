"""Ingest chaos on the port's live corpus: kill the writer at every WAL /
snapshot / compaction boundary and hold the recovery to the acked prefix.

* The port's `LiveCorpus` crosses the same boundaries, in the same order,
  as the reference's for one mixed op sequence (adds, upserts, removes of
  live and never-added ids, an empty doc, two compactions).
* A kill swept over every boundary of that sequence: after recovery from
  disk alone, every acked op is visible and nothing but the crashed op's
  ids is extra; the run then finishes, and the port's CPU service over
  the recovered corpus answers `query_batch`, pruned top-k and bounds bit
  for bit like a one-shot build of the same docs.
* The coalescer's writer lane on a live service: merged write dispatches,
  per-request acks, read-your-writes order.
* Writers, readers and a compacting thread racing on one live service:
  no acked write lost, no read over a mixed corpus, one-shot bits at the
  end.
"""
import functools

import numpy as np
import pytest

from repro.data.live_corpus import LiveCorpus as RefCorpus
from repro.serving.faultinject import CrashInjector as RefInjector
from repro_torch.configs.sinkhorn_wmd import WMDConfig
from repro_torch.core import formats
from repro_torch.data import LiveCorpus
from repro_torch.serving import QueryCoalescer, WMDService
from repro_torch.serving.faultinject import CrashInjector, InjectedCrash

V = 96
LAMB, MAX_ITER, TOP_K = 1.0, 8, 4


def _mk_doc(rng, nnz=None):
    nnz = int(rng.integers(2, 8)) if nnz is None else nnz
    wids = rng.choice(V, size=nnz, replace=False)
    cnts = rng.integers(1, 9, size=nnz)
    return [(int(w), float(c)) for w, c in zip(wids, cnts)]


def _ops(seed, n=14):
    """The reference chaos suite's op sequence (`tests/test_ingest_chaos.py`
    ``_ops``)."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n):
        ops.append(("add", [i], [_mk_doc(rng)]))
        if i == 3:
            ops.append(("add", [1], [_mk_doc(rng)]))        # upsert
        if i == 5:
            ops.append(("remove", [2, 999]))                # live + never
            ops.append(("add", [4], [[]]))                  # empty-doc upsert
        if i in (6, 10):
            ops.append(("compact",))
    ops.append(("remove", [0]))
    return ops


def _apply(lc, op):
    if op[0] == "add":
        return lc.add_docs(op[1], op[2])
    if op[0] == "remove":
        return lc.remove_docs(op[1])
    lc.compact()
    return None


def _boundary_log(cls, injector, path):
    hook = injector()
    lc = cls(str(path), V, crash_hook=hook)
    for op in _ops(7):
        _apply(lc, op)
    lc.close()
    return hook.log


def test_boundaries_match_the_reference(tmp_path):
    port = _boundary_log(LiveCorpus, CrashInjector, tmp_path / "port")
    ref = _boundary_log(RefCorpus, RefInjector, tmp_path / "ref")
    assert port == ref
    assert {"wal.append.pre", "wal.append.torn", "wal.append.synced",
            "compact.begin", "compact.built", "compact.snapshot.tmp",
            "compact.renamed", "compact.done"} <= set(port)


@functools.lru_cache(maxsize=1)
def _problem():
    rng = np.random.default_rng(1234)
    vecs = rng.normal(size=(V, 8)).astype(np.float32)
    rs = []
    for i in range(3):
        r = np.zeros(V, np.float32)
        idx = rng.choice(V, 5 + 2 * i, replace=False)
        r[idx] = rng.random(idx.size).astype(np.float32) + 0.1
        r /= r.sum()
        rs.append(r)
    return vecs, rs


def _service(**kw):
    ell = kw.get("ell")
    n = ell.num_docs if ell is not None else kw["live"].num_live
    cfg = WMDConfig(name="chaos", vocab_size=V, embed_dim=8, num_docs=n,
                    nnz_max=32, v_r=12, lamb=LAMB, max_iter=MAX_ITER)
    return WMDService(cfg=cfg, vecs=_problem()[0], device="cpu",
                      cache_capacity=64, prune_chunk=8,
                      bound_docs_chunk=None, **kw)


@functools.lru_cache(maxsize=1)
def _oneshot_answers():
    """The crash-free run's final docs, built in one shot, and its
    answers: the bitwise target of every recovered corpus."""
    import tempfile
    lc = LiveCorpus(tempfile.mkdtemp(prefix="chaos-ref-"), V)
    for op in _ops(7):
        _apply(lc, op)
    docs = lc.live_docs()
    lc.close()
    ell = formats.ell_from_doc_lists([d for _, d in docs], V)
    svc = _service(ell=ell)
    rs = _problem()[1]
    ids = np.array([i for i, _ in docs])
    idx, dist = svc.top_k_batch(rs, TOP_K, prune=True)
    return (docs, svc.query_batch(rs), (ids[idx], dist),
            svc.query_batch_bounds(rs))


def test_crash_sweep_every_boundary_recovers_bitwise(tmp_path):
    ops = _ops(7)
    docs, d_want, topk_want, lb_want = _oneshot_answers()
    n_boundaries = len(_boundary_log(LiveCorpus, CrashInjector,
                                     tmp_path / "count"))
    assert n_boundaries > 30
    rs = _problem()[1]
    for target in range(n_boundaries):
        hook = CrashInjector(target=target)
        d = str(tmp_path / f"sweep{target}")
        lc = LiveCorpus(d, V, crash_hook=hook)
        acked, crashed_at = [], None
        for i, op in enumerate(ops):
            try:
                _apply(lc, op)
                acked.append(op)
            except InjectedCrash:
                crashed_at = i
                break
        assert crashed_at is not None, f"target {target} never fired"
        del lc
        rec = LiveCorpus(d, V)                      # recover from disk
        expect = {}
        for op in acked:
            if op[0] == "add":
                for i_, d_ in zip(op[1], op[2]):
                    expect[i_] = [(int(w), float(c)) for w, c in d_]
            elif op[0] == "remove":
                for i_ in op[1]:
                    expect.pop(i_, None)
        got = dict(rec.live_docs())
        crashed = ops[crashed_at]
        in_flight = set(crashed[1]) if crashed[0] != "compact" else set()
        for i_, doc in expect.items():
            if i_ not in in_flight:
                assert got.get(i_) == doc, \
                    f"boundary {target} ({hook.crashed_at}): acked doc {i_}"
        assert set(got) - set(expect) <= in_flight, f"boundary {target}"
        for op in ops[crashed_at:]:
            _apply(rec, op)
        assert rec.live_docs() == docs, f"boundary {target} diverged"
        svc = _service(live=rec)
        np.testing.assert_array_equal(svc.query_batch(rs), d_want)
        for a, b in zip(svc.top_k_batch(rs, TOP_K, prune=True), topk_want):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(svc.query_batch_bounds(rs), lb_want)
        rec.close()


def test_coalescer_writer_lane_acks_on_a_live_service(tmp_path):
    """Reads and writes through the coalescer: merged write dispatches,
    per-request acks, read-your-writes FIFO, final corpus as expected."""
    rng = np.random.default_rng(3)
    base = {i: _mk_doc(rng) for i in range(12)}
    lc = LiveCorpus(str(tmp_path / "co"), V)
    lc.add_docs(list(base), list(base.values()))
    svc = _service(live=lc)
    rs = _problem()[1]
    with QueryCoalescer(svc, window_ms=4.0, max_batch=8) as co:
        futs = []
        for j in range(6):
            futs.append(("w", co.submit_add_docs(
                [100 + j], [_mk_doc(np.random.default_rng(j))])))
            futs.append(("r", co.submit(rs[j % len(rs)])))
        futs.append(("w", co.submit_remove_docs([100, 101])))
        last = co.submit(rs[0])
        for kind, f in futs:
            res = f.result(timeout=60)
            if kind == "w":
                assert res >= 1                    # ids durably logged
        st = co.stats()
        assert st.write_dispatches >= 2
        assert st.docs_added == 6 and st.docs_removed == 2
        # read-your-writes: the read after the remove sees 16 docs
        assert last.result(timeout=60).shape == (16,)
    assert svc.live_doc_ids.tolist() == list(range(12)) + [102, 103, 104,
                                                           105]
    lc.close()


def test_writers_readers_and_compactions_race_without_losing_a_write(
        tmp_path):
    """More threads than cores, a shortened switch interval: writers
    upserting their own ids through the service, a thread compacting in a
    loop and readers dispatching queries. Every acked write is in the
    final corpus (and after a reopen), every read answered over one
    consistent corpus (its columns are the live ids at some instant), and
    the final answers are a one-shot build's, bitwise."""
    import sys
    import threading
    rs = _problem()[1]
    lc = LiveCorpus(str(tmp_path / "race"), V)
    svc = _service(live=lc)
    n_writers, per_writer = 6, 8
    docs = {w * 100 + j: _mk_doc(np.random.default_rng(w * 100 + j))
            for w in range(n_writers) for j in range(per_writer)}
    errors, widths = [], []
    stop = threading.Event()

    def writer(w):
        try:
            for j in range(per_writer):
                i = w * 100 + j
                assert svc.add_docs([i], [docs[i]]) == 1
        except Exception as e:      # noqa: BLE001 -- reported below
            errors.append(e)

    def compactor():
        try:
            for _ in range(6):
                if stop.is_set():
                    break
                svc.compact()
        except Exception as e:      # noqa: BLE001
            errors.append(e)

    def reader():
        try:
            for _ in range(8):
                widths.append(svc.query_batch(rs[:1]).shape[1])
        except Exception as e:      # noqa: BLE001
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        writers = [threading.Thread(target=writer, args=(w,))
                   for w in range(n_writers)]
        others = [threading.Thread(target=compactor)] + [
            threading.Thread(target=reader) for _ in range(2)]
        for t in writers + others:
            t.start()
        for t in writers:
            t.join(timeout=120)
        stop.set()
        for t in others:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in writers + others)
    assert not errors, errors
    assert widths and set(widths) <= set(range(len(docs) + 1))
    assert svc.live_doc_ids.tolist() == sorted(docs)
    want = _service(ell=formats.ell_from_doc_lists(
        [docs[i] for i in sorted(docs)], V)).query_batch(rs)
    np.testing.assert_array_equal(svc.query_batch(rs), want)
    lc.close()
    rec = LiveCorpus(str(tmp_path / "race"), V)
    assert dict(rec.live_docs()) == docs
    rec.close()
