"""The port's async admission layer (`repro_torch.serving.coalescer`,
`.loadgen`, `WMDService.async_service` / `drain_async`) on the CPU.

* The contracts of the reference's `tests/test_coalescer.py` on fake
  engines: fill, window, deadline and drain triggers; pow2 rounding;
  backpressure block and reject; cancellation; the priority lane;
  exception fan-out; shutdown with and without drain; hit-rate
  pass-through; the load generators.
* Admission parity: one fake-engine schedule, driven only by fill and
  drain triggers, through `repro.serving.QueryCoalescer` and the port's
  gives the same `batch_log`, `shape_log` and `ServingStats` counters.
* Answer parity on the port's `WMDService(device="cpu")`: coalesced rows
  bitwise the direct `query_batch` of each logged batch composition, cache
  on and off, and within ``rtol=2e-3, atol=1e-5`` of the live JAX
  service's rows; coalesced pruned top-k ids equal the JAX service's.
* The writer lane on a live service (`WMDService.from_live`): the write
  futures resolve with the acked counts, and the queries around them are
  served over the corpus as it stands when they dispatch.

Timing-triggered assertions use windows orders of magnitude apart (10 s vs
tens of ms), as the reference's do.
"""
import itertools
import threading
import time

import numpy as np
import pytest

import repro.serving as ref_serving
from repro_torch.serving import (CoalescerClosedError, QueryCoalescer,
                                 QueueFullError, closed_loop, open_loop)

NEVER_MS = 10_000.0      # "window never fires" on any sane CI box


class FakeService:
    """query_batch stand-in: records every dispatched batch, optional
    per-dispatch delay, result row i = (i, sum(r_i)) so order is visible."""

    def __init__(self, delay_s: float = 0.0, hit_rate: float | None = None):
        self.calls: list[list[np.ndarray]] = []
        self.delay_s = delay_s
        self.last_batch_stats: dict = {}
        self._hit_rate = hit_rate

    def query_batch(self, rs):
        self.calls.append(list(rs))
        if self.delay_s:
            time.sleep(self.delay_s)
        if self._hit_rate is not None:
            self.last_batch_stats = {"hit_rate": self._hit_rate}
        return np.stack([np.array([i, float(r.sum())], np.float32)
                         for i, r in enumerate(rs)])


def _queries(n, start=0):
    return [np.full(4, float(start + i), np.float32) for i in range(n)]


# ---------------------------------------------------------------- triggers

def test_fill_trigger_cuts_full_pow2_bucket():
    svc = FakeService()
    with QueryCoalescer(svc, window_ms=NEVER_MS, max_batch=4) as co:
        futs = co.submit_many(_queries(4))
        for f in futs:
            f.result(timeout=30)
        st = co.stats()
    assert st.dispatch_fill == 1 and st.dispatches == 1
    assert st.batch_size_hist == {4: 1}
    assert len(svc.calls[0]) == 4


def test_window_trigger_flushes_partial_batch():
    svc = FakeService()
    with QueryCoalescer(svc, window_ms=40.0, max_batch=64) as co:
        t0 = time.monotonic()
        futs = co.submit_many(_queries(2))
        for f in futs:
            f.result(timeout=30)
        waited = time.monotonic() - t0
        st = co.stats()
    assert st.dispatch_window == 1 and st.dispatches == 1
    assert st.batch_size_hist == {2: 1}
    assert waited >= 0.040          # the window was honored, not skipped


def test_deadline_trigger_preempts_window():
    svc = FakeService()
    with QueryCoalescer(svc, window_ms=NEVER_MS, max_batch=64) as co:
        fut = co.submit(_queries(1)[0], deadline_ms=60.0)
        fut.result(timeout=30)
        st = co.stats()
    assert st.dispatch_deadline == 1 and st.dispatches == 1
    # fired well before the 10 s window (miss count is timing-sensitive on
    # a loaded box, so only the trigger itself is asserted)
    assert st.latency_ms_p50 < 1_000.0


def test_deadline_miss_is_served_and_counted():
    svc = FakeService(delay_s=0.05)   # solve alone blows a 1 ms deadline
    with QueryCoalescer(svc, window_ms=NEVER_MS, max_batch=64) as co:
        fut = co.submit(_queries(1)[0], deadline_ms=1.0)
        assert fut.result(timeout=30) is not None     # served, not dropped
        st = co.stats()
    assert st.deadline_misses == 1 and st.completed == 1


def test_max_batch_rounds_up_to_pow2():
    co = QueryCoalescer(FakeService(), max_batch=5)
    try:
        assert co.max_batch == 8
    finally:
        co.shutdown()


# ------------------------------------------------------------ backpressure

def test_backpressure_reject_raises_and_counts():
    svc = FakeService()
    co = QueryCoalescer(svc, window_ms=NEVER_MS, max_batch=64, max_queue=2,
                        backpressure="reject")
    try:
        f1, f2 = co.submit_many(_queries(2))
        with pytest.raises(QueueFullError):
            co.submit(_queries(1)[0])
        co.shutdown(drain=True)       # queued pair still gets served
        assert f1.result(timeout=30) is not None
        assert f2.result(timeout=30) is not None
        st = co.stats()
        assert st.rejected == 1 and st.completed == 2
        assert st.dispatch_drain >= 1
    finally:
        co.shutdown()


def test_backpressure_block_waits_for_space():
    svc = FakeService(delay_s=0.02)
    with QueryCoalescer(svc, window_ms=1.0, max_batch=2, max_queue=2,
                        backpressure="block") as co:
        futs = co.submit_many(_queries(8))    # > max_queue: submits block
        for f in futs:                        # until dispatches free space
            f.result(timeout=30)
        st = co.stats()
    assert st.completed == 8 and st.rejected == 0


def test_backpressure_block_timeout_gives_up():
    svc = FakeService()
    co = QueryCoalescer(svc, window_ms=NEVER_MS, max_batch=64, max_queue=1,
                        backpressure="block")
    try:
        co.submit(_queries(1)[0])
        with pytest.raises(QueueFullError):
            co.submit(_queries(1)[0], timeout=0.05)
        assert co.stats().rejected == 1
    finally:
        co.shutdown()


# --------------------------------------------------------------- lifecycle

def test_drain_on_shutdown_completes_everything():
    svc = FakeService()
    co = QueryCoalescer(svc, window_ms=NEVER_MS, max_batch=4)
    futs = co.submit_many(_queries(10))       # 10 queued: 4+4+2 drain pops
    co.shutdown(drain=True)
    assert all(f.done() and f.exception() is None for f in futs)
    st = co.stats()
    assert st.completed == 10 and st.queue_depth == 0
    # the fill trigger may race drain for full buckets; every dispatch is
    # one of the two and together they cover all 10 requests
    assert st.dispatch_fill + st.dispatch_drain == st.dispatches
    assert sum(q * c for q, c in st.batch_size_hist.items()) == 10


def test_shutdown_without_drain_fails_pending():
    svc = FakeService()
    co = QueryCoalescer(svc, window_ms=NEVER_MS, max_batch=64)
    futs = co.submit_many(_queries(3))
    co.shutdown(drain=False)
    for f in futs:
        with pytest.raises(CoalescerClosedError):
            f.result(timeout=30)
    with pytest.raises(CoalescerClosedError):
        co.submit(_queries(1)[0])


def test_dispatch_exception_fans_out_and_keeps_serving():
    class Exploding(FakeService):
        def query_batch(self, rs):
            if not self.calls:
                self.calls.append(list(rs))
                raise RuntimeError("boom")
            return super().query_batch(rs)

    svc = Exploding()
    with QueryCoalescer(svc, window_ms=5.0, max_batch=64) as co:
        bad = co.submit(_queries(1)[0])
        with pytest.raises(RuntimeError, match="boom"):
            bad.result(timeout=30)
        good = co.submit(_queries(1)[0])      # coalescer survived the error
        assert good.result(timeout=30) is not None
        st = co.stats()
    assert st.failed == 1 and st.completed == 1


def test_cancelled_future_discarded_dispatcher_survives():
    """A client cancelling a queued request must not kill the dispatcher:
    the request is dropped at batch formation, the rest of the bucket is
    served, and later submits still complete."""
    svc = FakeService()
    with QueryCoalescer(svc, window_ms=NEVER_MS, max_batch=4) as co:
        futs = co.submit_many(_queries(3))
        assert futs[1].cancel()              # still queued: cancel wins
        last = co.submit(np.full(4, 9.0, np.float32))   # fills the bucket
        rows = [futs[0].result(timeout=30), futs[2].result(timeout=30),
                last.result(timeout=30)]
        st = co.stats()
    assert st.cancelled == 1 and st.dispatch_fill == 1
    assert len(svc.calls[0]) == 3            # cancelled req never dispatched
    assert [float(r[1]) for r in rows] == [0.0, 8.0, 36.0]


def test_drain_flushes_without_waiting_out_window():
    """drain() must dispatch whatever is queued immediately (drain trigger),
    not sit out a long coalescing window."""
    svc = FakeService()
    with QueryCoalescer(svc, window_ms=NEVER_MS, max_batch=8) as co:
        fut = co.submit(_queries(1)[0])
        co.drain(timeout=30)         # NEVER_MS window: only drain can fire
        assert fut.done()
        st = co.stats()
        assert st.dispatch_drain == 1 and st.queue_depth == 0
        after = co.submit(_queries(1)[0])    # coalescer stays open
        co.drain(timeout=30)
        assert after.done()


def test_all_cancelled_batch_never_dispatches():
    """A cut whose every request was cancelled must not reach the engine,
    and shutdown-with-drain must still complete."""
    svc = FakeService()
    with QueryCoalescer(svc, window_ms=NEVER_MS, max_batch=8) as co:
        futs = co.submit_many(_queries(2))
        assert all(f.cancel() for f in futs)
    st = co.stats()
    assert st.cancelled == 2 and st.dispatches == 0 and svc.calls == []


def test_priority_lane_dispatched_first():
    svc = FakeService()
    with QueryCoalescer(svc, window_ms=NEVER_MS, max_batch=8) as co:
        fa = co.submit(np.full(4, 1.0, np.float32))
        fb = co.submit(np.full(4, 2.0, np.float32))
        fc = co.submit(np.full(4, 3.0, np.float32), priority=1)
        co.shutdown(drain=True)       # idempotent with the context exit
    batch = svc.calls[0]
    assert [float(r[0]) for r in batch] == [3.0, 1.0, 2.0]  # hi lane first
    # result rows follow batch position, so fc got row 0
    assert float(fc.result()[0]) == 0.0
    assert float(fa.result()[0]) == 1.0
    assert float(fb.result()[0]) == 2.0


def test_stats_hit_rate_passthrough_and_estimate():
    svc = FakeService(hit_rate=0.5)
    with QueryCoalescer(svc, window_ms=1.0, max_batch=4) as co:
        for f in co.submit_many(_queries(4)):
            f.result(timeout=30)
        st = co.stats()
    assert st.hit_rate == pytest.approx(0.5)
    assert st.service_estimate_ms > 0.0
    assert st.latency_ms_p50 > 0.0 and st.latency_ms_p99 >= st.latency_ms_p50


# ------------------------------------------------------- loadgen (clients)

def test_open_loop_poisson_submits_everything():
    svc = FakeService()
    with QueryCoalescer(svc, window_ms=2.0, max_batch=8) as co:
        res = open_loop(co.submit, iter(_queries(20)), rate_qps=2000.0,
                        seed=0, keep_results=True)
    assert res.submitted == 20 and res.completed == 20 and res.failed == 0
    assert res.throughput_qps > 0
    assert len(res.results) == 20
    assert res.latencies_ms.shape == (20,)


def test_closed_loop_accepts_synchronous_baseline():
    calls = []

    def sync_submit(r):
        calls.append(r)
        return np.array([len(calls)], np.float32)   # not a Future

    res = closed_loop(sync_submit, _queries(6), concurrency=2,
                      keep_results=True)
    assert res.completed == 6 and len(calls) == 6
    assert len(res.results) == 6




# ------------------------------------------------ admission parity (fakes)

class ParityEngine:
    """Deterministic engine-agnostic fake: records every dispatch, serves
    plain rows (i, sum(r_i)) and top-k pairs, and raises on a batch that
    holds a query whose first entry is 666."""

    def __init__(self):
        self.calls: list = []
        self.last_batch_stats: dict = {}
        self.last_prune_stats: dict = {}

    def query_batch(self, rs):
        self.calls.append(("plain", [float(r[0]) for r in rs]))
        if any(r[0] == 666 for r in rs):
            raise RuntimeError("boom")
        self.last_batch_stats = {"hit_rate": len(rs) / 8.0,
                                 "precompute_s": 0.0, "solve_s": 0.0}
        return np.stack([np.array([i, float(r.sum())], np.float32)
                         for i, r in enumerate(rs)])

    def top_k_batch(self, rs, k=10, prune=False):
        self.calls.append(("top_k", k, prune, [float(r[0]) for r in rs]))
        self.last_prune_stats = {"bound_s": 0.0, "rerank_s": 0.0}
        return (np.tile(np.arange(k, dtype=np.int64), (len(rs), 1)),
                np.stack([np.full(k, float(r[0]), np.float32) for r in rs]))


def _wait(futs):
    for f in futs:
        f.exception(timeout=30)


def _admission_schedule(mod):
    """Every cut forced by fill or drain: each fill bucket is waited out
    before the next submits, so batch compositions do not depend on
    thread timing."""
    from repro_torch.core.guards import InvalidQueryError as PortInvalid
    from repro.core.guards import InvalidQueryError as RefInvalid
    eng = ParityEngine()
    co = mod.QueryCoalescer(eng, window_ms=NEVER_MS, max_batch=4)

    def q(v):
        return np.full(4, float(v), np.float32)

    futs = []
    try:
        # fill: the priority lane first; the cut stops at the kind change
        futs += [co.submit(q(1)), co.submit(q(2)),
                 co.submit(q(0), priority=1), co.submit_top_k(q(3), k=3)]
        _wait(futs[:3])
        # fill: the top-k run
        futs += [co.submit_top_k(q(v), k=3) for v in (4, 5, 6)]
        _wait(futs[3:7])
        # a request cancelled while queued is discarded at the cut
        futs.append(co.submit(q(7)))
        assert futs[-1].cancel()
        futs += [co.submit(q(v)) for v in (8, 9, 10)]
        _wait(futs[8:11])
        # exception fan-out: the batch holding 666 fails as one
        futs += [co.submit(q(v)) for v in (11, 666, 13, 14)]
        _wait(futs[11:15])
        # quarantined at submit: never enqueued, never numbered
        with pytest.raises((PortInvalid, RefInvalid)):
            co.submit(np.full(4, np.nan, np.float32))
        # drain: partial batches, one per kind and k
        futs += [co.submit_top_k(q(16), k=5), co.submit_top_k(q(17), k=5),
                 co.submit_top_k(q(18), k=2)]
        co.drain(timeout=30)
        futs.append(co.submit(q(19)))
    finally:
        co.shutdown(drain=True, timeout=30)
    return eng, co, futs


_TIMED_FIELDS = {"latency_ms_mean", "latency_ms_p50", "latency_ms_p95",
                 "latency_ms_p99", "service_estimate_ms"}


def test_admission_layer_parity_with_the_reference():
    import dataclasses
    ref_eng, ref_co, ref_futs = _admission_schedule(ref_serving)
    eng, co, futs = _admission_schedule(
        __import__("repro_torch.serving", fromlist=["QueryCoalescer"]))
    assert eng.calls == ref_eng.calls
    assert list(co.batch_log) == list(ref_co.batch_log) == [
        (2, 0, 1), (3, 4, 5, 6), (8, 9, 10), (11, 12, 13, 14), (15, 16),
        (17,), (18,)]
    assert list(co.shape_log) == list(ref_co.shape_log)
    st = {k: v for k, v in dataclasses.asdict(co.stats()).items()
          if k not in _TIMED_FIELDS}
    ref_st = {k: v for k, v in dataclasses.asdict(ref_co.stats()).items()
              if k not in _TIMED_FIELDS}
    assert st == ref_st
    assert (st["dispatch_fill"], st["dispatch_drain"], st["cancelled"],
            st["failed"], st["quarantined"]) == (4, 3, 1, 4, 1)
    for f, g in zip(futs, ref_futs):
        assert f.cancelled() == g.cancelled()
        if f.cancelled():
            continue
        assert (f.exception() is None) == (g.exception() is None)
        if f.exception() is None:
            a, b = f.result(), g.result()
            if isinstance(a, tuple):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)
            else:
                np.testing.assert_array_equal(a, b)


# ---------------------------------- the port's engine: bitwise contract

@pytest.fixture(scope="module")
def wmd_services():
    """One tiny corpus (the reference test's recipe): the port's cache-off
    and cached services, and the live JAX service."""
    from repro.configs.sinkhorn_wmd import WMDConfig as JConfig
    from repro.launch.mesh import make_mesh
    from repro.serving import WMDService as JService
    from repro_torch.configs.sinkhorn_wmd import WMDConfig
    from repro_torch.data import make_corpus
    from repro_torch.serving import WMDService

    shape = dict(vocab_size=192, embed_dim=16, num_docs=32, nnz_max=32,
                 v_r=8, lamb=1.0, max_iter=8)
    data = make_corpus(vocab_size=192, embed_dim=16, num_docs=32,
                       num_queries=1, query_words=6, mean_words=6.0, seed=0)
    kw = dict(cfg=WMDConfig(name="t-coalescer", **shape), vecs=data.vecs,
              ell=data.ell, device="cpu")
    svc = WMDService(**kw)
    svc_cached = WMDService(**kw, cache_capacity=48, cache_rows_bucket=8,
                            mcache_capacity=48, prune_chunk=8)
    jsvc = JService(mesh=make_mesh((1, 1), ("data", "model")),
                    cfg=JConfig(name="t-coalescer", **shape), vecs=data.vecs,
                    ell=data.ell, cache_capacity=48, cache_rows_bucket=8,
                    prune_chunk=8)
    return svc, svc_cached, jsvc


def _zipf_queries(n, seed):
    from repro_torch.data import zipf_query_stream
    stream = zipf_query_stream(vocab_size=192, query_words=6, s=1.3,
                               seed=seed)
    return list(itertools.islice(stream, n))


def _replay_oracle(svc, co, qs, results):
    """Every coalesced row == a direct query_batch of the logged batch
    composition, bitwise (the dispatcher-owns-the-device contract)."""
    log = list(co.batch_log)
    covered = set()
    for group in log:
        direct = svc.query_batch([qs[i] for i in group])
        for j, seq in enumerate(group):
            np.testing.assert_array_equal(
                results[seq], direct[j],
                err_msg=f"request {seq} in dispatch {group}")
            covered.add(seq)
    assert covered == set(range(len(qs)))
    return log


@pytest.mark.parametrize("cached", [False, True])
def test_coalesced_bitwise_direct_and_close_to_live_jax(wmd_services,
                                                         cached):
    svc = wmd_services[1] if cached else wmd_services[0]
    qs = _zipf_queries(10, seed=3 + cached)
    with svc.async_service(window_ms=30.0, max_batch=4) as co:
        futs = co.submit_many(qs)
        results = [f.result(timeout=60) for f in futs]
        st = co.stats()
    log = _replay_oracle(svc, co, qs, results)
    assert len(log) >= 3              # bucket boundary genuinely crossed
    np.testing.assert_allclose(np.stack(results),
                               wmd_services[2].query_batch(qs),
                               rtol=2e-3, atol=1e-5)
    # the cache hit rate passes through on the stripes route only
    assert (st.hit_rate is not None) == cached


def test_coalesced_top_k_bitwise_direct_and_ids_of_live_jax(wmd_services):
    svc, jsvc = wmd_services[1], wmd_services[2]
    qs = _zipf_queries(8, seed=21)
    with svc.async_service(window_ms=30.0, max_batch=4) as co:
        futs = [co.submit_top_k(q, k=3) for q in qs]
        answers = [f.result(timeout=60) for f in futs]
    for group in co.batch_log:
        idx_d, d_d = svc.top_k_batch([qs[i] for i in group], 3, prune=True)
        for j, seq in enumerate(group):
            np.testing.assert_array_equal(answers[seq][0], idx_d[j])
            np.testing.assert_array_equal(answers[seq][1], d_d[j])
    idx_j, d_j = jsvc.top_k_batch(qs, 3, prune=True)
    np.testing.assert_array_equal(np.stack([a[0] for a in answers]), idx_j)
    np.testing.assert_allclose(np.stack([a[1] for a in answers]), d_j,
                               rtol=2e-3, atol=1e-5)


def test_multithreaded_zipf_stress_bitwise(wmd_services):
    """4 client threads x 8 seeded zipf queries against the cached service:
    all complete, nothing is lost or duplicated, and every dispatched batch
    replays bitwise against the direct engine."""
    svc = wmd_services[1]
    per_thread, threads_n = 8, 4
    qs_by_thread = [_zipf_queries(per_thread, seed=100 + t)
                    for t in range(threads_n)]
    dispatched = []
    orig = svc.query_batch

    def recording(rs, **kw):
        out = orig(rs, **kw)
        dispatched.append(([np.array(r) for r in rs], np.array(out)))
        return out

    svc.query_batch = recording
    try:
        results, errs = {}, []
        with svc.async_service(window_ms=3.0, max_batch=8,
                               max_queue=64) as co:
            def client(t):
                try:
                    for i, r in enumerate(qs_by_thread[t]):
                        results[(t, i)] = co.submit(r).result(timeout=120)
                except Exception as e:      # noqa: BLE001 -- surfaced below
                    errs.append(e)
            ts = [threading.Thread(target=client, args=(t,))
                  for t in range(threads_n)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in ts)
            st = co.stats()
    finally:
        del svc.query_batch
    assert not errs
    assert st.completed == threads_n * per_thread == len(results)
    assert sum(q * c for q, c in st.batch_size_hist.items()) == st.completed
    for rs, out in dispatched:
        np.testing.assert_array_equal(svc.query_batch(rs), out)


def test_async_service_and_drain_hook(wmd_services):
    """WMDService.async_service wires a working coalescer; drain_async
    flushes every live one; a single coalesced request == a direct
    query_batch of one."""
    svc = wmd_services[0]
    q = _zipf_queries(1, seed=9)[0]
    co = svc.async_service(window_ms=NEVER_MS, max_batch=4)
    co2 = svc.async_service(window_ms=NEVER_MS, max_batch=4)
    try:
        fut, fut2 = co.submit(q), co2.submit_top_k(q, k=3)
        svc.drain_async(timeout=60)
        assert fut.done() and fut2.done()
        np.testing.assert_array_equal(fut.result(), svc.query_batch([q])[0])
        assert co.stats().dispatch_drain == co2.stats().dispatch_drain == 1
    finally:
        co.shutdown(timeout=60)
        co2.shutdown(timeout=60)


def test_writer_lane_resolves_with_not_implemented(wmd_services, tmp_path):
    """The writer lane on a live service (the name is kept from when the
    port's mutators were stubs): each write future resolves with its acked
    count, and the queries around the writes are served, in FIFO order,
    over the corpus as it stands when each dispatches -- bitwise the
    static service's rows on the same docs. A service without a live
    corpus resolves a write with the reference's ValueError."""
    from repro_torch.core import formats
    from repro_torch.data import LiveCorpus
    from repro_torch.serving import WMDService
    svc = wmd_services[0]
    qs = _zipf_queries(2, seed=13)
    docs = formats.doc_lists_from_ell(svc.ell)
    lc = LiveCorpus(str(tmp_path / "live"), svc.ell.num_vocab,
                    normalize=False)
    lc.add_docs(range(len(docs)), docs)
    live = WMDService.from_live(None, svc.cfg, svc.vecs, lc, device="cpu")
    with live.async_service(window_ms=NEVER_MS, max_batch=4) as co:
        before = co.submit(qs[0])
        add = co.submit_add_docs([40], [docs[3]])
        rm = co.submit_remove_docs([0])
        after = co.submit(qs[1])
        co.drain(timeout=60)
        assert add.result(timeout=60) == 1 and rm.result(timeout=60) == 1
        np.testing.assert_array_equal(before.result(timeout=60),
                                      svc.query_batch([qs[0]])[0])
        # after the writes: doc 0 gone, doc 40 (doc 3's words) appended
        want = svc.query_batch([qs[1]])[0]
        np.testing.assert_array_equal(after.result(timeout=60),
                                      np.append(want[1:], want[3]))
        st = co.stats()
    assert st.write_dispatches == 2 and st.docs_added == 1
    assert st.docs_removed == 1 and st.failed == 0 and st.completed == 4
    assert list(co.shape_log) == [("plain", 1, None), ("plain", 1, None)]
    assert live.live_doc_ids.tolist() == list(range(1, 32)) + [40]
    lc.close()
    with svc.async_service(window_ms=NEVER_MS, max_batch=4) as co:
        fut = co.submit_add_docs([0], [[(0, 1.0)]])
        co.drain(timeout=60)
        with pytest.raises(ValueError, match="no live corpus"):
            fut.result(timeout=60)


def test_many_submitters_lose_no_request_under_fast_switching():
    """More client threads than cores, a shortened switch interval: every
    request is dispatched exactly once, counted once, and answered with
    its own row."""
    import os
    import sys
    svc = FakeService()
    n_threads = min(64, max(8, 2 * (os.cpu_count() or 4)))
    per = 40
    futs: dict = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with QueryCoalescer(svc, window_ms=0.5, max_batch=8,
                            max_queue=16) as co:
            def client(t):
                for i in range(per):
                    v = float(t * per + i)
                    futs[v] = co.submit(np.full(4, v, np.float32))
            ts = [threading.Thread(target=client, args=(t,))
                  for t in range(n_threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in ts)
            co.drain(timeout=120)
            st = co.stats()
    finally:
        sys.setswitchinterval(old)
    total = n_threads * per
    assert st.submitted == st.completed == len(futs) == total
    assert sum(q * c for q, c in st.batch_size_hist.items()) == total
    assert sorted(s for b in co.batch_log for s in b) == list(range(total))
    dispatched = sorted(float(r[0]) for call in svc.calls for r in call)
    assert dispatched == sorted(futs)
    for v, f in futs.items():
        assert float(f.result(timeout=10)[1]) == 4 * v
