"""The port's observability layer (`repro_torch.obs.trace` / `.export`)
against the reference's (`repro.obs`), on the CPU.

* One call sequence through the reference's `Tracer` and the port's, on
  the same fake clock: equal completed trees, event logs and Chrome
  trace JSON; equal Prometheus text for equal registries.
* The port's scrape server and JSONL exporter run.
* The tracer's contracts on the port's coalescer and guard: every request
  closes exactly one tree (under a seeded chaos schedule too), guard and
  watchdog events land in the log.
* Obs on versus off changes no bit of `query_batch` / `top_k_batch`.
"""
import json
import re
import urllib.request

import numpy as np
import pytest

import repro.obs as ref_obs
import repro_torch.obs as obs
from repro_torch.distributed.fault_tolerance import (FaultPolicy,
                                                     ServingWatchdog)
from repro_torch.serving.coalescer import QueryCoalescer
from repro_torch.serving.resilience import (DegradedResult, EngineGuard,
                                            ResiliencePolicy)


class TickClock:
    """Deterministic clock: every read advances 0.25 s."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.25
        return self.t


def _drive(tracer_cls):
    tr = tracer_cls(ring=8, max_events=16, clock=TickClock())
    tr.begin_request(1, op="plain", k=None, priority=0)
    tr.begin_request(2, t0=3.0, op="top_k", k=5, priority=1)
    tr.add_span(1, "queue", 1.0, 1.5)
    tr.add_span(1, "dispatch", 1.5, 2.0, batch=4, hit_rate=np.float32(0.5),
                tier=None)
    tr.add_span(99, "ignored", 0.0, 1.0)             # never opened
    tr.end_request(1, t1=2.0, status="ok", deadline_missed=False)
    tr.begin_request(2)                               # reuse: orphan
    tr.end_request(2, status="degraded", reason="brownout")
    tr.closed_request(status="quarantined", op="plain")
    tr.event("breaker.transition", kind="plain", rung=0, frm="closed",
             to="open")
    tr.event("degraded", kind="top_k", reason="x", requests=np.int64(3))
    tr.begin_request(3)                               # left open
    for i in range(10):                               # ring eviction
        tr.closed_request(status="ok", i=i)
    return tr


def test_tracer_call_sequence_matches_reference():
    ref, port = _drive(ref_obs.Tracer), _drive(obs.Tracer)
    assert port.snapshot() == ref.snapshot()
    assert port.chrome_trace() == ref.chrome_trace()
    assert (port.open_count, port.dropped) == (ref.open_count, ref.dropped)
    assert port.drain_events() == ref.drain_events()
    assert port.snapshot()[1] == []


def test_tracer_exports_match_reference(tmp_path):
    ref, port = _drive(ref_obs.Tracer), _drive(obs.Tracer)
    for tr, name in ((ref, "ref"), (port, "port")):
        assert tr.export_chrome(str(tmp_path / f"{name}.json")) > 0
        tr.export_events_jsonl(str(tmp_path / f"{name}.jsonl"))
    for suffix in ("json", "jsonl"):
        assert (tmp_path / f"port.{suffix}").read_text() == \
            (tmp_path / f"ref.{suffix}").read_text()
    doc = json.loads((tmp_path / "port.json").read_text())
    assert {e["ph"] for e in doc["traceEvents"]} <= {"X", "i"}


def _fill(mod):
    reg = mod.MetricsRegistry()
    reg.counter("wmd_requests_total", "submitted requests",
                labels={"op": "plain"}).inc(5)
    reg.counter("wmd_requests_total", "submitted requests",
                labels={"op": "top_k"}).inc(2)
    reg.gauge("wmd_queue_depth", "queued requests").set(3.5)
    reg.counter("wmd_errors_total",
                labels={"error": 'Runtime"Error"\nline\\x'}).inc()
    h = reg.histogram("wmd_batch_size", "batch occupancy",
                      buckets=mod.DEFAULT_SIZE_BUCKETS)
    for v in (1, 3, 8, 300):
        h.observe(v)
    t = reg.histogram("wmd_request_latency_seconds", "latency",
                      buckets=mod.DEFAULT_TIME_BUCKETS)
    for v in (0.0004, 0.02, 7.0):
        t.observe(v)
    return reg


_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\.)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\.)*")*\})?'
    r" (-?[0-9.eE+-]+|\+Inf|-Inf|NaN)$")


def test_render_prometheus_matches_reference():
    text = obs.render_prometheus(_fill(obs))
    assert text == ref_obs.render_prometheus(_fill(ref_obs))
    for line in text.splitlines():
        assert line.startswith("# ") or _SAMPLE_RE.match(line), line
    assert text.count("# TYPE wmd_requests_total counter") == 1


def test_metrics_server_scrape_and_healthz():
    reg = _fill(obs)
    with obs.MetricsServer(reg, port=0, host="127.0.0.1") as srv:
        url = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            assert r.status == 200
            assert "text/plain" in r.headers["Content-Type"]
            assert r.read().decode() == obs.render_prometheus(reg)
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            assert r.read() == b"ok\n"


def test_jsonl_exporter_round_trip(tmp_path):
    tr = obs.Tracer()
    path = tmp_path / "events.jsonl"
    exp = obs.JsonlExporter(tr, str(path), interval_s=0.05)
    tr.event("brownout.enter", queue_depth=9)
    tr.event("degraded", requests=np.int32(2))
    exp.close()
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [ev["event"] for ev in lines] == ["brownout.enter", "degraded"]
    assert lines[1]["requests"] == 2 and exp.written == 2
    assert tr.drain_events() == []


def test_null_tracer_is_inert_shared_default():
    import test_torch_resilience as tres
    co = QueryCoalescer(tres.FlakyService(), window_ms=1.0, max_batch=4)
    assert co._tracer is obs.NULL_TRACER and not obs.NULL_TRACER.enabled
    try:
        assert co.submit(np.ones(6, np.float32)).result(timeout=30.0) \
            .shape == (6,)
    finally:
        co.shutdown(drain=True, timeout=30.0)
    co2 = QueryCoalescer(tres.FlakyService(), window_ms=1.0, max_batch=4)
    co2.shutdown(drain=True, timeout=30.0)
    assert co.metrics is not co2.metrics


# -- events of the guard and the watchdog -------------------------------------

def test_guard_events_breaker_degraded_and_metrics():
    import test_torch_resilience as tres
    tr = obs.Tracer()
    reg = obs.MetricsRegistry()
    g = EngineGuard(tres.FlakyService(fail=100),
                    ResiliencePolicy(max_retries=1, breaker_failures=2),
                    sleep=lambda s: None, tracer=tr, metrics=reg)
    res = g.dispatch("plain", [np.ones(4)] * 2)
    assert isinstance(res, DegradedResult)
    kinds = [e["event"] for e in tr.snapshot()[1]]
    assert "dispatch.failure" in kinds and "degraded" in kinds
    assert "breaker.transition" in kinds
    assert reg.counter("wmd_guard_degraded_total").value == 1
    assert reg.counter("wmd_breaker_transitions_total").value == \
        g.stats().breaker_transitions > 0
    assert "wmd_guard_failures_total" in obs.render_prometheus(reg)


def test_guard_events_brownout_enter_exit():
    import test_torch_resilience as tres
    clk = tres.FakeClock()
    tr = obs.Tracer(clock=clk)
    g = EngineGuard(tres.FlakyService(), ResiliencePolicy(
        brownout_queue_hi=4, brownout_queue_lo=1, brownout_dwell_s=1.0),
        clock=clk, sleep=lambda s: None, tracer=tr)
    g.dispatch("plain", [np.ones(4)], queue_depth=9)
    clk.advance(2.0)
    g.dispatch("plain", [np.ones(4)], queue_depth=0)
    kinds = [e["event"] for e in tr.snapshot()[1]]
    assert kinds.count("brownout.enter") == 1
    assert kinds.count("brownout.exit") == 1


def test_watchdog_strike_event():
    import test_torch_resilience as tres
    tr = obs.Tracer()
    tripped = []
    wd = ServingWatchdog(FaultPolicy(straggler_strikes=2),
                         on_strike=tripped.append, clock=tres.FakeClock(),
                         tracer=tr)
    wd.beat("plain", 0.01, False)
    wd.beat("plain", 0.01, False)
    assert tripped == ["plain"]
    assert [e["event"] for e in tr.snapshot()[1]] == ["watchdog.strike"]


# -- span trees over the coalescer ---------------------------------------------

def test_chaos_every_request_closes_exactly_one_tree():
    import test_torch_resilience as tres
    from repro_torch.serving.faultinject import FaultSchedule, FaultyEngine
    svc = tres._service()
    qs = tres._queries(32, seed=4)
    bad = np.full(tres.VOCAB, np.nan, np.float32)
    tr = obs.Tracer()
    eng = FaultyEngine(svc, FaultSchedule(seed=11, p_error=0.2,
                                          p_latency=0.1, p_corrupt=0.1,
                                          latency_s=0.005))
    co = QueryCoalescer(eng, window_ms=1.0, max_batch=4,
                        resilience=tres.CHAOS_POLICY, tracer=tr)
    try:
        futs = [co.submit(q) for q in qs]
        for _ in range(3):
            with pytest.raises(Exception):
                co.submit(bad)
        co.drain(timeout=120.0)
    finally:
        co.shutdown(drain=True, timeout=120.0)
    st = co.stats()
    assert st.submitted == len(qs) and st.quarantined == 3
    assert all(f.done() for f in futs)
    assert tr.open_count == 0
    trees, events = tr.snapshot()
    assert len(trees) == st.submitted + st.quarantined
    by_status: dict = {}
    for t in trees:
        by_status[t["status"]] = by_status.get(t["status"], 0) + 1
    assert by_status.get("quarantined", 0) == st.quarantined
    assert by_status.get("degraded", 0) == st.degraded
    assert by_status.get("failed", 0) == st.failed
    assert by_status.get("ok", 0) == st.completed - st.degraded
    assert len({t["seq"] for t in trees}) == len(trees)
    for t in trees:
        if t["status"] in ("ok", "degraded"):
            names = [s["name"] for s in t["spans"]]
            assert "queue" in names and "dispatch" in names
    assert "dispatch.failure" in {e["event"] for e in events}
    json.dumps(tr.chrome_trace())


def test_cancelled_and_shutdown_requests_close_trees():
    import test_torch_resilience as tres
    tr = obs.Tracer()
    co = QueryCoalescer(tres.FlakyService(), window_ms=10_000.0,
                        max_batch=64, tracer=tr)
    futs = [co.submit(np.ones(6, np.float32)) for _ in range(4)]
    futs[0].cancel()
    co.shutdown(drain=False, timeout=30.0)
    st = co.stats()
    assert st.cancelled == 1 and st.failed == 3
    assert tr.open_count == 0
    assert sorted(t["status"] for t in tr.snapshot()[0]) == \
        ["cancelled", "failed", "failed", "failed"]


# -- bitwise neutrality ---------------------------------------------------------

@pytest.mark.parametrize("cached", [False, True])
def test_obs_on_bitwise_identical_to_direct_routes(cached):
    """A traced, metered, guarded coalescer returns the direct calls' bits:
    `query_batch` rows and pruned `top_k_batch` answers."""
    import test_torch_service as tsvc
    _, _, rs = tsvc._corpus()
    kw = dict(cache_capacity=64, prune_chunk=8, bound_docs_chunk=None) \
        if cached else {}
    svc = tsvc._svc(**kw)
    direct = svc.query_batch(rs)
    idx_d, d_d = svc.top_k_batch(rs, tsvc.TOP_K, prune=True)
    tr = obs.Tracer()
    reg = obs.MetricsRegistry()
    guard = EngineGuard(svc, ResiliencePolicy(), tracer=tr, metrics=reg)
    with svc.async_service(window_ms=10_000.0, max_batch=len(rs) + 1,
                           tracer=tr, metrics=reg, resilience=guard) as co:
        rows = [co.submit(r) for r in rs]
        co.drain(timeout=60.0)
        tops = [co.submit_top_k(r, tsvc.TOP_K) for r in rs]
        co.drain(timeout=60.0)
    np.testing.assert_array_equal(
        np.stack([f.result(timeout=60.0) for f in rows]), direct)
    for i, f in enumerate(tops):
        idx, dist = f.result(timeout=60.0)
        np.testing.assert_array_equal(idx, idx_d[i])
        np.testing.assert_array_equal(dist, d_d[i])
    assert tr.open_count == 0 and len(tr.snapshot()[0]) == 2 * len(rs)
    assert list(co.batch_log) == [(0, 1, 2), (3, 4, 5)]
    assert reg.counter("wmd_requests_completed_total").value == 2 * len(rs)
    assert guard.stats().demoted == 0 and guard.stats().retries == 0
