"""The port's resilience layer (`repro_torch.serving.resilience`,
`.faultinject`, `repro_torch.distributed.fault_tolerance`) held to the
contracts of the reference's `tests/test_resilience.py`, on the CPU.

* The breaker, brownout, backoff and watchdog state machines on fake
  clocks and fake engines; retry, demotion and recovery; top-k falling
  back to the scan; the degraded tier; invalid queries never retried;
  the post-check of corrupted results; the impl ladder of the port's
  default service impl ("kernel"), and on a CUDA service a ladder of
  kernel rungs only.
* Parity with the reference: `repro.serving.EngineGuard` and
  `ServingWatchdog` against the port's on one seeded fault schedule,
  policy and fake clock.
* The numeric guards at admission and at high lambda on the port's
  `WMDService(device="cpu")`.
* The seeded chaos suite through the port's `FaultyEngine` and
  `QueryCoalescer`: no deadlock, every future resolves exactly once,
  clean rung-0 answers bitwise a no-fault dispatch of the same batch.

Faults draw from ``default_rng((seed, call_index))``, so a schedule
replays identically regardless of thread timing.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs.sinkhorn_wmd import WMDConfig
from repro_torch.core import guards
from repro_torch.data import make_corpus, zipf_query_stream
from repro_torch.distributed.fault_tolerance import (FaultPolicy,
                                                     ServingWatchdog)
from repro_torch.serving.coalescer import QueryCoalescer
from repro_torch.serving.faultinject import (FaultSchedule, FaultSpec,
                                             FaultyEngine, InjectedFault)
from repro_torch.serving.resilience import (BrownoutController,
                                            CircuitBreaker, DegradedResult,
                                            EngineGuard, ResiliencePolicy,
                                            _default_ladder)
from repro_torch.serving.wmd_service import WMDService

VOCAB, DOCS = 512, 24


def _service(*, lamb=1.0, capacity=64, guards_on=True, seed=0):
    data = make_corpus(vocab_size=VOCAB, embed_dim=32, num_docs=DOCS,
                       num_queries=1, query_words=11, mean_words=12.0,
                       seed=seed)
    cfg = WMDConfig(name="res", vocab_size=VOCAB, embed_dim=32,
                    num_docs=DOCS, nnz_max=64, v_r=16, lamb=lamb, max_iter=8)
    return WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell, device="cpu",
                      cache_capacity=capacity, bound_docs_chunk=None,
                      guards=guards_on)


def _queries(n, seed=0):
    stream = zipf_query_stream(vocab_size=VOCAB, query_words=11, s=1.2,
                               seed=seed)
    return [next(stream) for _ in range(n)]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class FlakyService:
    """Engine stub: fails the first ``fail`` calls per method
    route, records every (method, impl) it was dispatched."""
    impl = "fused"

    def __init__(self, fail=0, n_docs=6):
        self.fail = fail
        self.n_docs = n_docs
        self.calls = []

    def _maybe_fail(self):
        if self.fail > 0:
            self.fail -= 1
            raise RuntimeError("flaky")

    def query_batch(self, rs, impl=None):
        self.calls.append(("query_batch", impl))
        self._maybe_fail()
        return np.ones((len(rs), self.n_docs), np.float32)

    def top_k_batch(self, rs, k=10, prune=False, impl=None):
        self.calls.append(("top_k_batch", "pruned" if prune else "scan",
                           impl))
        self._maybe_fail()
        return (np.zeros((len(rs), k), np.int64),
                np.ones((len(rs), k), np.float32))

    def query_batch_bounds(self, rs):
        self.calls.append(("bounds", None))
        return np.full((len(rs), self.n_docs), 0.5, np.float32)

    def top_k_batch_bounds(self, rs, k=10):
        self.calls.append(("bounds_topk", None))
        return (np.zeros((len(rs), k), np.int64),
                np.full((len(rs), k), 0.5, np.float32))


# ---------------------------------------------------------------------------
# guards: unit level
# ---------------------------------------------------------------------------

def test_validate_query_rejections():
    ok = np.zeros(8, np.float32)
    ok[3] = 1.0
    assert guards.validate_query(ok, 8) is not None
    cases = {
        "wrong length": (np.ones(5, np.float32), 8),
        "2-D": (np.ones((2, 4), np.float32), None),
        "non-finite": (np.array([1, np.nan, 0, 0], np.float32), None),
        "negative": (np.array([1, -1, 0, 0], np.float32), None),
        "all-zero": (np.zeros(8, np.float32), None),
        "non-numeric": (np.array(["a", "b"]), None),
    }
    for name, (bad, v) in cases.items():
        with pytest.raises(guards.InvalidQueryError):
            guards.validate_query(bad, v)


def test_underflow_gate_threshold():
    # gate = lamb * 2 * max_norm >= 149 ln 2 (~103.28)
    assert not guards.underflow_possible(1.0, 7.7)      # every shipped cfg
    assert not guards.underflow_possible(5.0, 7.7)
    assert guards.underflow_possible(30.0, 7.7)
    assert guards.underflow_possible(1.0, 60.0)         # huge embeddings


def test_check_km_rows_masks_pad_rows():
    # (Q=1, v_r=3) row maxes: one real-dead row fires, pad-dead rows don't
    rowmax = np.array([[0.0, 1.0, 0.0]])
    guards.check_km_rows(rowmax, np.array([[0, 1, 0]]))  # dead rows are pad
    with pytest.raises(guards.NumericalError) as ei:
        guards.check_km_rows(rowmax, np.array([[1, 1, 0]]), lamb=42.0)
    assert ei.value.context["check"] == "km_underflow"
    assert ei.value.context["lamb"] == 42.0


def test_check_distances_zero_cells_gated():
    d = np.array([[0.0, 1.0], [2.0, 3.0]], np.float32)
    guards.check_distances(d, risk=False)               # gate off: fine
    with pytest.raises(guards.NumericalError):
        guards.check_distances(d, risk=True)
    # empty docs legitimately solve to 0 even under an armed gate
    guards.check_distances(d, risk=True,
                           empty_doc_mask=np.array([True, False]))
    with pytest.raises(guards.NumericalError):          # non-finite always
        guards.check_distances(np.array([np.inf]), risk=False)


# ---------------------------------------------------------------------------
# breaker / brownout / backoff state machines (fake clocks, no jax)
# ---------------------------------------------------------------------------

def test_circuit_breaker_every_transition():
    clk = FakeClock()
    br = CircuitBreaker(failures=3, cooldown_s=5.0, probes=2, clock=clk)
    assert br.state == "closed" and br.allow()
    br.record_failure()
    br.record_failure()
    assert br.state == "closed"                 # streak below threshold
    br.record_failure()
    assert br.state == "open" and not br.allow()
    clk.advance(5.1)
    assert br.allow() and br.state == "half_open"
    br.record_failure()                         # failed probe -> re-open
    assert br.state == "open"
    clk.advance(5.1)
    assert br.allow() and br.state == "half_open"
    br.record_success()
    assert br.state == "half_open"              # needs 2 probes
    br.record_success()
    assert br.state == "closed"
    assert set(br.transitions) == {("closed", "open"),
                                   ("open", "half_open"),
                                   ("half_open", "open"),
                                   ("half_open", "closed")}


def test_circuit_breaker_success_resets_streak():
    br = CircuitBreaker(failures=2, clock=FakeClock())
    br.record_failure()
    br.record_success()
    br.record_failure()
    assert br.state == "closed"                 # streak was reset


def test_brownout_hysteresis_and_dwell():
    clk = FakeClock()
    bo = BrownoutController(queue_hi=10, queue_lo=2, miss_hi=0.5,
                            miss_lo=0.1, dwell_s=1.0, clock=clk)
    assert not bo.update(5, 0.0)                # below hi
    assert bo.update(10, 0.0) and bo.entries == 1
    clk.advance(0.5)
    assert bo.update(0, 0.0)                    # calm but dwell not served
    clk.advance(0.6)
    assert bo.update(3, 0.0)                    # dwell served, NOT calm yet
    assert not bo.update(2, 0.0)                # calm + dwell -> exit
    assert bo.update(0, 0.9) and bo.entries == 2   # miss signal re-enters
    clk.advance(1.1)
    assert bo.update(0, 0.2)                    # miss still above lo
    assert not bo.update(0, 0.1)


def test_brownout_disabled_without_thresholds():
    bo = BrownoutController(clock=FakeClock())
    assert not bo.update(10 ** 9, 1.0)


def test_backoff_bounded_and_positive():
    g = EngineGuard(FlakyService(), ResiliencePolicy(
        backoff_base_s=0.01, backoff_mult=2.0, backoff_max_s=0.05,
        backoff_jitter=0.5, seed=3), sleep=lambda s: None)
    waits = [g._backoff(a) for a in range(10)]
    assert all(0.0 < w <= 0.05 * 1.5 for w in waits)
    assert waits[1] >= 0.01                     # base grows with attempts


# ---------------------------------------------------------------------------
# fault schedule determinism
# ---------------------------------------------------------------------------

def test_fault_schedule_deterministic_and_windowed():
    s1 = FaultSchedule(seed=5, p_error=0.3, p_latency=0.3, p_corrupt=0.3)
    s2 = FaultSchedule(seed=5, p_error=0.3, p_latency=0.3, p_corrupt=0.3)
    draws1 = [s1.faults_for(i) for i in range(200)]
    assert draws1 == [s2.faults_for(i) for i in range(200)]
    assert any(f.error for f in draws1) and any(f.corrupt for f in draws1)
    assert [s1.faults_for(i) for i in range(200)] == draws1   # stateless
    sw = FaultSchedule(seed=5, p_error=1.0, window=(10, 12))
    assert not sw.faults_for(9).error
    assert sw.faults_for(10).error and sw.faults_for(11).error
    assert not sw.faults_for(12).error


def test_fault_schedule_from_events():
    sched = FaultSchedule.from_events({3: FaultSpec(error=True),
                                       5: FaultSpec(corrupt=True)})
    assert sched.faults_for(3).error
    assert sched.faults_for(5).corrupt
    assert sched.faults_for(4) == FaultSpec()


# ---------------------------------------------------------------------------
# EngineGuard: retry, demotion, recovery, degradation (fake engine)
# ---------------------------------------------------------------------------

def test_retry_recovers_transient_failures():
    svc = FlakyService(fail=2)
    g = EngineGuard(svc, ResiliencePolicy(max_retries=2, breaker_failures=5),
                    sleep=lambda s: None)
    res = g.dispatch("plain", [np.ones(4)] * 2)
    assert isinstance(res, np.ndarray) and res.shape == (2, 6)
    st = g.stats()
    assert st.retries == 2 and st.failures == 2 and st.demoted == 0
    # rung 0 dispatches with impl=None: the exact unguarded call
    assert svc.calls[-1] == ("query_batch", None)


def test_demotion_and_breaker_recovery():
    clk = FakeClock()
    svc = FlakyService(fail=1)
    g = EngineGuard(svc, ResiliencePolicy(
        max_retries=0, breaker_failures=2, breaker_cooldown_s=10.0),
        clock=clk, sleep=lambda s: None)
    res = g.dispatch("plain", [np.ones(4)])
    # retries=0: rung 0 fails once (breaker streak 1), demote to rung 1
    # ("unfused"), which succeeds
    assert isinstance(res, np.ndarray)
    assert ("query_batch", "unfused") in svc.calls
    st = g.stats()
    assert st.demoted == 1
    # fail rung 0 once more -> streak 2 -> breaker opens
    svc.fail = 1
    g.dispatch("plain", [np.ones(4)])
    assert g.stats().breaker_states["plain/0"] == "open"
    # while open, dispatches skip rung 0 entirely
    n_calls = len(svc.calls)
    g.dispatch("plain", [np.ones(4)])
    assert svc.calls[n_calls:] == [("query_batch", "unfused")]
    # cooldown passes: next dispatch probes rung 0 (half_open) and closes
    clk.advance(10.1)
    g.dispatch("plain", [np.ones(4)])
    assert svc.calls[-1] == ("query_batch", None)
    assert g.stats().breaker_states["plain/0"] == "closed"


def test_top_k_ladder_falls_back_to_scan():
    svc = FlakyService(fail=2)                  # pruned rungs: None, unfused
    g = EngineGuard(svc, ResiliencePolicy(max_retries=0, breaker_failures=1,
                                          degrade_on_failure=False),
                    sleep=lambda s: None)
    res = g.dispatch("top_k", [np.ones(4)], k=3)
    assert res[0].shape == (1, 3)
    kinds = [c[1] for c in svc.calls if c[0] == "top_k_batch"]
    assert kinds == ["pruned", "pruned", "scan"]


def test_degraded_when_every_rung_fails():
    svc = FlakyService(fail=100)
    g = EngineGuard(svc, ResiliencePolicy(max_retries=1, breaker_failures=2),
                    sleep=lambda s: None)
    res = g.dispatch("plain", [np.ones(4)] * 3)
    assert isinstance(res, DegradedResult)
    assert res.tier == "rwmd_bound"
    assert "engine_failure" in res.reason and "flaky" in res.reason
    np.testing.assert_array_equal(res.value,
                                  np.full((3, 6), 0.5, np.float32))
    st = g.stats()
    assert st.degraded == 1 and st.degraded_requests == 3


def test_degradation_disabled_raises_last_error():
    svc = FlakyService(fail=100)
    g = EngineGuard(svc, ResiliencePolicy(max_retries=0, breaker_failures=1,
                                          degrade_on_failure=False),
                    sleep=lambda s: None)
    with pytest.raises(RuntimeError, match="flaky"):
        g.dispatch("plain", [np.ones(4)])


def test_invalid_query_never_retried():
    class Rejecting(FlakyService):
        def query_batch(self, rs, impl=None):
            self.calls.append(("query_batch", impl))
            raise guards.InvalidQueryError("bad row")

    svc = Rejecting()
    g = EngineGuard(svc, ResiliencePolicy(max_retries=5),
                    sleep=lambda s: None)
    with pytest.raises(guards.InvalidQueryError):
        g.dispatch("plain", [np.ones(4)])
    assert len(svc.calls) == 1                  # no retry, no demotion
    assert g.stats().retries == 0


def test_guard_post_check_catches_corruption():
    class Corrupting(FlakyService):
        def query_batch(self, rs, impl=None):
            self.calls.append(("query_batch", impl))
            out = np.ones((len(rs), self.n_docs), np.float32)
            if len(self.calls) == 1:            # only the first dispatch
                out[0, 0] = np.nan
            return out

    svc = Corrupting()
    g = EngineGuard(svc, ResiliencePolicy(max_retries=2, breaker_failures=5),
                    sleep=lambda s: None)
    res = g.dispatch("plain", [np.ones(4)])
    assert np.isfinite(res).all()               # retry returned clean data
    assert g.stats().retries == 1


def test_brownout_dispatch_serves_bounds_and_recovers():
    clk = FakeClock()
    svc = FlakyService()
    g = EngineGuard(svc, ResiliencePolicy(
        brownout_queue_hi=4, brownout_queue_lo=1, brownout_dwell_s=1.0),
        clock=clk, sleep=lambda s: None)
    res = g.dispatch("plain", [np.ones(4)], queue_depth=10)
    assert isinstance(res, DegradedResult) and res.reason == "brownout"
    clk.advance(1.1)
    res = g.dispatch("plain", [np.ones(4)], queue_depth=0)
    assert isinstance(res, np.ndarray)          # calm + dwell: exact again
    assert g.stats().brownout_entries == 1


def test_trip_force_opens_active_rung():
    svc = FlakyService()
    g = EngineGuard(svc, ResiliencePolicy(), sleep=lambda s: None)
    g.trip("plain")
    assert g.stats().breaker_states["plain/0"] == "open"
    g.dispatch("plain", [np.ones(4)])           # served by rung 1
    assert svc.calls[-1] == ("query_batch", "unfused")
    g.trip("plain")                             # next non-open rung
    assert g.stats().breaker_states["plain/1"] == "open"


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------

def test_watchdog_straggler_strikes_trip():
    clk = FakeClock()
    tripped = []
    wd = ServingWatchdog(FaultPolicy(straggler_factor=2.0,
                                     straggler_strikes=3),
                         on_strike=tripped.append, min_samples=3, clock=clk)
    for _ in range(5):
        wd.beat("plain", 0.01, True)            # establish the median
    for _ in range(2):
        wd.beat("plain", 0.1, True)             # 2 strikes: below threshold
    assert tripped == []
    wd.beat("plain", 0.01, True)                # fast beat resets the streak
    for _ in range(3):
        wd.beat("plain", 0.1, True)
    assert tripped == ["plain"]                 # 3 consecutive -> trip
    assert wd.report()["plain"]["tripped"] == 1


def test_watchdog_failures_count_as_strikes():
    tripped = []
    wd = ServingWatchdog(FaultPolicy(straggler_strikes=2),
                         on_strike=tripped.append, clock=FakeClock())
    wd.beat("top_k", 0.01, False)
    wd.beat("top_k", 0.01, False)
    assert tripped == ["top_k"]
    assert wd.report()["top_k"]["failures"] == 2


def test_watchdog_liveness_needs_pending_work():
    clk = FakeClock()
    pending = {"n": 0}
    wd = ServingWatchdog(FaultPolicy(timeout_s=5.0),
                         pending_fn=lambda: pending["n"], clock=clk)
    wd.beat("plain", 0.01, True)
    clk.advance(10.0)
    assert wd.check() == []                     # idle silence is fine
    pending["n"] = 3
    assert wd.check() == ["plain"]              # silent with a backlog
    wd.beat("plain", 0.01, True)
    assert wd.check() == []


# ---------------------------------------------------------------------------
# admission validation at the coalescer
# ---------------------------------------------------------------------------

def test_admission_quarantines_bad_queries():
    svc = _service()
    with svc.async_service(window_ms=1.0, max_batch=4) as co:
        good = _queries(3)
        bad = [np.full(VOCAB, np.nan, np.float32),
               -np.ones(VOCAB, np.float32),
               np.zeros(VOCAB, np.float32),
               np.ones(7, np.float32)]
        futs = [co.submit(q) for q in good]
        for b in bad:
            with pytest.raises(guards.InvalidQueryError):
                co.submit(b)
        rows = [f.result(timeout=60) for f in futs]
    st = co.stats()
    assert st.quarantined == len(bad)
    assert st.completed == len(good) and st.failed == 0
    assert all(np.isfinite(r).all() for r in rows)
    # quarantined requests never reached a dispatch
    assert sum(len(b) for b in co.batch_log) == len(good)


def test_fake_services_keep_light_validation():
    class Fake:
        def query_batch(self, rs):
            return np.zeros((len(rs), 2), np.float32)

    co = QueryCoalescer(Fake(), window_ms=1.0, max_batch=2)
    try:
        f = co.submit(np.zeros(4, np.float32))   # all-zero: fine for fakes
        f.result(timeout=10)
        with pytest.raises(guards.InvalidQueryError):
            co.submit(np.full(4, np.inf, np.float32))   # non-finite: not
    finally:
        co.shutdown()


# ---------------------------------------------------------------------------
# high-lambda underflow: typed error vs the old silent-zero behavior
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["kernel", "fused", "unfused"])
@pytest.mark.parametrize("capacity", [0, 64])
def test_high_lambda_raises_numerical_error(impl, capacity):
    svc = _service(lamb=30.0, capacity=capacity)
    svc.impl = impl
    qs = _queries(4, seed=1)
    with pytest.raises(guards.NumericalError) as ei:
        svc.query_batch(qs)
    assert ei.value.context["check"] in ("km_underflow", "zero_distance")
    # the old behavior, pinned: guards off -> silent exact-zero distances
    svc.guards = False
    d = svc.query_batch(qs)
    assert np.isfinite(d).all() and (d == 0.0).any()


def test_default_lambda_unchanged_by_guards():
    qs = _queries(4, seed=2)
    d_on = _service(guards_on=True).query_batch(qs)
    d_off = _service(guards_on=False).query_batch(qs)
    np.testing.assert_array_equal(d_on, d_off)  # guards are read-only


def test_degraded_tier_survives_high_lambda():
    # lambda kills the exact tier but not the bound tier (M has no exp):
    # the resilient path keeps answering, degraded
    svc = _service(lamb=30.0)
    g = EngineGuard(svc, ResiliencePolicy(max_retries=0, breaker_failures=1),
                    sleep=lambda s: None)
    res = g.dispatch("plain", _queries(2, seed=3))
    assert isinstance(res, DegradedResult)
    assert np.isfinite(res.value).all()


# ---------------------------------------------------------------------------
# chaos suite: the serving loop under a seeded fault schedule
# ---------------------------------------------------------------------------

CHAOS_POLICY = ResiliencePolicy(
    max_retries=3, breaker_failures=4, breaker_cooldown_s=0.05,
    backoff_base_s=0.001, backoff_max_s=0.01, seed=0)


def _run_chaos(svc, qs, schedule, *, policy=CHAOS_POLICY, top_k=None,
               window_ms=1.0, max_batch=4, concurrency=0):
    eng = FaultyEngine(svc, schedule)
    co = QueryCoalescer(eng, window_ms=window_ms, max_batch=max_batch,
                        resilience=policy)
    futs = []
    try:
        if concurrency:
            from repro_torch.serving.loadgen import closed_loop
            submit = (co.submit if top_k is None
                      else lambda r: co.submit_top_k(r, top_k))
            lg = closed_loop(submit, qs, concurrency=concurrency,
                             keep_results=True)
            return co, eng, lg, None
        submit = (co.submit if top_k is None
                  else lambda r: co.submit_top_k(r, top_k))
        futs = [submit(q) for q in qs]
        co.drain(timeout=120.0)                 # the no-deadlock assertion
        return co, eng, None, futs
    finally:
        co.shutdown(drain=True, timeout=120.0)


def test_chaos_no_deadlock_every_future_resolves_bitwise():
    svc = _service()
    qs = _queries(48, seed=4)
    sched = FaultSchedule(seed=11, p_error=0.2, p_latency=0.15,
                          p_corrupt=0.1, latency_s=0.005)
    co, eng, _, futs = _run_chaos(svc, qs, sched)
    # every submitted future resolved exactly once, with a result
    assert all(f.done() for f in futs)
    exact = degraded = 0
    for f in futs:
        assert f.exception() is None
        r = f.result()
        if isinstance(r, DegradedResult):
            degraded += 1
            r = r.value
        else:
            exact += 1
        assert r.shape == (DOCS,) and np.isfinite(r).all()
    st = co.stats()
    assert st.completed == len(qs) and st.failed == 0
    availability = (st.submitted - st.failed) / st.submitted
    assert availability >= 0.99
    assert st.degraded == degraded
    assert st.degraded_fraction == degraded / len(qs)
    assert eng.injected["error"] > 0            # the schedule actually bit
    # bitwise contract: every clean rung-0 dispatch the injector saw must
    # equal a no-fault dispatch of the same composition on a clean service
    clean = _service()
    replayed = 0
    for rec in eng.dispatch_log:
        if (rec.method == "query_batch" and rec.result is not None
                and not rec.fault.corrupt and "impl" not in rec.kwargs):
            np.testing.assert_array_equal(
                rec.result, clean.query_batch(rec.payloads))
            replayed += 1
    assert replayed > 0


def test_chaos_closed_loop_top_k():
    svc = _service()
    qs = _queries(24, seed=5)
    sched = FaultSchedule(seed=13, p_error=0.15, p_corrupt=0.1)
    co, eng, lg, _ = _run_chaos(svc, qs, sched, top_k=5, concurrency=3)
    assert lg.submitted == len(qs)
    assert lg.completed + lg.failed == len(qs)
    assert lg.completed / lg.submitted >= 0.99
    st = co.stats()
    assert st.completed == lg.completed
    for res in lg.results:
        if isinstance(res, DegradedResult):
            res = res.value
        idx, dist = res
        assert idx.shape == (5,) and np.isfinite(dist).all()


def test_chaos_open_loop_poisson():
    """Open-loop Poisson arrivals through the injector: offered load does
    not pause for faults, yet availability holds."""
    from repro_torch.serving.loadgen import open_loop
    svc = _service()
    qs = _queries(24, seed=10)
    eng = FaultyEngine(svc, FaultSchedule(seed=29, p_error=0.2,
                                          p_corrupt=0.1))
    co = QueryCoalescer(eng, window_ms=1.0, max_batch=4,
                        resilience=CHAOS_POLICY)
    try:
        lg = open_loop(co.submit, iter(qs), rate_qps=2000.0,
                       keep_results=True)
    finally:
        co.shutdown(drain=True, timeout=120.0)
    assert lg.submitted == len(qs)
    assert lg.completed + lg.failed == len(qs)
    assert lg.completed / lg.submitted >= 0.99
    for res in lg.results:
        if isinstance(res, DegradedResult):
            res = res.value
        assert np.isfinite(res).all()


def test_chaos_fault_storm_recovers():
    """A 100%-error storm window opens breakers and serves degraded; after
    the storm (and the breaker cooldown), probes close the breakers and
    exact serving resumes."""
    svc = _service()
    qs = _queries(40, seed=6)
    # calls 4..16 all fail -- enough to burn every rung's retry budget
    sched = FaultSchedule(seed=17, p_error=1.0, window=(4, 16))
    policy = dataclasses.replace(CHAOS_POLICY, max_retries=1,
                                 breaker_failures=2,
                                 breaker_cooldown_s=0.02)
    eng = FaultyEngine(svc, sched)
    co = QueryCoalescer(eng, window_ms=1.0, max_batch=4, resilience=policy)
    try:
        futs = [co.submit(q) for q in qs]
        co.drain(timeout=120.0)
        assert all(f.done() and f.exception() is None for f in futs)
        assert any(isinstance(f.result(), DegradedResult) for f in futs)
        time.sleep(0.05)                        # > cooldown: breakers cool
        eng.schedule = FaultSchedule()          # storm over
        post = [co.submit(q) for q in _queries(4, seed=60)]
        co.drain(timeout=120.0)
        for f in post:                          # exact serving resumed
            assert isinstance(f.result(), np.ndarray)
    finally:
        co.shutdown(drain=True, timeout=120.0)
    st = co.stats()
    assert st.completed == len(qs) + 4 and st.failed == 0
    assert st.breaker_transitions >= 2          # open + recovery


def test_chaos_brownout_integration():
    """Latency injection builds a backlog; the brownout controller flips
    the coalescer to bound-only responses (marked, counted, bitwise equal
    to a bounds replay of the same composition) until the queue clears."""
    svc = _service()
    qs = _queries(24, seed=7)
    sched = FaultSchedule(seed=19, p_latency=1.0, latency_s=0.02)
    policy = dataclasses.replace(CHAOS_POLICY, brownout_queue_hi=2,
                                 brownout_queue_lo=0, brownout_dwell_s=0.0)
    co, eng, _, futs = _run_chaos(svc, qs, sched, policy=policy,
                                  window_ms=30.0)
    assert all(f.done() and f.exception() is None for f in futs)
    st = co.stats()
    assert st.completed == len(qs) and st.failed == 0
    assert st.degraded > 0
    assert co.guard.stats().brownout_entries >= 1
    # degraded responses are bitwise a bounds dispatch of the same batch
    clean = _service()
    seq_to_q = dict(enumerate(qs))
    degraded_checked = 0
    for batch in co.batch_log:
        rows = [futs[s].result() for s in batch]
        if not all(isinstance(r, DegradedResult) for r in rows):
            continue
        ref = clean.query_batch_bounds([seq_to_q[s] for s in batch])
        for i, r in enumerate(rows):
            np.testing.assert_array_equal(r.value, ref[i])
            assert r.tier == "rwmd_bound" and r.reason == "brownout"
            degraded_checked += 1
    assert degraded_checked > 0


def test_chaos_stats_clean_run_has_no_resilience_noise():
    svc = _service()
    qs = _queries(8, seed=8)
    co, eng, _, futs = _run_chaos(svc, qs, FaultSchedule())   # no faults
    st = co.stats()
    assert st.retries == 0 and st.degraded == 0 and st.quarantined == 0
    assert st.breaker_transitions == 0 and not st.brownout_active
    # and fault-free resilient serving is bitwise the plain engine
    clean = _service()
    for rec in eng.dispatch_log:
        np.testing.assert_array_equal(
            rec.result, clean.query_batch(rec.payloads))


def test_faulty_engine_protects_bounds_tier():
    svc = FlakyService()
    eng = FaultyEngine(svc, FaultSchedule(seed=1, p_error=1.0))
    with pytest.raises(InjectedFault):
        eng.query_batch([np.ones(4)])
    # bounds are exempt from injection by default (the brownout fallback
    # must stay reliable while the exact tier burns)
    np.testing.assert_array_equal(eng.query_batch_bounds([np.ones(4)]),
                                  np.full((1, 6), 0.5, np.float32))


def test_dispatcher_survives_concurrent_chaos_submitters():
    """Multiple client threads + faults: no deadlock, exact accounting."""
    svc = _service()
    qs = _queries(30, seed=9)
    eng = FaultyEngine(svc, FaultSchedule(seed=23, p_error=0.2))
    co = QueryCoalescer(eng, window_ms=1.0, max_batch=4,
                        resilience=CHAOS_POLICY)
    futs = [None] * len(qs)

    def client(lo, hi):
        for i in range(lo, hi):
            futs[i] = co.submit(qs[i])

    threads = [threading.Thread(target=client, args=(i * 10, (i + 1) * 10))
               for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    try:
        co.drain(timeout=120.0)
    finally:
        co.shutdown(drain=True, timeout=120.0)
    assert all(f is not None and f.done() for f in futs)
    st = co.stats()
    assert st.submitted == len(qs)
    assert st.completed + st.failed == len(qs)
    assert st.completed / st.submitted >= 0.99


# ---------------------------------------------------------------------------
# the port's ladder
# ---------------------------------------------------------------------------

def test_default_ladder_follows_the_service_impl():
    assert _default_ladder("kernel") == (None, "fused", "unfused")
    assert _default_ladder("fused") == (None, "unfused")
    assert _default_ladder("unfused") == (None,)
    assert _default_ladder("other") == (None,)
    g = EngineGuard(_service(), ResiliencePolicy())
    assert set(g.stats().breaker_states) == {
        "plain/0", "plain/1", "plain/2",
        "top_k/0", "top_k/1", "top_k/2", "top_k/3"}


def test_guarded_demotion_on_the_service_keeps_the_answer():
    """Rung 0 (the service default, "kernel": the plain versions on the
    CPU) failing once demotes to "fused": counted, and the same answer
    within the engine tolerance (the two spell the contraction
    differently)."""
    svc = _service()
    qs = _queries(4, seed=12)
    eng = FaultyEngine(svc, FaultSchedule.from_events(
        {0: FaultSpec(error=True)}))
    g = EngineGuard(eng, ResiliencePolicy(max_retries=0, breaker_failures=5),
                    sleep=lambda s: None)
    res = g.dispatch("plain", qs)
    st = g.stats()
    assert st.demoted == 1 and st.degraded == 0 and st.failures == 1
    assert eng.dispatch_log[-1].kwargs == {"impl": "fused"}
    np.testing.assert_allclose(res, _service().query_batch(qs),
                               rtol=2e-3, atol=1e-5)


class CardService(FlakyService):
    """`FlakyService` that says it lives on the card, as a CUDA
    `WMDService` does (the guard reads ``svc.device``)."""
    impl = "kernel"
    device = torch.device("cuda")


def test_card_ladder_holds_only_kernel_rungs():
    """On a CUDA service "fused" / "unfused" would run the plain PyTorch
    versions, so the guard's ladder is rung 0 (and the scan route for
    top-k); an explicit ladder naming a plain impl is refused."""
    g = EngineGuard(CardService(), ResiliencePolicy())
    assert set(g.stats().breaker_states) == {"plain/0", "top_k/0",
                                             "top_k/1"}
    g = EngineGuard(CardService(), ResiliencePolicy(
        impl_ladder=(None, "kernel")))
    assert set(g.stats().breaker_states) == {
        "plain/0", "plain/1", "top_k/0", "top_k/1", "top_k/2"}
    for ladder in ((None, "fused"), ("unfused",)):
        with pytest.raises(ValueError, match="on the card"):
            EngineGuard(CardService(), ResiliencePolicy(impl_ladder=ladder))


@pytest.mark.parametrize("degrade", [True, False])
def test_card_guard_failures_reach_no_plain_rung(degrade):
    """Rung-0 errors, a watchdog trip and a failing pruned route on a card
    service: every exact call keeps the service impl (the kernels); past
    the kernel rungs the dispatch is the bound tier or the last error."""
    svc = CardService(fail=100)
    g = EngineGuard(svc, ResiliencePolicy(max_retries=1, breaker_failures=2,
                                          degrade_on_failure=degrade),
                    sleep=lambda s: None)
    for kind, k in (("plain", None), ("top_k", 3)):
        if degrade:
            res = g.dispatch(kind, [np.ones(4)], k=k)
            assert isinstance(res, DegradedResult)
            assert "engine_failure" in res.reason
        else:
            with pytest.raises(RuntimeError, match="flaky"):
                g.dispatch(kind, [np.ones(4)], k=k)
    assert [c for c in svc.calls if c[0] in ("query_batch", "top_k_batch")
            and c[-1] is not None] == []
    kinds = [c[1] for c in svc.calls if c[0] == "top_k_batch"]
    assert kinds == ["pruned", "pruned", "scan", "scan"]
    # a straggler trip opens rung 0; with the only plain rung open the
    # dispatch is the bound tier, never a plain impl
    svc = CardService()
    g = EngineGuard(svc, ResiliencePolicy(degrade_on_failure=degrade),
                    sleep=lambda s: None)
    wd = ServingWatchdog(FaultPolicy(straggler_strikes=1),
                         on_strike=g.trip, clock=FakeClock())
    wd.beat("plain", 0.01, False)
    assert g.stats().breaker_states["plain/0"] == "open"
    if degrade:
        assert isinstance(g.dispatch("plain", [np.ones(4)]), DegradedResult)
        assert svc.calls == [("bounds", None)]
    else:
        with pytest.raises(RuntimeError, match="every rung breaker"):
            g.dispatch("plain", [np.ones(4)])
        assert svc.calls == []
    assert g.stats().demoted == 0


# ---------------------------------------------------------------------------
# parity with the reference: the guard and the watchdog on one schedule
# ---------------------------------------------------------------------------

class ParityEngine:
    """Deterministic numpy engine whose answers depend on the payloads
    only, so two guards' results can be compared cell for cell."""
    impl = "kernel"
    n_docs = 5

    def query_batch(self, rs, impl=None):
        base = np.stack([np.asarray(r, np.float32) for r in rs]).sum(1)
        shift = {None: 0.0, "fused": 0.25, "unfused": 0.5}[impl]
        return (base[:, None] + np.arange(self.n_docs, dtype=np.float32)
                + np.float32(shift))

    def top_k_batch(self, rs, k=10, prune=False, impl=None):
        d = self.query_batch(rs, impl=impl) + np.float32(0 if prune else 1)
        return np.argsort(d, axis=1)[:, :k], np.sort(d, axis=1)[:, :k]

    def query_batch_bounds(self, rs):
        return self.query_batch(rs) * np.float32(0.5)

    def top_k_batch_bounds(self, rs, k=10):
        d = self.query_batch_bounds(rs)
        return np.argsort(d, axis=1)[:, :k], np.sort(d, axis=1)[:, :k]


def _outcome(res):
    """A dispatch's answer, comparable across the two packages."""
    if isinstance(res, BaseException):
        return ("raised", type(res).__name__, str(res))
    degraded = type(res).__name__ == "DegradedResult"
    val = res.value if degraded else res
    cells = tuple(np.asarray(a).tobytes() for a in (
        val if isinstance(val, tuple) else (val,)))
    return ("degraded", res.reason, res.tier, cells) if degraded \
        else ("exact", cells)


def _guard_session(serving, resilience, faultinject, ft, obs, policy_kw):
    """One seeded session through a package's FaultyEngine, EngineGuard and
    ServingWatchdog on a fake clock: mixed plain / top-k batches, queue
    depths that enter and leave brownout, engine faults, retries with
    backoff, watchdog strikes tripping the guard."""
    clk = FakeClock()
    sleeps = []

    def sleep(dt):
        sleeps.append(dt)
        clk.advance(dt)

    sched = faultinject.FaultSchedule(seed=5, p_error=0.3, p_latency=0.2,
                                      p_corrupt=0.1, latency_s=0.05,
                                      window=(0, 150))
    eng = faultinject.FaultyEngine(ParityEngine(), sched, sleep=sleep)
    tracer = obs.Tracer(clock=clk)
    guard = resilience.EngineGuard(
        eng, resilience.ResiliencePolicy(**policy_kw), clock=clk,
        sleep=sleep, tracer=tracer)
    wd = ft.ServingWatchdog(ft.FaultPolicy(straggler_factor=2.0,
                                           straggler_strikes=2),
                            on_strike=guard.trip, min_samples=3, clock=clk,
                            tracer=tracer)
    rng = np.random.default_rng(17)
    outcomes = []
    for step in range(160):
        kind = "top_k" if rng.random() < 0.4 else "plain"
        n = int(rng.integers(1, 5))
        payloads = [rng.random(4).astype(np.float32) for _ in range(n)]
        depth = int(rng.integers(0, 20)) if step % 40 >= 30 else 0
        t0 = clk()
        try:
            res = guard.dispatch(kind, payloads, k=3 if kind == "top_k"
                                 else None, queue_depth=depth,
                                 miss_ewma=float(rng.random()) * 0.2)
            ok = True
        except Exception as e:          # noqa: BLE001
            res, ok = e, False
        wd.beat(kind, clk() - t0 + 0.01, ok)
        outcomes.append(_outcome(res))
        clk.advance(float(rng.exponential(0.3)))
    events = list(tracer.events)
    return {"outcomes": outcomes, "dispatch_log": list(guard.dispatch_log),
            "stats": dataclasses.asdict(guard.stats()),
            "transitions": {key: list(br.transitions)
                            for key, br in sorted(guard._breakers.items())},
            "sleeps": sleeps, "injected": dict(eng.injected),
            "engine_log": [(c.idx, c.method, c.kwargs)
                           for c in eng.dispatch_log],
            "watchdog": wd.report(), "events": events}


@pytest.mark.parametrize("policy_kw", [
    dict(max_retries=1, breaker_failures=2, breaker_cooldown_s=1.0,
         breaker_probes=2, seed=7, brownout_queue_hi=12,
         brownout_queue_lo=3, brownout_miss_hi=0.19, brownout_miss_lo=0.05,
         brownout_dwell_s=0.5),
    dict(max_retries=0, breaker_failures=1, breaker_cooldown_s=3.0,
         degrade_on_failure=False, seed=3),
], ids=["brownout", "no_degrade"])
def test_guard_and_watchdog_match_the_reference(policy_kw):
    """`repro.serving.EngineGuard` and the port's, each over its package's
    `FaultyEngine` with one seeded schedule, policy and fake clock: the
    same answers, dispatch log, stats, breaker transitions, backoff
    sleeps, engine calls, watchdog report and trace events."""
    import repro.distributed.fault_tolerance as ref_ft
    import repro.obs as ref_obs
    import repro.serving as ref_serving
    import repro.serving.faultinject as ref_fi
    import repro.serving.resilience as ref_res
    import repro_torch.distributed.fault_tolerance as ft
    import repro_torch.obs as obs
    import repro_torch.serving as serving
    import repro_torch.serving.faultinject as fi
    import repro_torch.serving.resilience as res
    ref = _guard_session(ref_serving, ref_res, ref_fi, ref_ft, ref_obs,
                         policy_kw)
    port = _guard_session(serving, res, fi, ft, obs, policy_kw)
    for key in ref:
        assert port[key] == ref[key], key
    st = port["stats"]
    # the session reaches every branch it is meant to compare
    assert st["retries"] + st["demoted"] > 0 and st["breaker_transitions"]
    assert port["watchdog"]["plain"]["tripped"] > 0
    if policy_kw.get("degrade_on_failure", True):
        assert st["brownout_entries"] > 0 and st["degraded"] > 0
    else:
        assert any(o[0] == "raised" for o in port["outcomes"])


def test_watchdog_matches_the_reference_on_one_beat_sequence():
    """The reference's `ServingWatchdog` and the port's on one seeded
    sequence of beats and liveness polls: the same strikes, stalls and
    report."""
    import repro.distributed.fault_tolerance as ref_ft
    import repro_torch.distributed.fault_tolerance as ft

    def session(mod):
        clk = FakeClock()
        trips, pending = [], {"n": 0}
        wd = mod.ServingWatchdog(
            mod.FaultPolicy(timeout_s=2.0, straggler_factor=1.5,
                            straggler_strikes=3),
            on_strike=trips.append, pending_fn=lambda: pending["n"],
            min_samples=4, clock=clk)
        rng = np.random.default_rng(23)
        stalls = []
        for _ in range(400):
            kind = ("plain", "top_k", "bounds")[int(rng.integers(0, 3))]
            wall = float(rng.lognormal(-4.0, 0.6))
            wd.beat(kind, wall, bool(rng.random() > 0.05))
            clk.advance(float(rng.exponential(0.8)))
            pending["n"] = int(rng.integers(0, 3))
            stalls.append(wd.check())
        return trips, stalls, wd.report()

    ref, port = session(ref_ft), session(ft)
    assert port == ref
    assert ref[0] and any(ref[1])       # strikes and stalls both happened


# ---------------------------------------------------------------------------
# the rest of the ported modules: heartbeat monitor, crash injector
# ---------------------------------------------------------------------------

def test_heartbeat_monitor_detects_death_and_stragglers():
    from repro_torch.distributed.fault_tolerance import HeartbeatMonitor
    clock = {"t": 0.0}
    mon = HeartbeatMonitor(4, FaultPolicy(timeout_s=10, straggler_factor=2,
                                          straggler_strikes=2),
                           clock=lambda: clock["t"])
    mon.set_median_step(1.0)
    for t in range(5):
        clock["t"] = float(t)
        for h in range(4):
            if h == 3 and t >= 2:
                continue                       # host 3 goes silent at t=2
            mon.heartbeat(h, t, step_seconds=5.0 if h == 2 else 1.0)
    clock["t"] = 12.0
    assert mon.dead_hosts() == [3]
    assert mon.respawn_candidates() == [2]
    assert mon.surviving() == 3


def test_crash_injector_target_and_seeded_modes():
    from repro_torch.serving.faultinject import CrashInjector, InjectedCrash
    dry = CrashInjector()
    for name in ("wal.append", "wal.fsync", "compact.swap", "wal.append"):
        dry(name)
    assert dry.count == 4 and dry.crashed_at is None
    hook = CrashInjector(target=1, match="wal")
    hook("wal.append")
    hook("compact.swap")                       # filtered out, not counted
    with pytest.raises(InjectedCrash):
        hook("wal.fsync")
    assert hook.crashed_at == (1, "wal.fsync") and hook.log == [
        "wal.append", "wal.fsync"]
    assert not issubclass(InjectedCrash, Exception)

    def sweep(seed):
        h = CrashInjector(seed=seed, p_crash=0.3)
        for i in range(50):
            try:
                h(f"b{i}")
            except InjectedCrash:
                return h.crashed_at
    assert sweep(4) == sweep(4) is not None
