"""Deterministic fault injection at the engine boundary -- the chaos
suite's substrate. A copy of `repro.serving.faultinject`. TEST-ONLY by
contract: nothing in the serving stack imports this module; production
code must never see a `FaultyEngine`.

`FaultyEngine` wraps a `WMDService`-shaped object and intercepts the three
exact-tier entry points (``query_batch``, ``top_k_batch``, ``query``),
injecting, per intercepted call:

  error    -- raise `InjectedFault` instead of dispatching (a transient
              dispatch exception: the retry/breaker path's food);
  latency  -- sleep before dispatching (a straggler: the watchdog's and
              deadline-miss machinery's food);
  corrupt  -- dispatch normally, then overwrite one result cell with NaN
              (a silent numeric fault: the guard layer's food -- the
              `EngineGuard` post-check turns it into a retryable failure).

The degraded tier (``query_batch_bounds`` / ``top_k_batch_bounds``) and
everything else forward untouched by default (``protect`` lists the names
exempt from interception), so brownout fallbacks stay reliable while the
exact tier burns -- flip ``protect=()`` to chaos-test the fallback too.

Determinism: faults are drawn per *call index*, not per wall-clock --
``rng = default_rng((seed, idx))`` -- so a schedule replays identically
regardless of thread timing, and a retried dispatch (a NEW call index)
legitimately sees fresh luck. `FaultSchedule.from_events` pins exact
faults to exact call indices for state-machine tests that cannot tolerate
probability.

``dispatch_log`` records (idx, method, fault, payloads, result) for every
intercepted call; the chaos suite replays the non-faulted compositions
directly against a clean service to assert the bitwise no-fault contract.

`CrashInjector` + `InjectedCrash` are the *data-path* counterpart: where
`FaultyEngine` injects query-side faults at the engine boundary, the
crash injector kills the writer at the live corpus's WAL / snapshot /
compaction boundaries (hook-based, seeded per boundary index with the
same ``default_rng((seed, idx))`` determinism) so the ingest chaos suite
can assert crash-consistent recovery at every single kill site
(`data.live_corpus.LiveCorpus`, `data.wal.WalWriter`).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Mapping

import numpy as np


class InjectedFault(RuntimeError):
    """A fault raised by the injector (never by the real engine)."""


class InjectedCrash(BaseException):
    """A simulated process kill (kill -9) raised at a crash boundary.

    Deliberately a BaseException, not an Exception: a real kill gives no
    code the chance to clean up, so an injected one must sail through
    every ``except Exception`` recovery handler in the write path --
    anything those handlers would have repaired must instead be repaired
    by *recovery from disk*, which is the property the chaos suite
    asserts. Only the test harness (and the corpus lock's ``finally``
    unwinding, which a real kill also cannot prevent from mattering --
    the process is gone either way) may catch it."""


class CrashInjector:
    """Counting crash-point hook for the live corpus's write boundaries.

    The corpus calls ``hook(name)`` at every WAL / snapshot / compaction
    boundary (`data.wal.WalWriter` and `data.live_corpus.LiveCorpus` list
    them). This hook counts the calls and raises `InjectedCrash` at a
    chosen one, in either of two modes:

      * **target mode** -- ``CrashInjector(target=i)`` crashes at exactly
        the i-th boundary crossed (after ``match`` filtering). With
        ``target=None`` nothing ever crashes and the hook is a pure
        counter: the dry-run pass the chaos suite uses to *enumerate* the
        boundaries of an op sequence before sweeping a crash over every
        single one.
      * **seeded mode** -- ``CrashInjector(seed=s, p_crash=p)`` draws the
        crash decision per boundary index from ``default_rng((seed,
        idx))``, the same replay-deterministic rule as `FaultSchedule`:
        a schedule replays identically regardless of thread timing.

    ``match`` restricts counting (and crashing) to boundaries whose name
    contains the substring -- e.g. ``match="compact"`` sweeps compaction
    boundaries only. ``log`` records every counted boundary name, so a
    failing sweep names the exact kill site.
    """

    def __init__(self, target: int | None = None, *, seed: int | None = None,
                 p_crash: float = 0.0, match: str | None = None):
        self.target = target
        self.seed = seed
        self.p_crash = p_crash
        self.match = match
        self.count = 0
        self.log: list[str] = []
        self.crashed_at: tuple[int, str] | None = None

    def __call__(self, name: str) -> None:
        if self.match is not None and self.match not in name:
            return
        idx = self.count
        self.count += 1
        self.log.append(name)
        crash = idx == self.target if self.target is not None else (
            self.seed is not None and self.p_crash > 0.0
            and np.random.default_rng((self.seed, idx)).random()
            < self.p_crash)
        if crash:
            self.crashed_at = (idx, name)
            raise InjectedCrash(f"injected crash at boundary {idx} ({name})")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """What to inject into one intercepted call."""
    error: bool = False
    latency_s: float = 0.0
    corrupt: bool = False


_NO_FAULT = FaultSpec()


class FaultSchedule:
    """Seeded per-call-index fault draws.

    Probabilistic mode: each intercepted call ``idx`` draws error /
    latency / corruption independently from ``default_rng((seed, idx))``
    -- deterministic in the call index alone. Event mode
    (`from_events`): an explicit {idx: FaultSpec} table, everything else
    fault-free. ``window`` restricts the probabilistic mode to
    ``start <= idx < stop`` (fault storms with clean ramp-in/out)."""

    def __init__(self, *, seed: int = 0, p_error: float = 0.0,
                 p_latency: float = 0.0, p_corrupt: float = 0.0,
                 latency_s: float = 0.02,
                 window: tuple[int, int | None] = (0, None)):
        self.seed = seed
        self.p_error = p_error
        self.p_latency = p_latency
        self.p_corrupt = p_corrupt
        self.latency_s = latency_s
        self.window = window
        self._events: Mapping[int, FaultSpec] | None = None

    @classmethod
    def from_events(cls, events: Mapping[int, FaultSpec]) -> "FaultSchedule":
        """Exact-fault schedule: call ``idx`` gets ``events[idx]``, every
        other call is clean. For breaker/brownout state-machine tests."""
        sched = cls()
        sched._events = dict(events)
        return sched

    def faults_for(self, idx: int) -> FaultSpec:
        if self._events is not None:
            return self._events.get(idx, _NO_FAULT)
        lo, hi = self.window
        if idx < lo or (hi is not None and idx >= hi):
            return _NO_FAULT
        draws = np.random.default_rng((self.seed, idx)).random(3)
        return FaultSpec(
            error=bool(draws[0] < self.p_error),
            latency_s=self.latency_s if draws[1] < self.p_latency else 0.0,
            corrupt=bool(draws[2] < self.p_corrupt))


@dataclasses.dataclass
class _Call:
    """One intercepted call, as recorded in ``dispatch_log``."""
    idx: int
    method: str
    fault: FaultSpec
    payloads: list
    kwargs: dict
    result: object          # None when the call raised


class FaultyEngine:
    """Engine-boundary fault injector. See the module docstring.

    Duck-types the service: intercepted methods are defined explicitly,
    everything else (``query_batch_bounds``, ``last_batch_stats``,
    ``impl``, ``cfg``, ...) forwards via ``__getattr__`` so the coalescer,
    `EngineGuard`, and warmup all treat it as the service itself."""

    INTERCEPTED = ("query_batch", "top_k_batch", "query")

    def __init__(self, svc, schedule: FaultSchedule, *,
                 protect: tuple[str, ...] = ("query_batch_bounds",
                                             "top_k_batch_bounds"),
                 sleep: Callable[[float], None] = time.sleep,
                 log_size: int = 65536):
        self._svc = svc
        self.schedule = schedule
        self.protect = protect          # informational: these never inject
        self._sleep = sleep
        self._lock = threading.Lock()
        self._calls = 0
        self.injected = {"error": 0, "latency": 0, "corrupt": 0}
        self.dispatch_log: list[_Call] = []
        self._log_size = log_size

    def __getattr__(self, name):
        return getattr(self._svc, name)

    @property
    def calls(self) -> int:
        with self._lock:
            return self._calls

    def _intercept(self, method: str, payloads: list, kwargs: dict,
                   fn, corrupt_fn):
        with self._lock:
            idx = self._calls
            self._calls += 1
            fault = self.schedule.faults_for(idx)
            if fault.latency_s:
                self.injected["latency"] += 1
            if fault.error:
                self.injected["error"] += 1
            elif fault.corrupt:
                self.injected["corrupt"] += 1
        if fault.latency_s:
            self._sleep(fault.latency_s)
        rec = _Call(idx=idx, method=method, fault=fault,
                    payloads=payloads, kwargs=kwargs, result=None)
        try:
            if fault.error:
                raise InjectedFault(
                    f"injected dispatch error (call {idx}, {method})")
            res = fn()
            if fault.corrupt:
                res = corrupt_fn(res, idx)
            rec.result = res
            return res
        finally:
            with self._lock:
                if len(self.dispatch_log) < self._log_size:
                    self.dispatch_log.append(rec)

    @staticmethod
    def _corrupt_dists(res, idx: int):
        """Overwrite one seeded cell with NaN (copy -- the real engine's
        arrays are never mutated)."""
        out = np.array(res, copy=True)
        if out.size:
            flat = out.reshape(-1)
            pos = int(np.random.default_rng((idx, 1)).integers(flat.size))
            flat[pos] = np.nan
        return out

    @classmethod
    def _corrupt_topk(cls, res, idx: int):
        i, d = res
        return i, cls._corrupt_dists(d, idx)

    # -- intercepted entry points -----------------------------------------

    def query_batch(self, rs, **kw):
        return self._intercept(
            "query_batch", list(rs), dict(kw),
            lambda: self._svc.query_batch(rs, **kw), self._corrupt_dists)

    def top_k_batch(self, rs, k=10, **kw):
        return self._intercept(
            "top_k_batch", list(rs), {"k": k, **kw},
            lambda: self._svc.top_k_batch(rs, k, **kw), self._corrupt_topk)

    def query(self, r, **kw):
        return self._intercept(
            "query", [r], dict(kw),
            lambda: self._svc.query(r, **kw), self._corrupt_dists)
