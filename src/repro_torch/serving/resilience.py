"""Serving resilience: circuit-breaker impl demotion, bounded retry, and
brownout degradation in front of the WMD engine.

A copy of `repro.serving.resilience` on the port's `core.guards`.

The coalescer (serving.coalescer) turns client streams into engine
dispatches; this module decides *which* engine those dispatches hit when
things go wrong, without ever blocking the serving loop:

  EngineGuard     -- the dispatch wrapper. Every batch walks an ordered
                     ladder of rungs (impl fallbacks: the service default,
                     then cheaper contraction paths; pruned top-k falls
                     back to the exhaustive scan route), each rung behind
                     its own `CircuitBreaker`. Failures retry with seeded
                     exponential backoff + jitter (`ResiliencePolicy`),
                     trip the rung's breaker after a failure streak, and
                     demote to the next rung; when every exact rung is
                     down (or the `BrownoutController` says the server is
                     overloaded) the dispatch is served from the RWMD
                     bound-only degraded tier (`WMDService.
                     query_batch_bounds` / `top_k_batch_bounds`) and
                     wrapped in `DegradedResult` so clients can tell.
  CircuitBreaker  -- classic closed -> open -> half_open machine: a
                     failure streak opens the rung, a cooldown later one
                     probe dispatch is let through (half_open), and
                     `breaker_probes` consecutive probe successes close it
                     again. A probe failure re-opens immediately.
  BrownoutController -- hysteretic overload detector: enters brownout when
                     queue depth or the deadline-miss EWMA crosses its hi
                     threshold, exits only when BOTH are back under their
                     lo thresholds AND the brownout has dwelled
                     ``brownout_dwell_s`` (no flapping at the boundary).

Design rules, each load-bearing for the chaos suite's contracts
(tests/test_torch_resilience.py):

* Rung 0 dispatches with ``impl=None`` -- byte-for-byte the call the
  coalescer makes without a guard -- so fault-free dispatches stay
  *bitwise identical* to the unguarded baseline.
* `DegradedResult` is a wrapper, never a mutation: normal responses remain
  raw arrays, so the success path's bitwise contract is untouched and
  ``isinstance(x, DegradedResult)`` is the complete client-side detection
  rule.
* `InvalidQueryError` propagates un-retried (a malformed input is the
  caller's bug, deterministic forever); everything else -- injected
  dispatch exceptions, torch runtime errors, `NumericalError` from the
  guards layer (which is also how *injected non-finite outputs* surface:
  the guard re-checks every result) -- is retryable up to
  ``max_retries`` per rung, because the guard cannot distinguish a
  transient corruption from a persistent one and the breaker bounds the
  damage either way.
* All waiting is bounded (retry backoff caps at ``backoff_max_s``); the
  guard never blocks on a lock while calling the engine, so a slow solve
  cannot deadlock stats readers.
* On the card the guard never leaves the kernels: the "fused" and
  "unfused" impls would run the plain PyTorch versions there, so a CUDA
  service's ladder holds only rungs that launch its kernels (`_ladder`).
  Past them a dispatch falls to the degraded tier, whose bounds are
  kernels #8 / #9 too, or, with ``degrade_on_failure=False``, raises the
  last error. A device-side fault (illegal address, launch failure)
  poisons the CUDA context, so its retries fail too; nothing here treats
  it specially -- the breakers open and the last error reaches the
  caller.

`distributed.fault_tolerance.ServingWatchdog` plugs in via `trip()`:
straggler strikes force-open the active rung's breaker from outside.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.core import guards as _guards
from repro_torch.obs.trace import NULL_TRACER

# the full contraction-path ladder, fastest-and-twitchiest first; a
# service's ladder starts at its own impl and demotes rightward
_IMPL_ORDER = ("kernel", "fused", "unfused")


@dataclasses.dataclass(frozen=True)
class ResiliencePolicy:
    """Knobs of the resilience layer (all times in seconds).

    ``impl_ladder``: explicit demotion ladder; () derives it from the
    service impl (e.g. "kernel" -> (None, "fused", "unfused") on the CPU,
    (None,) on the card -- None is "the service default", kept first so
    fault-free dispatches are the exact unguarded call). ``brownout_queue_hi`` / ``brownout_miss_hi``
    of None disable that brownout signal; both None disables brownout
    entirely."""
    impl_ladder: tuple = ()
    breaker_failures: int = 3          # failure streak that opens a rung
    breaker_cooldown_s: float = 5.0    # open -> half_open delay
    breaker_probes: int = 1            # half_open successes to close
    max_retries: int = 2               # extra attempts per rung per dispatch
    backoff_base_s: float = 0.02
    backoff_mult: float = 2.0
    backoff_max_s: float = 0.5
    backoff_jitter: float = 0.5        # uniform [0, j] fraction added
    seed: int = 0                      # jitter rng seed
    brownout_queue_hi: int | None = None
    brownout_queue_lo: int = 0
    brownout_miss_hi: float | None = None
    brownout_miss_lo: float = 0.0
    brownout_dwell_s: float = 1.0      # min time browned out before exit
    degrade_on_failure: bool = True    # bound-only answers when rungs die


@dataclasses.dataclass
class DegradedResult:
    """A degraded (bound-only) response. ``value`` carries whatever the
    normal response would have been shaped like -- a (N,) bound row for a
    plain query, an ``(idx, dist)`` pair for top-k -- computed by the RWMD
    lower-bound tier instead of the exact Sinkhorn engine. ``reason`` says
    why ("brownout" or the engine failure), ``tier`` what produced it.
    Clients detect degradation with ``isinstance(x, DegradedResult)``;
    non-degraded responses are never wrapped."""
    value: object
    reason: str
    tier: str = "rwmd_bound"


class CircuitBreaker:
    """closed -> open -> half_open -> closed, with a transition log.

    Not thread-safe by itself; `EngineGuard` serializes access under its
    own lock. ``clock`` is injectable for deterministic tests."""

    def __init__(self, *, failures: int = 3, cooldown_s: float = 5.0,
                 probes: int = 1, clock: Callable[[], float] = time.monotonic,
                 on_transition: Callable[[str, str], None] | None = None):
        self.failures = max(1, failures)
        self.cooldown_s = cooldown_s
        self.probes = max(1, probes)
        self._clock = clock
        self._on_transition = on_transition
        self.state = "closed"
        self.transitions: list[tuple[str, str]] = []
        self._streak = 0
        self._probe_ok = 0
        self._opened_at = 0.0

    def _to(self, state: str) -> None:
        if state != self.state:
            self.transitions.append((self.state, state))
            old, self.state = self.state, state
            if self._on_transition is not None:
                self._on_transition(old, state)

    def allow(self) -> bool:
        """May a dispatch use this rung right now? An open breaker past
        its cooldown transitions to half_open and admits one probe."""
        if self.state == "open":
            if self._clock() - self._opened_at >= self.cooldown_s:
                self._probe_ok = 0
                self._to("half_open")
                return True
            return False
        return True

    def record_success(self) -> None:
        self._streak = 0
        if self.state == "half_open":
            self._probe_ok += 1
            if self._probe_ok >= self.probes:
                self._to("closed")

    def record_failure(self) -> None:
        if self.state == "half_open":       # failed probe: back to open
            self._opened_at = self._clock()
            self._to("open")
            return
        self._streak += 1
        if self._streak >= self.failures and self.state == "closed":
            self._opened_at = self._clock()
            self._to("open")

    def force_open(self) -> None:
        """External trip (watchdog straggler strikes)."""
        self._opened_at = self._clock()
        self._streak = 0
        self._to("open")


class BrownoutController:
    """Hysteretic overload detector driving the degraded tier.

    Enter when EITHER signal crosses its hi threshold; exit only when
    BOTH are at/below their lo thresholds and at least ``dwell_s`` has
    passed since entering (flap suppression). Signals with a None hi
    threshold never trigger entry and never hold exit."""

    def __init__(self, *, queue_hi: int | None = None, queue_lo: int = 0,
                 miss_hi: float | None = None, miss_lo: float = 0.0,
                 dwell_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        self.queue_hi, self.queue_lo = queue_hi, queue_lo
        self.miss_hi, self.miss_lo = miss_hi, miss_lo
        self.dwell_s = dwell_s
        self._clock = clock
        self.active = False
        self.entries = 0
        self._entered_at = 0.0

    def update(self, queue_depth: int, miss_ewma: float) -> bool:
        hot = ((self.queue_hi is not None and queue_depth >= self.queue_hi)
               or (self.miss_hi is not None and miss_ewma >= self.miss_hi))
        if not self.active:
            if hot:
                self.active = True
                self.entries += 1
                self._entered_at = self._clock()
            return self.active
        calm = ((self.queue_hi is None or queue_depth <= self.queue_lo)
                and (self.miss_hi is None or miss_ewma <= self.miss_lo))
        if calm and self._clock() - self._entered_at >= self.dwell_s:
            self.active = False
        return self.active


@dataclasses.dataclass(frozen=True)
class ResilienceStats:
    """Snapshot of the guard's counters (cumulative)."""
    dispatches: int
    retries: int
    failures: int                 # failed attempts (incl. retried ones)
    demoted: int                  # dispatches served below rung 0
    degraded: int                 # dispatches served by the bound tier
    degraded_requests: int        # requests inside those dispatches
    breaker_transitions: int
    breaker_open: int             # rungs currently open (incl. half_open)
    brownout_active: bool
    brownout_entries: int
    breaker_states: dict[str, str]   # "kind/rung" -> state


def _default_ladder(svc_impl: str) -> tuple:
    """(None, <impls strictly below svc_impl in the order>): None = the
    service default (the exact unguarded dispatch), demotions follow."""
    try:
        start = _IMPL_ORDER.index(svc_impl)
    except ValueError:
        return (None,)
    return (None,) + _IMPL_ORDER[start + 1:]


def _ladder(svc, explicit: tuple) -> tuple:
    """The guard's impl ladder for ``svc``. On a CPU service: ``explicit``
    or `_default_ladder` of the service impl, as in the reference. On a
    CUDA service only rungs that launch the service's kernels: (None,) by
    default, and an explicit ladder may name nothing but None and
    "kernel"."""
    dev = getattr(svc, "device", None)
    if getattr(dev, "type", dev) != "cuda":
        return explicit or _default_ladder(getattr(svc, "impl", "fused"))
    plain = [x for x in explicit if x not in (None, "kernel")]
    if plain:
        raise ValueError(f"impl_ladder {explicit!r}: on the card a rung "
                         f"may be None or 'kernel', not {plain}")
    return explicit or (None,)


class EngineGuard:
    """Resilient dispatch wrapper around a `WMDService`-shaped engine.

    The coalescer (or any caller) routes batches through `dispatch`; the
    guard walks the rung ladder, retries, trips breakers, and falls back
    to the degraded bound tier. ``clock`` / ``sleep`` are injectable so
    the chaos suite runs the whole machine on a fake clock."""

    def __init__(self, svc, policy: ResiliencePolicy | None = None, *,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 tracer=None, metrics=None):
        self.svc = svc
        self.policy = policy or ResiliencePolicy()
        self._clock = clock
        self._sleep = sleep
        # late-bound on purpose: the coalescer attaches its tracer to a
        # prebuilt guard after construction; breaker callbacks read the
        # attribute at fire time, so attachment is retroactive
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._mx = None
        if metrics is not None:
            self._mx = {
                "dispatches": metrics.counter(
                    "wmd_guard_dispatches_total",
                    "batches routed through the resilience guard"),
                "retries": metrics.counter(
                    "wmd_guard_retries_total", "per-rung retry attempts"),
                "failures": metrics.counter(
                    "wmd_guard_failures_total",
                    "failed dispatch attempts (incl. retried)"),
                "demoted": metrics.counter(
                    "wmd_guard_demoted_total",
                    "dispatches served below rung 0"),
                "degraded": metrics.counter(
                    "wmd_guard_degraded_total",
                    "dispatches answered by the RWMD bound tier"),
                "transitions": metrics.counter(
                    "wmd_breaker_transitions_total",
                    "circuit-breaker state transitions"),
                "brownout_entries": metrics.counter(
                    "wmd_brownout_entries_total", "brownout activations"),
                "brownout_active": metrics.gauge(
                    "wmd_brownout_active", "1 while browned out"),
                "breaker_open": metrics.gauge(
                    "wmd_breaker_open_rungs",
                    "rungs currently open or half_open"),
            }
        self._rng = np.random.default_rng(self.policy.seed)
        self._lock = threading.Lock()
        ladder = _ladder(svc, tuple(self.policy.impl_ladder))
        # rung tables: ("impl", x) dispatches query_batch(impl=x);
        # ("pruned", x) dispatches the two-tier top-k with impl x;
        # ("scan", None) the exhaustive one-program top-k route -- a
        # genuinely different code path for when the prune machinery
        # itself is what's failing
        self._rungs: dict[str, list[tuple[str, object]]] = {
            "plain": [("impl", impl) for impl in ladder],
            "top_k": [("pruned", impl) for impl in ladder]
                     + [("scan", None)],
        }
        def mk(kind: str, i: int) -> CircuitBreaker:
            return CircuitBreaker(
                failures=self.policy.breaker_failures,
                cooldown_s=self.policy.breaker_cooldown_s,
                probes=self.policy.breaker_probes, clock=clock,
                on_transition=lambda old, new, kind=kind, i=i:
                    self._on_breaker(kind, i, old, new))

        self._breakers = {(kind, i): mk(kind, i)
                          for kind, rungs in self._rungs.items()
                          for i in range(len(rungs))}
        self.brownout = BrownoutController(
            queue_hi=self.policy.brownout_queue_hi,
            queue_lo=self.policy.brownout_queue_lo,
            miss_hi=self.policy.brownout_miss_hi,
            miss_lo=self.policy.brownout_miss_lo,
            dwell_s=self.policy.brownout_dwell_s, clock=clock)
        # counters (under _lock)
        self._dispatches = 0
        self._retries = 0
        self._failures = 0
        self._demoted = 0
        self._degraded = 0
        self._degraded_requests = 0
        # (kind, rung_index, degraded) of recent dispatches, for the chaos
        # suite's replay oracle (which rung actually served each batch);
        # bounded like the coalescer's batch_log so a long-lived server
        # can't grow it without bound
        self.dispatch_log: collections.deque[tuple[str, int, bool]] = \
            collections.deque(maxlen=4096)

    # -- observability taps ----------------------------------------------
    # (event emission only appends to the tracer's own deque under the
    # tracer's lock -- no callbacks back into guard state, so firing them
    # while holding self._lock cannot deadlock)

    def _on_breaker(self, kind: str, rung: int, old: str, new: str) -> None:
        self.tracer.event("breaker.transition", kind=kind, rung=rung,
                          frm=old, to=new)
        if self._mx is not None:
            self._mx["transitions"].inc()
            self._mx["breaker_open"].set(
                sum(1 for br in self._breakers.values()
                    if br.state != "closed"))

    def _update_brownout(self, queue_depth: int, miss_ewma: float) -> bool:
        """brownout.update + enter/exit edge detection (caller holds
        self._lock)."""
        was = self.brownout.active
        active = self.brownout.update(queue_depth, miss_ewma)
        if active != was:
            self.tracer.event("brownout.enter" if active else "brownout.exit",
                              queue_depth=queue_depth,
                              miss_ewma=round(float(miss_ewma), 6),
                              entries=self.brownout.entries)
            if self._mx is not None:
                self._mx["brownout_active"].set(1.0 if active else 0.0)
                if active:
                    self._mx["brownout_entries"].inc()
        return active

    # -- dispatch ---------------------------------------------------------

    def _call(self, kind: str, rung: tuple[str, object],
              payloads: Sequence[np.ndarray], k: int | None):
        mode, impl = rung
        if mode == "impl":
            if impl is None:
                return self.svc.query_batch(payloads)
            return self.svc.query_batch(payloads, impl=impl)
        if mode == "pruned":
            kw = {} if impl is None else {"impl": impl}
            return self.svc.top_k_batch(payloads, k, prune=True, **kw)
        return self.svc.top_k_batch(payloads, k, prune=False)

    def _post_check(self, kind: str, res) -> None:
        """Re-verify the result at the guard boundary: the service's own
        guards run *inside* the engine, so corruption injected at the
        engine boundary (faultinject) -- or a service with guards off --
        is caught here and treated as a dispatch failure."""
        if kind == "plain":
            _guards.check_finite(res, "dispatch result")
        else:
            _guards.check_finite(res[1], "top_k dispatch distances")

    def _backoff(self, attempt: int) -> float:
        p = self.policy
        base = min(p.backoff_base_s * (p.backoff_mult ** attempt),
                   p.backoff_max_s)
        with self._lock:
            jitter = float(self._rng.random()) * p.backoff_jitter
        return base * (1.0 + jitter)

    def _degrade(self, kind: str, payloads, k: int | None,
                 reason: str) -> DegradedResult:
        if kind == "plain":
            val = self.svc.query_batch_bounds(payloads)
        else:
            val = self.svc.top_k_batch_bounds(payloads, k)
        with self._lock:
            self._degraded += 1
            self._degraded_requests += len(payloads)
        self.tracer.event("degraded", kind=kind, reason=reason,
                          requests=len(payloads))
        if self._mx is not None:
            self._mx["degraded"].inc()
        return DegradedResult(value=val, reason=reason)

    def dispatch(self, kind: str, payloads: Sequence[np.ndarray],
                 k: int | None = None, *, queue_depth: int = 0,
                 miss_ewma: float = 0.0):
        """Serve one batch resiliently. Returns the engine result (raw --
        bitwise identical to an unguarded dispatch when rung 0 succeeds
        first try) or a `DegradedResult`; raises only when every rung AND
        the degraded tier failed (or degradation is disabled)."""
        if kind not in self._rungs:
            raise ValueError(f"unknown dispatch kind {kind!r}")
        with self._lock:
            self._dispatches += 1
            browned = self._update_brownout(queue_depth, miss_ewma)
        if self._mx is not None:
            self._mx["dispatches"].inc()
        if browned:
            try:
                res = self._degrade(kind, payloads, k, "brownout")
                with self._lock:
                    self.dispatch_log.append((kind, -1, True))
                return res
            except _guards.InvalidQueryError:
                raise
            except Exception:
                pass          # bound tier down too: fall through to exact
        last_err: BaseException | None = None
        for i, rung in enumerate(self._rungs[kind]):
            br = self._breakers[(kind, i)]
            attempt = 0
            while True:
                with self._lock:
                    if not br.allow():
                        break
                try:
                    res = self._call(kind, rung, payloads, k)
                    self._post_check(kind, res)
                except _guards.InvalidQueryError:
                    raise     # caller bug: deterministic, never retried
                except Exception as e:    # noqa: BLE001 -- rung fault
                    last_err = e
                    with self._lock:
                        self._failures += 1
                        br.record_failure()
                        retry = (attempt < self.policy.max_retries
                                 and br.allow())
                        if retry:
                            self._retries += 1
                    self.tracer.event("dispatch.failure", kind=kind, rung=i,
                                      error=type(e).__name__, retry=retry)
                    if self._mx is not None:
                        self._mx["failures"].inc()
                        if retry:
                            self._mx["retries"].inc()
                    if not retry:
                        break             # rung exhausted: demote
                    attempt += 1
                    self._sleep(self._backoff(attempt))
                    continue
                with self._lock:
                    br.record_success()
                    if i > 0:
                        self._demoted += 1
                    self.dispatch_log.append((kind, i, False))
                if i > 0 and self._mx is not None:
                    self._mx["demoted"].inc()
                return res
        if self.policy.degrade_on_failure:
            try:
                res = self._degrade(
                    kind, payloads, k,
                    f"engine_failure: {type(last_err).__name__}: {last_err}"
                    if last_err is not None else "all rungs open")
                with self._lock:
                    self.dispatch_log.append((kind, -1, True))
                return res
            except _guards.InvalidQueryError:
                raise
            except Exception as e:        # noqa: BLE001
                last_err = last_err or e
        if last_err is None:
            last_err = RuntimeError("every rung breaker is open")
        raise last_err

    # -- external hooks ---------------------------------------------------

    def observe(self, queue_depth: int, miss_ewma: float) -> bool:
        """Feed overload signals outside a dispatch (e.g. a monitoring
        loop); returns whether brownout is active."""
        with self._lock:
            return self._update_brownout(queue_depth, miss_ewma)

    def trip(self, kind: str = "plain", reason: str = "") -> None:
        """Force-open the first non-open rung of ``kind`` (watchdog hook:
        straggler strikes demote the engine from outside)."""
        with self._lock:
            for i in range(len(self._rungs[kind])):
                br = self._breakers[(kind, i)]
                if br.state != "open":
                    br.force_open()
                    self.tracer.event("breaker.tripped", kind=kind, rung=i,
                                      reason=reason or "external trip")
                    return

    def stats(self) -> ResilienceStats:
        with self._lock:
            states = {f"{kind}/{i}": br.state
                      for (kind, i), br in sorted(self._breakers.items())}
            return ResilienceStats(
                dispatches=self._dispatches,
                retries=self._retries,
                failures=self._failures,
                demoted=self._demoted,
                degraded=self._degraded,
                degraded_requests=self._degraded_requests,
                breaker_transitions=sum(len(br.transitions)
                                        for br in self._breakers.values()),
                breaker_open=sum(1 for br in self._breakers.values()
                                 if br.state != "closed"),
                brownout_active=self.brownout.active,
                brownout_entries=self.brownout.entries,
                breaker_states=states)
