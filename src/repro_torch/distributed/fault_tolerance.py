"""Launcher-level fault tolerance: heartbeats, failure detection, respawn.

A stdlib copy of `repro.distributed.fault_tolerance`.

On a real multi-pod deployment each host runs a `HeartbeatMonitor`; the
coordinator applies the policy below. The protocol is exercised by unit
tests with simulated clocks/failures -- the *code path* (detection
thresholds, respawn decisions) is what the tests pin down.

Protocol:
  1. every host POSTs a heartbeat (step, timestamp) each train step;
  2. a host silent for ``timeout_s`` is declared dead; the coordinator
     decides: respawn-in-place (transient) vs shrink (hardware loss);
  3. on shrink, `elastic.remesh` picks the largest valid (pod, data,
     model) factoring of the surviving device count;
  4. stragglers (> factor x median step time) are respawn candidates after
    ``straggler_strikes`` consecutive slow steps.

`ServingWatchdog` applies the same protocol to the serving loop
(launch/serve.py): each dispatch *kind* ("plain", "top_k") is a virtual
host beating once per dispatch, so dispatcher silence surfaces as a dead
host and per-kind service-time straggler strikes (vs a rolling median of
that kind's own history) fire an ``on_strike`` callback -- wired to
`serving.resilience.EngineGuard.trip`, which force-opens the active
rung's breaker and demotes the engine.
"""
from __future__ import annotations

import collections
import dataclasses
import statistics
import threading
import time
from typing import Callable, Optional


@dataclasses.dataclass
class HostStatus:
    host_id: int
    last_step: int = -1
    last_seen: float = 0.0
    slow_strikes: int = 0
    alive: bool = True


@dataclasses.dataclass
class FaultPolicy:
    timeout_s: float = 60.0
    straggler_factor: float = 2.0
    straggler_strikes: int = 3


class HeartbeatMonitor:
    """Coordinator-side view of the fleet."""

    def __init__(self, num_hosts: int, policy: FaultPolicy = FaultPolicy(),
                 clock: Callable[[], float] = time.monotonic):
        self.policy = policy
        self.clock = clock
        self.hosts = {h: HostStatus(host_id=h, last_seen=clock())
                      for h in range(num_hosts)}
        self.median_step_s: Optional[float] = None

    def heartbeat(self, host_id: int, step: int,
                  step_seconds: Optional[float] = None) -> None:
        st = self.hosts[host_id]
        st.last_step = step
        st.last_seen = self.clock()
        st.alive = True
        if step_seconds is not None and self.median_step_s:
            if step_seconds > self.policy.straggler_factor \
                    * self.median_step_s:
                st.slow_strikes += 1
            else:
                st.slow_strikes = 0

    def set_median_step(self, seconds: float) -> None:
        self.median_step_s = seconds

    def dead_hosts(self) -> list[int]:
        now = self.clock()
        out = []
        for st in self.hosts.values():
            if st.alive and now - st.last_seen > self.policy.timeout_s:
                st.alive = False
                out.append(st.host_id)
        return out

    def respawn_candidates(self) -> list[int]:
        return [st.host_id for st in self.hosts.values()
                if st.alive
                and st.slow_strikes >= self.policy.straggler_strikes]

    def surviving(self) -> int:
        self.dead_hosts()
        return sum(st.alive for st in self.hosts.values())


@dataclasses.dataclass
class _KindTrack:
    """Per-dispatch-kind watchdog state."""
    last_seen: float = 0.0
    dispatches: int = 0
    failures: int = 0
    strikes: int = 0          # consecutive straggler dispatches
    tripped: int = 0          # on_strike firings
    history: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=64))


class ServingWatchdog:
    """Serving-loop watchdog: dispatcher liveness + straggler strikes.

    Wire ``beat`` as the coalescer's ``heartbeat=`` callback; every
    dispatch reports (kind, wall seconds, ok). A dispatch slower than
    ``policy.straggler_factor`` x the rolling median of its OWN kind's
    recent wall times counts one strike (failed dispatches also strike --
    a rung burning its retry budget is straggling by definition);
    ``policy.straggler_strikes`` consecutive strikes fire ``on_strike``
    (-> `EngineGuard.trip`: force-open the active rung, demote) and reset
    the streak. The median needs ``min_samples`` clean dispatches first,
    so warmup compiles never strike.

    ``check()`` is the liveness poll for the serving loop: kinds silent
    longer than ``policy.timeout_s`` while work is pending (``pending_fn``,
    e.g. ``lambda: co.stats().queue_depth``) are returned as stalled --
    silence with an empty queue is just an idle server.

    Thread-safe; ``clock`` injectable for deterministic tests."""

    def __init__(self, policy: FaultPolicy | None = None, *,
                 on_strike: Optional[Callable[[str], None]] = None,
                 pending_fn: Optional[Callable[[], int]] = None,
                 min_samples: int = 5,
                 clock: Callable[[], float] = time.monotonic,
                 tracer=None):
        self.policy = policy or FaultPolicy()
        self.on_strike = on_strike
        self.pending_fn = pending_fn
        self.min_samples = max(1, min_samples)
        self.clock = clock
        # optional repro_torch.obs tracer (late-bindable attribute): strikes and
        # stall detections land in the structured event log
        if tracer is None:
            from repro_torch.obs.trace import NULL_TRACER
            tracer = NULL_TRACER
        self.tracer = tracer
        self._lock = threading.Lock()
        self._kinds: dict[str, _KindTrack] = {}
        self._last_beat = clock()       # any-kind liveness

    def beat(self, kind: str, wall_s: float, ok: bool) -> None:
        """One dispatch completed (the coalescer heartbeat callback)."""
        strike_cb, struck = None, False
        with self._lock:
            now = self.clock()
            self._last_beat = now
            tr = self._kinds.setdefault(kind, _KindTrack())
            tr.last_seen = now
            tr.dispatches += 1
            if not ok:
                tr.failures += 1
            slow = not ok
            if ok and len(tr.history) >= self.min_samples:
                med = statistics.median(tr.history)
                slow = wall_s > self.policy.straggler_factor * med
            if ok:
                tr.history.append(wall_s)
            if slow:
                tr.strikes += 1
                if tr.strikes >= self.policy.straggler_strikes:
                    tr.strikes = 0
                    tr.tripped += 1
                    struck = True
                    strike_cb = self.on_strike
            else:
                tr.strikes = 0
        if struck:
            self.tracer.event("watchdog.strike", kind=kind,
                              wall_s=round(float(wall_s), 6))
        if strike_cb is not None:
            try:
                strike_cb(kind)
            except Exception:           # noqa: BLE001 -- monitoring must
                pass                    # never kill the dispatcher

    def check(self) -> list[str]:
        """Kinds whose dispatcher looks stalled: silent > ``timeout_s``
        with work pending. Poll from the serving loop."""
        pending = self.pending_fn() if self.pending_fn is not None else 1
        if not pending:
            return []
        now = self.clock()
        with self._lock:
            stalled = [kind for kind, tr in self._kinds.items()
                       if now - tr.last_seen > self.policy.timeout_s]
        for kind in stalled:
            self.tracer.event("watchdog.stalled", kind=kind)
        return stalled

    def report(self) -> dict[str, dict]:
        """Per-kind counters for the serving loop's final stats dump."""
        with self._lock:
            return {kind: {"dispatches": tr.dispatches,
                           "failures": tr.failures,
                           "tripped": tr.tripped,
                           "median_wall_s": (statistics.median(tr.history)
                                             if tr.history else 0.0)}
                    for kind, tr in self._kinds.items()}
