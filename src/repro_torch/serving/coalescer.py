"""Async request coalescer: turns a stream of single WMD queries into full
cache-friendly batches for the (Q, v_r, N) engine.

A copy of `repro.serving.coalescer` in front of the port's `WMDService`.

The paper's speedup is batch amortization: one fused SDDMM-SpMM program (one
ELL gather, one psum per Sinkhorn iteration) serves every query in the batch,
so the engine only reaches peak when it is fed full batches (on the
card the engine is host-bound, and a batch spreads one dispatch's host
time over its queries). `WMDService`
solves whatever one `query_batch` call brings; this module supplies the
missing admission layer for an *asynchronous* workload -- independent clients
submitting one query at a time ("heavy traffic from millions of users").

Serving architecture (queue -> dispatcher -> engine)
----------------------------------------------------
::

    clients                 QueryCoalescer                       WMDService
    submit(r) ---> [priority lane | admission queue] --+
    submit(r) ----------------^                        |  dispatcher thread
    submit_many -------------^                         +-> query_batch(batch)
       ...                                                  |  (one device
    Future <---- set_result(row i of the batch result) <----+   program)

* **Admission queue** -- bounded (``max_queue``) FIFO of pending requests,
  plus an optional priority lane (``submit(..., priority=1)``) drained first
  at batch-formation time. When the queue is full, ``backpressure`` picks the
  policy: ``"block"`` parks the submitter until space frees (optional
  ``timeout``), ``"reject"`` raises `QueueFullError` immediately.
* **Dispatcher thread** -- the only thread that touches the device (its
  kernels launch on the thread's current stream, the default stream, the
  same one a caller's direct ``query_batch`` uses), so
  coalesced serving keeps the engine's determinism: each dispatched batch is
  one plain ``svc.query_batch(rs)`` call, and every request's result row is
  **bitwise identical** to a direct ``query_batch`` of the same queries in
  the same order (asserted by tests/test_torch_coalescer.py via `batch_log`
  oracle replay, cache on and off).
* **Top-k requests** -- ``submit_top_k(r, k)`` coalesces retrieval requests
  exactly like plain queries: batches are cut *homogeneous* (one kind, one
  k -- the cut stops at the first kind change, the next cut picks up the
  other run), so a top-k batch is literally one
  ``svc.top_k_batch(rs, k, prune=True)`` dispatch of the two-tier pruned
  engine, whose results are bitwise-identical to the exact full scan.
  The deadline trigger budgets with a per-kind service-time EWMA (top-k
  and plain dispatches cost very differently). Mixed-kind caveat: cuts
  are FIFO, so a deadline request queued behind a foreign-kind run waits
  out that one dispatch before its own cut -- under mixed traffic,
  deadline budgets should leave one foreign service time of slack (the
  same slack a request arriving behind an already-full bucket needs).
* **Writer lane** -- ``submit_add_docs(ids, docs)`` / ``submit_remove_docs
  (ids)`` enqueue live-corpus mutations (services built via
  `WMDService.from_live`) through the same admission queue: FIFO against
  queries (read-your-writes: a query submitted after a write ack
  dispatches after the write applied), homogeneous cuts per op, and a
  write dispatch merges its batch into ONE durable ``add_docs`` /
  ``remove_docs`` call -- ingest bursts amortize WAL fsyncs the way query
  bursts amortize programs. Write futures resolve to the acked doc count
  once the mutation is WAL-fsynced (on a service without a live corpus,
  with the `ValueError` its ``add_docs`` / ``remove_docs`` raise); writes
  bypass the resilience guard (durability is the corpus's contract, a
  degraded write has no meaning) and contribute ``write_dispatches`` /
  ``docs_added`` / ``docs_removed`` to `ServingStats` instead of
  program-shape telemetry.
* **Dispatch triggers** -- a batch is cut when the first of these fires
  (per-dispatch counts are in `ServingStats`):
    - *fill*:     the ``max_batch`` Q bucket is full (``max_batch`` is
                  rounded up to a power of two to match the service's
                  pow2 admission buckets -- a coalescer batch never
                  straddles two bucket retraces);
    - *window*:   the oldest queued request has waited ``window_ms``
                  (long enough to fill buckets at load, short enough
                  to stay invisible next to a solve);
    - *deadline*: waiting any longer would violate the earliest queued
                  request's deadline budget, i.e.
                  ``now + service_estimate >= min(deadline)`` where
                  ``service_estimate`` is an EWMA of recent dispatch wall
                  times (first dispatches include compile time, so warm the
                  service before relying on tight deadlines);
    - *drain*:    `drain()` and shutdown flush whatever is queued
                  immediately (no waiting out the window).
* **Cancellation** -- a client may ``Future.cancel()`` a request that is
  still queued; it is discarded at batch-formation time (never dispatched,
  counted in ``ServingStats.cancelled``). Requests that survive the cut are
  marked running, so a late cancel can never race the result fan-out.
* **Deadlines** -- ``submit(..., deadline_ms=...)`` (or the constructor's
  ``default_deadline_ms``) sets a per-request budget measured from submit
  time. Deadlines pull dispatch *earlier*; a request that still finishes
  past its deadline is served anyway and counted in
  ``ServingStats.deadline_misses`` (serving late beats dropping work; a
  dropping policy belongs in the client).
* **Shutdown** -- `drain()` blocks until the queue and in-flight batch are
  empty (coalescer stays open); `shutdown(drain=True)` closes admission,
  flushes, and joins the thread; `shutdown(drain=False)` fails pending
  futures with `CoalescerClosedError`. The context-manager form
  (``with svc.async_service() as co:``) is shutdown-with-drain, which is
  what makes the serve loop SIGINT-safe.

Observability: `stats()` returns a `ServingStats` snapshot -- queue depth,
batch-size histogram, per-trigger dispatch counts, p50/p95/p99 request
latency, and the cross-query cache hit rate passed through from the
service's ``last_batch_stats``. `batch_log` keeps the request-id composition
of recent dispatches: the replay oracle for the bitwise contract and the
provenance record for tail-latency debugging.

`loadgen.py` drives this layer (open-loop Poisson / closed-loop workers);
`chip_smoke.py` phase 9 serves it on the card.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import threading
import time
from concurrent.futures import Future
from typing import Callable, Sequence

import numpy as np

from repro_torch.core import guards as _guards
from repro_torch.core.formats import next_pow2 as _next_pow2
from repro_torch.obs.metrics import (DEFAULT_SIZE_BUCKETS,
                                     DEFAULT_TIME_BUCKETS, MetricsRegistry)
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serving.resilience import (DegradedResult, EngineGuard,
                                            ResiliencePolicy)


class QueueFullError(RuntimeError):
    """Admission queue at max_queue and backpressure policy gave up."""


class CoalescerClosedError(RuntimeError):
    """submit() after shutdown, or a pending request failed by a no-drain
    shutdown."""


@dataclasses.dataclass(frozen=True)
class ServingStats:
    """Point-in-time snapshot of the coalescer (all counters cumulative)."""
    queue_depth: int              # requests waiting (both lanes)
    in_flight: int                # requests inside the current dispatch
    submitted: int
    completed: int
    rejected: int                 # backpressure rejections (QueueFullError)
    failed: int                   # requests whose dispatch raised
    cancelled: int                # futures cancelled by clients while queued
    deadline_misses: int          # served, but past their deadline
    dispatches: int
    dispatch_fill: int            # per-trigger dispatch counts
    dispatch_window: int
    dispatch_deadline: int
    dispatch_drain: int
    batch_size_hist: dict[int, int]
    mean_batch_size: float
    latency_ms_mean: float        # request latency = submit -> result set
    latency_ms_p50: float
    latency_ms_p95: float
    latency_ms_p99: float
    hit_rate: float | None        # mean per-dispatch cache hit rate
    service_estimate_ms: float    # EWMA dispatch wall time (deadline trigger)
    # registry warmup (serving.warmup): shapes precompiled before serving and
    # the per-shape compile seconds -- None until record_warmup() is called
    warmed_shapes: int = 0
    warmup_compile_s: dict[str, float] | None = None
    # resilience (serving.resilience; all zero/False without a policy)
    quarantined: int = 0          # rejected at admission (InvalidQueryError)
    degraded: int = 0             # requests served bound-only (DegradedResult)
    retries: int = 0              # engine dispatch retries
    breaker_transitions: int = 0  # circuit-breaker state changes
    breaker_open: int = 0         # rungs currently not closed
    brownout_active: bool = False
    # writer lane (live-corpus ingest; all zero on a read-only service)
    write_dispatches: int = 0     # add/remove batches dispatched
    docs_added: int = 0           # docs acked via submit_add_docs
    docs_removed: int = 0         # ids acked via submit_remove_docs

    @property
    def degraded_fraction(self) -> float:
        """Fraction of completed requests served by the degraded tier."""
        return self.degraded / self.completed if self.completed else 0.0


@dataclasses.dataclass
class _Request:
    seq: int
    r: np.ndarray
    future: Future
    t_submit: float
    deadline: float | None        # absolute monotonic time, or None
    priority: int
    k: int | None = None          # top-k request (None = plain distances);
                                  # batches are cut homogeneous per kind
    op: str = "plain"             # "plain" | "top_k" | "add" | "remove";
                                  # write ops carry their payload in ``r``
                                  # ((ids, docs) resp. ids) and cut into
                                  # their own homogeneous batches
    popped: bool = False          # left the queue (dispatched or discarded);
                                  # lazily expires stale deadline-heap entries


# scheduling slack subtracted from deadline fire times on top of the
# service-time EWMA: covers dispatcher wakeup + batch pop + result fan-out,
# which the EWMA (pure query_batch wall time) does not see
_DEADLINE_MARGIN_S = 1e-3


class QueryCoalescer:
    """Thread-safe admission queue + dispatcher in front of a `WMDService`.

    See the module docstring for the architecture. ``svc`` only needs a
    ``query_batch(list[np.ndarray]) -> (Q, N)`` method and (optionally) a
    ``last_batch_stats`` dict -- the coalescer is engine-agnostic by design.

    Args:
      svc:            the service whose ``query_batch`` dispatches run on.
      window_ms:      coalescing window measured from the oldest queued
                      request (trigger *window*).
      max_batch:      Q bucket that cuts a batch on fill; rounded up to a
                      power of two (the service's admission granularity).
      max_queue:      bound on queued requests (both lanes); 0 = unbounded.
      backpressure:   "block" | "reject" when the queue is full.
      default_deadline_ms: deadline applied to submits that don't pass one
                      (None = no deadline).
      batch_log_size: dispatched-batch compositions kept for oracle replay /
                      debugging (`batch_log`).
      latency_window: completed-request latencies kept for the percentile
                      snapshot (bounded so a long-lived server can't grow
                      without bound; percentiles are over this window, and
                      stats() copies it under the lock -- the default keeps
                      that copy well under the coalescing-window scale).
      validate:       admission-boundary input validation. Against a real
                      WMD service (one exposing ``cfg.vocab_size``) every
                      submit runs `core.guards.validate_query` (shape /
                      finiteness / non-negativity / non-zero mass) and a
                      bad query raises `InvalidQueryError` at submit time
                      -- quarantined (``ServingStats.quarantined``), never
                      enqueued, so one poisoned row can't NaN a whole
                      coalesced batch. Duck-typed services without a
                      vocab size get a finite-only check (their payload
                      contract is theirs).
      resilience:     a `serving.resilience.ResiliencePolicy` (or a
                      pre-built `EngineGuard`, e.g. one shared across
                      coalescers) that routes every dispatch through the
                      breaker/retry/brownout machinery; degraded responses
                      resolve futures with `DegradedResult` wrappers.
                      None (default) dispatches the engine directly.
      heartbeat:      callback ``(kind, wall_s, ok)`` invoked after every
                      dispatch -- the `distributed.fault_tolerance.
                      ServingWatchdog` wiring point (liveness + straggler
                      strikes). Exceptions from it are swallowed.
      metrics:        a `repro_torch.obs.MetricsRegistry` that becomes the
                      backing store of every `ServingStats` counter
                      (``wmd_requests_*`` / ``wmd_dispatches_total`` /
                      latency + batch-size histograms + phase-seconds
                      counters) -- scrape it live via `repro_torch.obs.export`.
                      None creates a private registry, so each coalescer's
                      stats stay independent by default; pass the
                      *service's* registry (as `launch.serve` does) to get
                      the whole stack -- coalescer + K cache + guard -- in
                      one scrape namespace. Do NOT share one registry
                      across concurrently-live coalescers whose stats you
                      read individually: counters are get-or-create by
                      name, so sharing sums them.
      tracer:         a `repro_torch.obs.Tracer` recording one span tree per
                      submitted request (queue wait, dispatch, engine
                      phase attribution, status) plus quarantine events;
                      it is also attached to a guard the coalescer
                      constructs (breaker/brownout/degraded events).
                      None (default) = the shared no-op recorder, zero
                      hot-path cost. Tracing never touches result arrays
                      -- obs-on is bitwise identical to obs-off.
    """

    def __init__(self, svc, *, window_ms: float = 5.0, max_batch: int = 16,
                 max_queue: int = 256, backpressure: str = "block",
                 default_deadline_ms: float | None = None,
                 batch_log_size: int = 4096, latency_window: int = 10_000,
                 validate: bool = True,
                 resilience: "ResiliencePolicy | EngineGuard | None" = None,
                 heartbeat: Callable[[str, float, bool], None] | None = None,
                 metrics: MetricsRegistry | None = None,
                 tracer=None):
        if backpressure not in ("block", "reject"):
            raise ValueError(f"backpressure must be block|reject, "
                             f"got {backpressure!r}")
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.svc = svc
        self.window_s = window_ms / 1e3
        self.max_batch = _next_pow2(max_batch)
        self.max_queue = max_queue
        self.backpressure = backpressure
        self.default_deadline_s = (None if default_deadline_ms is None
                                   else default_deadline_ms / 1e3)
        self.validate = validate
        # full validation needs the engine's vocab size; duck-typed fake
        # services (no cfg) get the finite-only check
        self._vocab_size = getattr(getattr(svc, "cfg", None),
                                   "vocab_size", None)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._tracer = tracer if tracer is not None else NULL_TRACER
        if resilience is None or isinstance(resilience, EngineGuard):
            self._guard = resilience
            # attach our tracer to a prebuilt guard that has none, so
            # breaker/brownout events land in the same log as the spans
            if (self._guard is not None and tracer is not None
                    and self._guard.tracer is NULL_TRACER):
                self._guard.tracer = self._tracer
        else:
            self._guard = EngineGuard(svc, resilience,
                                      tracer=self._tracer,
                                      metrics=self.metrics)
        self._heartbeat = heartbeat

        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)   # dispatcher waits
        self._space = threading.Condition(self._lock)  # blocked submitters
        self._idle = threading.Condition(self._lock)   # drain() waiters
        self._lo: collections.deque[_Request] = collections.deque()
        self._hi: collections.deque[_Request] = collections.deque()
        self._closed = False
        self._draining = 0            # active drain() calls force flushes
        self._seq = 0
        self._in_flight = 0

        # counters (mutated under _lock; backed by the metrics registry --
        # ServingStats is a *view* over these, and the same objects are
        # what a live Prometheus scrape reads)
        mx = self.metrics
        self._c = {
            "submitted": mx.counter("wmd_requests_submitted_total",
                                    "requests admitted to the queue"),
            "completed": mx.counter("wmd_requests_completed_total",
                                    "requests resolved with a result"),
            "rejected": mx.counter("wmd_requests_rejected_total",
                                   "backpressure rejections"),
            "failed": mx.counter("wmd_requests_failed_total",
                                 "requests whose dispatch raised"),
            "cancelled": mx.counter("wmd_requests_cancelled_total",
                                    "futures cancelled while queued"),
            "deadline_misses": mx.counter("wmd_deadline_misses_total",
                                          "requests served past deadline"),
            "quarantined": mx.counter("wmd_requests_quarantined_total",
                                      "invalid queries rejected at submit"),
            "degraded": mx.counter("wmd_requests_degraded_total",
                                   "requests answered bound-only"),
            "write_dispatches": mx.counter("wmd_write_dispatches_total",
                                           "merged add/remove dispatches"),
            "docs_added": mx.counter("wmd_docs_added_total",
                                     "docs acked via the writer lane"),
            "docs_removed": mx.counter("wmd_docs_removed_total",
                                       "ids acked for removal"),
        }
        self._c_disp = {
            trig: mx.counter("wmd_dispatches_total",
                             "batches cut, by trigger",
                             labels={"trigger": trig})
            for trig in ("fill", "window", "deadline", "drain")}
        self._c_phase = {
            ph: mx.counter("wmd_phase_seconds_total",
                           "engine wall seconds attributed per phase",
                           labels={"phase": ph})
            for ph in ("precompute", "solve", "bound", "rerank")}
        self._h_batch = mx.histogram("wmd_batch_size",
                                     "requests per dispatched batch",
                                     buckets=DEFAULT_SIZE_BUCKETS)
        self._h_latency = mx.histogram("wmd_request_latency_seconds",
                                       "submit -> result-set latency",
                                       buckets=DEFAULT_TIME_BUCKETS)
        self._g_queue = mx.gauge("wmd_queue_depth",
                                 "requests waiting (both lanes)")
        self._g_inflight = mx.gauge("wmd_in_flight",
                                    "requests inside the current dispatch")
        self._g_est = mx.gauge("wmd_service_estimate_seconds",
                               "EWMA dispatch wall time")
        # EWMA of the per-request deadline-miss indicator: one of the two
        # brownout overload signals (queue depth is the other)
        self._miss_ewma = 0.0
        # lazy min-heap of (deadline, seq, request): queued deadlines without
        # an O(queue) scan per wakeup; entries whose request already left the
        # queue (popped) are expired at read time
        self._dl_heap: list[tuple[float, int, _Request]] = []
        self._batch_hist: collections.Counter = collections.Counter()
        self._latencies = collections.deque(maxlen=latency_window)
        self._hit_rate_sum = 0.0
        self._hit_rate_n = 0
        self._service_est_s = 0.0             # combined (ServingStats)
        # per-op estimates for the deadline trigger: a pruned top-k
        # dispatch (bound + per-query rerank loop) costs orders of
        # magnitude more than a plain query_batch (and a write batch
        # costs differently than either), and feeding one shared
        # EWMA would make plain deadlines fire absurdly early (degenerate
        # batch-of-1 cuts) and top-k deadlines far too late
        self._service_est_kind: dict[str, float] = {}
        self._warmed_shapes = 0
        self._warmup_compile_s: dict[str, float] | None = None
        self.batch_log: collections.deque[tuple[int, ...]] = \
            collections.deque(maxlen=batch_log_size)
        # (kind, Q, k) of recent dispatches: the program-shape counterpart
        # of batch_log, cross-checked against the warmup ShapeRegistry by
        # tests/test_torch_warmup.py (every dispatched shape must be
        # registered)
        self.shape_log: collections.deque[tuple[str, int, int | None]] = \
            collections.deque(maxlen=batch_log_size)

        self._thread = threading.Thread(target=self._run,
                                        name="wmd-coalescer", daemon=True)
        self._thread.start()

    # -- client side ------------------------------------------------------

    def submit(self, r: np.ndarray, *, deadline_ms: float | None = None,
               priority: int = 0, timeout: float | None = None) -> Future:
        """Enqueue one (V,) query histogram; returns a Future of its (N,)
        distance row. Thread-safe. ``deadline_ms`` overrides the default
        deadline; ``priority > 0`` routes via the priority lane; ``timeout``
        bounds a *blocking* backpressure wait (seconds)."""
        return self._submit(r, None, deadline_ms, priority, timeout)

    def submit_top_k(self, r: np.ndarray, k: int = 10, *,
                     deadline_ms: float | None = None, priority: int = 0,
                     timeout: float | None = None) -> Future:
        """Enqueue one top-k retrieval request; returns a Future of an
        ``(idx (k,), dist (k,))`` pair served by the two-tier pruned engine
        (`WMDService.top_k_batch(..., prune=True)`).

        Top-k requests coalesce with each other exactly like plain queries
        do: the dispatcher cuts *homogeneous* batches (one kind, one k), so
        a coalesced top-k batch is literally one ``top_k_batch(rs, k,
        prune=True)`` call -- the pruned engine's bitwise contract carries
        over unchanged. Under mixed traffic a cut stops at the first
        kind/k change (FIFO order is preserved; the next cut picks up the
        other run), so interleaving kinds costs batch size, not
        correctness."""
        if k < 1:
            raise ValueError("k must be >= 1")
        return self._submit(r, int(k), deadline_ms, priority, timeout,
                            op="top_k")

    def submit_add_docs(self, ids, docs, *, deadline_ms: float | None = None,
                        priority: int = 0,
                        timeout: float | None = None) -> Future:
        """Writer lane: enqueue a durable live-corpus upsert; the Future
        resolves to the number of docs acked (WAL-fsynced -- see
        `WMDService.add_docs`) once the write batch dispatches.

        Writes ride the same admission queue (FIFO order against queries
        is preserved, backpressure applies) but cut into their OWN
        homogeneous batches: a write dispatch merges consecutive queued
        add requests into one ``svc.add_docs`` call, so ingest bursts
        amortize WAL fsyncs exactly like query bursts amortize programs.
        Writes bypass the resilience guard -- durability is the corpus's
        WAL contract, and a degraded 'add' has no meaning."""
        if len(ids) != len(docs):
            raise ValueError(f"{len(ids)} ids but {len(docs)} docs")
        if not hasattr(self.svc, "add_docs"):
            raise ValueError("service has no live corpus (add_docs)")
        return self._submit((list(ids), list(docs)), None, deadline_ms,
                            priority, timeout, op="add")

    def submit_remove_docs(self, ids, *, deadline_ms: float | None = None,
                           priority: int = 0,
                           timeout: float | None = None) -> Future:
        """Writer lane: enqueue a durable live-corpus remove; the Future
        resolves to the number of ids durably logged (removing a
        never-added id is a logged no-op, so the count acks durability,
        not prior existence). Same batching/ordering rules as
        `submit_add_docs`."""
        if not hasattr(self.svc, "remove_docs"):
            raise ValueError("service has no live corpus (remove_docs)")
        return self._submit(list(ids), None, deadline_ms, priority,
                            timeout, op="remove")

    def _submit(self, r, k: int | None,
                deadline_ms: float | None, priority: int,
                timeout: float | None, op: str = "plain") -> Future:
        if self.validate and op in ("plain", "top_k"):
            try:
                if self._vocab_size is not None:
                    _guards.validate_query(r, self._vocab_size)
                elif (isinstance(r, np.ndarray)
                      and np.issubdtype(r.dtype, np.floating)
                      and not np.isfinite(r).all()):
                    raise _guards.InvalidQueryError(
                        "query has non-finite entries")
            except _guards.InvalidQueryError as e:
                with self._lock:
                    self._c["quarantined"].inc()
                # a quarantined request never opens a span (it is never
                # enqueued) but still leaves exactly one closed tree --
                # the chaos suite's submitted == closed invariant
                if self._tracer.enabled:
                    self._tracer.event("quarantine", op=op,
                                       error=str(e)[:200])
                    self._tracer.closed_request(status="quarantined", op=op)
                raise
        with self._lock:
            if self._closed:
                raise CoalescerClosedError("coalescer is shut down")
            if self.max_queue:
                deadline_wait = (None if timeout is None
                                 else time.monotonic() + timeout)
                while self._depth_locked() >= self.max_queue:
                    if self.backpressure == "reject":
                        self._c["rejected"].inc()
                        raise QueueFullError(
                            f"admission queue full ({self.max_queue})")
                    remaining = (None if deadline_wait is None
                                 else deadline_wait - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        self._c["rejected"].inc()
                        raise QueueFullError(
                            f"blocked submit timed out after {timeout}s")
                    self._space.wait(timeout=remaining)
                    if self._closed:
                        raise CoalescerClosedError("coalescer is shut down")
            now = time.monotonic()
            dl_s = (self.default_deadline_s if deadline_ms is None
                    else deadline_ms / 1e3)
            req = _Request(seq=self._seq, r=r, future=Future(), t_submit=now,
                           deadline=None if dl_s is None else now + dl_s,
                           priority=priority, k=k, op=op)
            self._seq += 1
            (self._hi if priority > 0 else self._lo).append(req)
            if req.deadline is not None:
                heapq.heappush(self._dl_heap, (req.deadline, req.seq, req))
            self._c["submitted"].inc()
            self._g_queue.set(self._depth_locked())
            if self._tracer.enabled:
                self._tracer.begin_request(req.seq, t0=now, op=op, k=k,
                                           priority=priority)
            self._work.notify()
            return req.future

    def submit_many(self, rs: Sequence[np.ndarray], **kw) -> list[Future]:
        """Enqueue several queries in order (same kwargs as `submit`)."""
        return [self.submit(r, **kw) for r in rs]

    def warm_registry(self, *, ks: Sequence[int] = (),
                      kinds: Sequence[str] | None = None,
                      queries: Sequence[np.ndarray] | None = None,
                      seed: int = 0):
        """Precompile every program shape this coalescer can dispatch --
        pow2 Q buckets up to ``max_batch`` x kinds ("plain", plus "top_k"
        per k in ``ks``) -- via the `serving.warmup` shape registry, on the
        caller's thread. Call once before serving so no live dispatch pays
        compile time (first dispatches otherwise include it, which also
        skews the deadline trigger's service-time EWMA). Per-shape compile
        times are recorded and surface in `ServingStats.warmup_compile_s`.
        Returns the `WarmupReport`."""
        from repro_torch.serving import warmup as _warmup
        registry = _warmup.ShapeRegistry.from_service(
            self.svc, max_batch=self.max_batch, ks=ks, kinds=kinds)
        report = _warmup.warm(self.svc, registry, queries=queries, seed=seed)
        self.record_warmup(report)
        return report

    def record_warmup(self, report) -> None:
        """Fold a `serving.warmup.WarmupReport` into the stats snapshot
        (idempotent per shape: repeated warmups merge by shape label)."""
        compile_s = report.compile_s_by_label()
        with self._lock:
            merged = dict(self._warmup_compile_s or {})
            merged.update(compile_s)
            self._warmup_compile_s = merged
            self._warmed_shapes = len(merged)

    def warm(self, qs: Sequence[np.ndarray]) -> None:
        """Deprecated shim: forwards to `warm_registry` (the one warmup
        code path). Compiles every plain pow2 Q bucket up to ``max_batch``;
        unlike the old ad-hoc loop, a short ``qs`` no longer truncates the
        bucket ladder (the registry pass cycles the queries to fill every
        bucket)."""
        if qs:
            self.warm_registry(queries=qs)

    def warm_top_k(self, qs: Sequence[np.ndarray], k: int) -> None:
        """Deprecated shim: forwards to `warm_registry` (top-k kind only),
        compiling the pruned engine's programs -- the per-pow2-bucket bound
        program + the shared rerank chunk program -- for this ``k``."""
        if qs:
            self.warm_registry(ks=(int(k),), kinds=("top_k",), queries=qs)

    # -- lifecycle --------------------------------------------------------

    def drain(self, timeout: float | None = None) -> None:
        """Flush the queue and block until it and the in-flight batch are
        empty (the coalescer stays open). Queued requests are dispatched
        immediately (*drain* trigger) rather than waiting out the coalescing
        window. Raises TimeoutError on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            self._draining += 1
            self._work.notify()
            try:
                while self._depth_locked() or self._in_flight:
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        raise TimeoutError("drain timed out")
                    self._idle.wait(timeout=remaining)
            finally:
                self._draining -= 1

    def shutdown(self, *, drain: bool = True,
                 timeout: float | None = None) -> None:
        """Close admission and stop the dispatcher (idempotent). With
        ``drain`` the queue is flushed first; without, pending requests fail
        with `CoalescerClosedError`."""
        with self._lock:
            if not self._closed:
                self._closed = True
                if not drain:
                    for req in list(self._hi) + list(self._lo):
                        req.popped = True
                        if req.future.set_running_or_notify_cancel():
                            req.future.set_exception(
                                CoalescerClosedError("shutdown(drain=False)"))
                            self._c["failed"].inc()
                            self._tracer.end_request(
                                req.seq, status="failed",
                                reason="shutdown(drain=False)")
                        else:                  # client already cancelled it
                            self._c["cancelled"].inc()
                            self._tracer.end_request(req.seq,
                                                     status="cancelled")
                    self._hi.clear()
                    self._lo.clear()
                self._work.notify_all()
                self._space.notify_all()
                self._idle.notify_all()
        self._thread.join(timeout=timeout)

    def __enter__(self) -> "QueryCoalescer":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=True)

    # -- observability ----------------------------------------------------

    @property
    def guard(self):
        """The `EngineGuard` dispatches route through (None without a
        resilience policy) -- the watchdog's trip() target."""
        return self._guard

    def stats(self) -> ServingStats:
        """Consistent snapshot of counters + latency percentiles. Only the
        raw state is copied under the lock; the percentile math (O(latency
        window)) runs after release so a monitoring poll never stalls
        submitters or the dispatcher."""
        with self._lock:
            scalars = dict(
                queue_depth=self._depth_locked(),
                in_flight=self._in_flight,
                **{f: int(self._c[f].value) for f in (
                    "submitted", "completed", "rejected", "failed",
                    "cancelled", "deadline_misses", "quarantined",
                    "degraded", "write_dispatches", "docs_added",
                    "docs_removed")})
            counts = {t: int(c.value) for t, c in self._c_disp.items()}
            hist = dict(sorted(self._batch_hist.items()))
            lat_snap = list(self._latencies)
            hit_rate = (self._hit_rate_sum / self._hit_rate_n
                        if self._hit_rate_n else None)
            est_ms = self._service_est_s * 1e3
            warmed = self._warmed_shapes
            warm_s = (dict(self._warmup_compile_s)
                      if self._warmup_compile_s is not None else None)
        # the guard has its own lock; never nest it inside ours
        rs = self._guard.stats() if self._guard is not None else None
        lat = np.asarray(lat_snap, np.float64) * 1e3
        n_disp = sum(counts.values())
        total_in_batches = sum(q * c for q, c in hist.items())
        pct = (lambda p: float(np.percentile(lat, p))) if lat.size \
            else (lambda p: 0.0)
        return ServingStats(
            **scalars,
            dispatches=n_disp,
            dispatch_fill=counts["fill"],
            dispatch_window=counts["window"],
            dispatch_deadline=counts["deadline"],
            dispatch_drain=counts["drain"],
            batch_size_hist=hist,
            mean_batch_size=(total_in_batches / n_disp) if n_disp else 0.0,
            latency_ms_mean=float(lat.mean()) if lat.size else 0.0,
            latency_ms_p50=pct(50),
            latency_ms_p95=pct(95),
            latency_ms_p99=pct(99),
            hit_rate=hit_rate,
            service_estimate_ms=est_ms,
            warmed_shapes=warmed,
            warmup_compile_s=warm_s,
            retries=rs.retries if rs else 0,
            breaker_transitions=rs.breaker_transitions if rs else 0,
            breaker_open=rs.breaker_open if rs else 0,
            brownout_active=rs.brownout_active if rs else False)

    # -- dispatcher -------------------------------------------------------

    def _depth_locked(self) -> int:
        return len(self._hi) + len(self._lo)

    def _check_locked(self, now: float) -> tuple[str | None, float | None]:
        """(trigger satisfied right now | None, earliest future fire time).

        O(1) amortized: the oldest queued submit time is the head of each
        FIFO lane and the earliest deadline is the top of the lazy deadline
        heap (stale entries for requests that already left the queue are
        expired here), so the dispatcher never scans the queue.
        """
        n = self._depth_locked()
        if n == 0:
            return None, None
        if n >= self.max_batch:     # full bucket: attribute to fill even
            return "fill", None     # mid-drain/shutdown
        if self._closed or self._draining:
            return "drain", None
        oldest = min(dq[0].t_submit for dq in (self._hi, self._lo) if dq)
        t_window = oldest + self.window_s
        while self._dl_heap and (self._dl_heap[0][2].popped
                                 or self._dl_heap[0][2].future.cancelled()):
            heapq.heappop(self._dl_heap)   # left the queue, or will be
            # discarded at pop time -- either way its deadline must not
            # drive a premature dispatch
        if self._dl_heap:
            # budget with the estimate of the deadline request's OWN op
            # (top-k / plain / write dispatches cost very differently);
            # fall back to the combined EWMA before that op's first sample
            est = self._service_est_kind.get(
                self._dl_heap[0][2].op, self._service_est_s)
            t_deadline = self._dl_heap[0][0] - est - _DEADLINE_MARGIN_S
        else:
            t_deadline = float("inf")
        if now >= t_deadline:
            return "deadline", None
        if now >= t_window:
            return "window", None
        return None, min(t_window, t_deadline)

    def _pop_batch_locked(self) -> list[_Request]:
        """Cut one batch: priority lane first, FIFO within each lane, and
        HOMOGENEOUS in kind -- the cut stops at the first request whose
        (op, k) differs from the batch head's, so a batch is always one
        plain ``query_batch``, one ``top_k_batch(k, prune=True)``, one
        merged ``add_docs``, or one merged ``remove_docs`` call (the next
        cut picks up the other run; FIFO order is never violated --
        which, for the writer lane, is exactly the read-your-writes
        ordering argument: a query submitted after a write ack dispatches
        after the write applied). Requests whose future a client already
        cancelled are discarded here regardless of kind (never
        dispatched, never resolved again -- `set_running_or_notify_cancel`
        also locks the survivors against a later cancel, so the
        dispatcher's fan-out can never hit InvalidStateError)."""
        batch: list[_Request] = []
        kind: object = None
        now = time.monotonic()
        while self._depth_locked() and len(batch) < self.max_batch:
            lane = self._hi or self._lo
            head = lane[0]
            if batch and not head.future.cancelled() \
                    and (head.op, head.k) != kind:
                break               # kind change: leave it for the next cut
            rq = lane.popleft()
            rq.popped = True
            if rq.future.set_running_or_notify_cancel():
                kind = (rq.op, rq.k)
                batch.append(rq)
                if self._tracer.enabled:    # queue wait ends at the cut
                    self._tracer.add_span(rq.seq, "queue", rq.t_submit, now)
            else:
                self._c["cancelled"].inc()
                self._tracer.end_request(rq.seq, t1=now, status="cancelled")
        self._in_flight = len(batch)
        self._g_queue.set(self._depth_locked())
        self._g_inflight.set(len(batch))
        self._space.notify_all()
        return batch

    def _run(self) -> None:
        while True:
            with self._lock:
                while True:
                    if self._closed and not self._depth_locked():
                        self._idle.notify_all()
                        return
                    cause, t_next = self._check_locked(time.monotonic())
                    if cause is not None:
                        break
                    if t_next is not None:
                        self._work.wait(
                            timeout=max(0.0, t_next - time.monotonic()))
                    else:
                        self._work.wait()
                batch = self._pop_batch_locked()
                if not batch:            # every popped request was cancelled
                    self._idle.notify_all()
                    continue
                depth = self._depth_locked()   # post-cut backlog: the
            self._dispatch(batch, cause, depth)  # brownout queue signal

    def _dispatch(self, batch: list[_Request], cause: str,
                  queue_depth: int = 0) -> None:
        """Run one query_batch on the dispatcher thread and fan results out.

        Exactly ``svc.query_batch([r for each request, in batch order])`` --
        nothing is reordered or rewritten between the queue and the engine,
        which is the whole bitwise-identity argument: a direct query_batch
        of the same queries in the same order runs the same program on the
        same inputs.

        Top-k batches (homogeneous by the pop rule) run
        ``svc.top_k_batch(rs, k, prune=True)`` instead and fan out
        ``(idx, dist)`` row pairs -- same determinism argument, now backed
        by the pruned engine's bitwise-identical-to-exact-scan contract.

        Counters are updated BEFORE the result fan-out so a stats() call
        racing a just-resolved future can only see counts that lead the
        futures, never lag them; in_flight is cleared (and drain() woken)
        only AFTER the fan-out, so drain() implies every dispatched future
        is resolved."""
        t0 = time.monotonic()
        err: BaseException | None = None
        results: list = []
        kind = batch[0].k
        op = batch[0].op
        kind_str = op
        degraded: DegradedResult | None = None
        n_added = n_removed = 0
        try:
            if op == "add":
                # writer lane: merge the batch into ONE durable add_docs
                # call (one WAL record + fsync for the whole burst); each
                # future acks its own docs. Writes bypass the resilience
                # guard -- durability is the corpus WAL's contract, and a
                # crash surfaces as recovery, not as a retryable fault.
                ids: list = []
                docs: list = []
                for rq in batch:
                    ids.extend(rq.r[0])
                    docs.extend(rq.r[1])
                self.svc.add_docs(ids, docs)
                results = [len(rq.r[0]) for rq in batch]
                n_added = len(ids)
            elif op == "remove":
                ids = []
                for rq in batch:
                    ids.extend(rq.r)
                self.svc.remove_docs(ids)
                results = [len(rq.r) for rq in batch]
                n_removed = len(ids)
            elif self._guard is not None:
                # resilient route: breaker ladder + retry + brownout
                # (serving.resilience). Rung 0 is the exact call below, so
                # fault-free dispatches stay bitwise identical.
                res = self._guard.dispatch(
                    kind_str, [rq.r for rq in batch], k=kind,
                    queue_depth=queue_depth, miss_ewma=self._miss_ewma)
                if isinstance(res, DegradedResult):
                    degraded, res = res, res.value
            elif kind is None:
                res = self.svc.query_batch([rq.r for rq in batch])
            else:
                res = self.svc.top_k_batch(
                    [rq.r for rq in batch], kind, prune=True)
            if op == "plain":
                results = [res[i] for i in range(len(batch))]
            elif op == "top_k":
                idx, dist = res
                results = [(idx[i], dist[i]) for i in range(len(batch))]
        except BaseException as e:            # noqa: BLE001 -- fan out to
            err = e                           # futures, keep serving
        t_done = time.monotonic()
        with self._lock:
            is_write = op in ("add", "remove")
            info = getattr(self.svc, "last_batch_stats", None) or {}
            # writes don't run the query engine: last_batch_stats is the
            # PREVIOUS query dispatch's -- never fold it into hit_rate
            if err is None and not is_write and "hit_rate" in info:
                self._hit_rate_sum += float(info["hit_rate"])
                self._hit_rate_n += 1
            ewma = 0.7 * self._service_est_s + 0.3 * (t_done - t0)
            self._service_est_s = ewma if self._service_est_s else t_done - t0
            prev = self._service_est_kind.get(op)
            self._service_est_kind[op] = (
                t_done - t0 if prev is None
                else 0.7 * prev + 0.3 * (t_done - t0))
            self._c_disp[cause].inc()
            self._batch_hist[len(batch)] += 1
            self._h_batch.observe(len(batch))
            self._g_est.set(self._service_est_s)
            self.batch_log.append(tuple(rq.seq for rq in batch))
            prune = {}
            if is_write:
                self._c["write_dispatches"].inc()
                if err is None:
                    self._c["docs_added"].inc(n_added)
                    self._c["docs_removed"].inc(n_removed)
            else:
                # program-shape telemetry is query-only: a write dispatch
                # compiles nothing, so it must not trip the warmup
                # shape-coverage cross-check
                self.shape_log.append((op, len(batch), batch[0].k))
                if err is None:
                    if op == "top_k":
                        prune = getattr(self.svc, "last_prune_stats",
                                        None) or {}
                    for key, ph in (("precompute_s", "precompute"),
                                    ("solve_s", "solve")):
                        if key in info:
                            self._c_phase[ph].inc(float(info[key]))
                    for key, ph in (("bound_s", "bound"),
                                    ("rerank_s", "rerank")):
                        if key in prune:
                            self._c_phase[ph].inc(float(prune[key]))
            missed_by_seq: dict[int, bool] = {}
            for rq in batch:
                if err is None:
                    self._c["completed"].inc()
                    if degraded is not None:
                        self._c["degraded"].inc()
                    self._latencies.append(t_done - rq.t_submit)
                    self._h_latency.observe(t_done - rq.t_submit)
                    missed = (rq.deadline is not None
                              and t_done > rq.deadline)
                    missed_by_seq[rq.seq] = missed
                    if missed:
                        self._c["deadline_misses"].inc()
                    self._miss_ewma = (0.9 * self._miss_ewma
                                       + 0.1 * float(missed))
                else:
                    self._c["failed"].inc()
        if self._tracer.enabled:
            rung = None
            if self._guard is not None and self._guard.dispatch_log:
                rung = self._guard.dispatch_log[-1][1]
            # the engine's phases where they ran: an engine that reports a
            # phase's seconds without its start (precompute_t0 / solve_t0,
            # on this clock) gets no child for it
            phase = {}
            if err is None and not is_write:
                for ph in ("precompute", "solve"):
                    s, at = info.get(f"{ph}_s"), info.get(f"{ph}_t0")
                    if s and at is not None:
                        phase[ph] = (float(at), float(at) + float(s))
            status = ("failed" if err is not None
                      else "degraded" if degraded is not None else "ok")
            for rq in batch:
                self._tracer.add_span(
                    rq.seq, "dispatch", t0, t_done, op=op, cause=cause,
                    batch=len(batch), rung=rung,
                    hit_rate=info.get("hit_rate"),
                    tier=(degraded.tier if degraded is not None else None))
                if "precompute" in phase:
                    self._tracer.add_span(
                        rq.seq, "precompute", *phase["precompute"],
                        hits=info.get("hits"), misses=info.get("misses"))
                if "solve" in phase:
                    self._tracer.add_span(
                        rq.seq, "solve", *phase["solve"],
                        n_iter=getattr(getattr(self.svc, "cfg", None),
                                       "max_iter", None),
                        bound_s=prune.get("bound_s"),
                        rerank_s=prune.get("rerank_s"),
                        solves_avoided=prune.get("solves_avoided"))
                self._tracer.end_request(
                    rq.seq, t1=t_done, status=status,
                    deadline_missed=missed_by_seq.get(rq.seq, False),
                    reason=(degraded.reason if degraded is not None
                            else type(err).__name__ if err is not None
                            else None))
        if self._heartbeat is not None:
            try:
                self._heartbeat(kind_str, t_done - t0, err is None)
            except Exception:                 # noqa: BLE001 -- monitoring
                pass                          # must never kill serving
        for i, rq in enumerate(batch):
            if err is None:
                if degraded is not None:
                    rq.future.set_result(DegradedResult(
                        value=results[i], reason=degraded.reason,
                        tier=degraded.tier))
                else:
                    rq.future.set_result(results[i])
            else:
                rq.future.set_exception(err)
        with self._lock:
            self._in_flight = 0
            self._g_inflight.set(0)
            self._idle.notify_all()
