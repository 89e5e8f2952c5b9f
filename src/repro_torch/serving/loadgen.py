"""Load generators for the WMD serving stack (open-loop and closed-loop).

A copy of `repro.serving.loadgen`.

Two canonical client models drive `serving.coalescer.QueryCoalescer` (or any
``submit(r) -> Future`` callable, including a synchronous baseline wrapped to
return finished futures):

* **open loop** (`open_loop`) -- Poisson arrivals at ``rate_qps``: requests
  fire on an exponential-interarrival schedule *independent of completions*,
  the serving-systems model of "millions of users" (load does not politely
  wait for the server). Under saturation the queue grows and backpressure
  engages; rejected submits (`QueueFullError`) are counted, not retried.
* **closed loop** (`closed_loop`) -- ``concurrency`` worker threads each
  submit-and-wait in a loop: offered load adapts to service rate, the model
  of a fixed client pool. At high concurrency this is the *saturating load*
  (the coalescer sees a full queue and cuts fill-triggered batches back to
  back).

Both measure **client-side** latency (submit call -> future resolved, via a
done-callback, so it includes queueing + coalescing + solve) and return a
`LoadgenResult` with throughput and percentiles. Query streams come from any
iterable of (V,) histograms -- `data.zipf_query_stream` is the realistic
skewed source (take ``itertools.islice(stream, n)``).

Used by `launch/serve.py --coalesce-window-ms` (the serving loop) and
`chip_smoke.py` phase 9 (the open loop on the card).
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Callable, Iterable

import numpy as np

from repro_torch.serving.coalescer import QueueFullError


@dataclasses.dataclass
class LoadgenResult:
    """Client-side view of one load-generation run."""
    mode: str                      # "open" | "closed"
    offered_qps: float             # open: configured rate; closed: achieved
    duration_s: float              # first submit -> last completion
    submitted: int
    completed: int
    rejected: int                  # QueueFullError submits (open loop)
    failed: int                    # futures that resolved to an exception
    latencies_ms: np.ndarray       # per completed request, submit order
    results: list | None           # per-request rows iff keep_results

    @property
    def throughput_qps(self) -> float:
        return self.completed / self.duration_s if self.duration_s else 0.0

    def percentile_ms(self, p: float) -> float:
        return (float(np.percentile(self.latencies_ms, p))
                if self.latencies_ms.size else 0.0)

    def summary(self) -> dict:
        """JSON-friendly fields of the run."""
        return {"mode": self.mode, "offered_qps": self.offered_qps,
                "duration_s": self.duration_s, "submitted": self.submitted,
                "completed": self.completed, "rejected": self.rejected,
                "failed": self.failed,
                "throughput_qps": self.throughput_qps,
                "latency_ms_mean": (float(self.latencies_ms.mean())
                                    if self.latencies_ms.size else 0.0),
                "latency_ms_p50": self.percentile_ms(50),
                "latency_ms_p95": self.percentile_ms(95),
                "latency_ms_p99": self.percentile_ms(99)}


class _Tracker:
    """Per-request completion bookkeeping shared by both loops."""

    def __init__(self, keep_results: bool):
        self.lock = threading.Lock()
        self.done = threading.Condition(self.lock)
        self.latency_by_idx: dict[int, float] = {}
        self.results: dict[int, np.ndarray] | None = \
            {} if keep_results else None
        self.failed = 0
        self.pending = 0
        self.t_last_done = 0.0

    def attach(self, idx: int, t_submit: float, fut) -> None:
        with self.lock:
            self.pending += 1

        def _on_done(f, idx=idx, t_submit=t_submit):
            t = time.monotonic()
            with self.lock:
                if f.exception() is not None:
                    self.failed += 1
                else:
                    self.latency_by_idx[idx] = t - t_submit
                    if self.results is not None:
                        self.results[idx] = f.result()
                self.t_last_done = max(self.t_last_done, t)
                self.pending -= 1
                self.done.notify_all()
        fut.add_done_callback(_on_done)

    def wait_all(self) -> None:
        with self.lock:
            while self.pending:
                self.done.wait()

    def finish(self, *, mode: str, offered_qps: float, t_start: float,
               submitted: int, rejected: int) -> LoadgenResult:
        self.wait_all()
        with self.lock:
            order = sorted(self.latency_by_idx)
            lat = np.asarray([self.latency_by_idx[i] for i in order]) * 1e3
            results = ([self.results[i] for i in order]
                       if self.results is not None else None)
            duration = max(self.t_last_done - t_start, 1e-9)
            return LoadgenResult(
                mode=mode, offered_qps=offered_qps, duration_s=duration,
                submitted=submitted, completed=len(order),
                rejected=rejected, failed=self.failed,
                latencies_ms=lat, results=results)


def open_loop(submit: Callable, queries: Iterable[np.ndarray], *,
              rate_qps: float, n_requests: int | None = None,
              seed: int = 0, keep_results: bool = False) -> LoadgenResult:
    """Poisson open-loop driver: submit ``n_requests`` queries at
    exponential interarrivals of mean ``1/rate_qps``, never waiting for
    completions. ``queries`` is any iterable of (V,) histograms (truncated
    to ``n_requests`` when given). The schedule is seeded and absolute
    (submission k fires at t0 + sum of the first k gaps), so a slow submit
    makes the driver catch up rather than silently lower the offered rate.
    """
    qs = list(queries if n_requests is None
              else itertools.islice(queries, n_requests))
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_qps, size=len(qs)))
    tracker = _Tracker(keep_results)
    rejected = submitted = 0
    t0 = time.monotonic()
    for r, at in zip(qs, arrivals):
        delay = t0 + at - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        t_submit = time.monotonic()
        try:
            fut = submit(r)
        except QueueFullError:
            rejected += 1
            continue
        submitted += 1
        tracker.attach(submitted - 1, t_submit, fut)
    return tracker.finish(mode="open", offered_qps=rate_qps, t_start=t0,
                          submitted=submitted, rejected=rejected)


def closed_loop(submit: Callable, queries: Iterable[np.ndarray], *,
                concurrency: int = 4,
                keep_results: bool = False) -> LoadgenResult:
    """Fixed-concurrency closed-loop driver: ``concurrency`` threads each
    take the next query, submit, and block on the result before taking
    another. ``submit`` may return a Future or the result itself (so a
    synchronous per-query baseline plugs in unchanged)."""
    qs = list(queries)
    tracker = _Tracker(keep_results)
    it_lock = threading.Lock()
    it = iter(enumerate(qs))
    counts = {"submitted": 0, "rejected": 0}
    t0 = time.monotonic()

    def worker():
        while True:
            with it_lock:
                try:
                    idx, r = next(it)
                except StopIteration:
                    return
            t_submit = time.monotonic()
            try:
                out = submit(r)
            except QueueFullError:       # closed loop shouldn't hit this,
                with it_lock:            # but never let a worker die on it
                    counts["rejected"] += 1
                continue
            with it_lock:
                counts["submitted"] += 1
            if hasattr(out, "add_done_callback"):
                tracker.attach(idx, t_submit, out)
                try:
                    out.result()         # closed loop: wait before next
                except Exception:        # noqa: BLE001 -- counted failed by
                    pass                 # the done-callback; keep draining
            else:                        # synchronous baseline path
                t = time.monotonic()
                with tracker.lock:
                    tracker.latency_by_idx[idx] = t - t_submit
                    if tracker.results is not None:
                        tracker.results[idx] = out
                    tracker.t_last_done = max(tracker.t_last_done, t)

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    res = tracker.finish(mode="closed", offered_qps=0.0, t_start=t0,
                         submitted=counts["submitted"],
                         rejected=counts["rejected"])
    res.offered_qps = res.throughput_qps    # closed loop: offered == served
    return res
