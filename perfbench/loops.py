"""The one traffic generator: it reads a traffic mix's parameters and drives
the service with a closed loop of batches or an open loop of single
requests. Frozen here, so a later change to the program's own load
generators cannot move the benchmark.

* closed (``"loop": "closed"``): one client sends batches of ``batch``
  queries back to back through ``query_batch``; the window ends when the
  batch in flight at ``seconds`` returns, and the rate is all the queries
  answered over all the window's seconds.
* open (``"loop": "open"``): ``round(rate_qps * seconds)`` requests, due
  at times drawn uniformly over the window and sorted (a Poisson process
  given its count, so every seed sends the same number of requests), each
  submitted at its due time through the coalescer. Each request is timed
  from when it was due until its future resolves, so a stall of the
  generator counts against the requests it delays; how late the generator
  submitted is reported beside it.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from perfbench.corpus import DenseRows, QueryPool

WAIT_AFTER_CLOSE_S = 60.0


@dataclasses.dataclass
class ClosedResult:
    t0: float
    t1: float
    batches: list            # per batch: dict of host span and phase split
    queries: int
    kept: dict               # batch index -> (pool rows, (Q, N) output)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


def closed_loop(svc, pool: QueryPool, *, vocab_size: int, batch: int,
                seconds: float, keep: int, rng: np.random.Generator,
                on_tick=None) -> ClosedResult:
    """Batches of ``batch`` pool queries (the pool read in order, wrapping
    round) for ``seconds``; a reservoir of ``keep`` batches' outputs, drawn
    with ``rng``, is kept for the comparison. ``on_tick(elapsed)`` runs
    between batches (the traced run starts and stops its profiler)."""
    rows = DenseRows(2 * batch, vocab_size)
    kept: dict = {}
    recs = []
    n_pool = len(pool)
    t0 = time.monotonic()
    i = 0
    while True:
        now = time.monotonic()
        if now - t0 >= seconds:
            break
        if on_tick is not None:
            on_tick(now - t0)
        idx = (np.arange(batch) + i * batch) % n_pool
        half = (i % 2) * batch
        rs = [rows.put(half + j, pool.ids[q], pool.weights[q])
              for j, q in enumerate(idx)]
        ts = time.monotonic()
        out = svc.query_batch(rs)
        te = time.monotonic()
        st = dict(svc.last_batch_stats)
        recs.append({"t0": ts, "t1": te,
                     "precompute_s": st.get("precompute_s", 0.0),
                     "solve_s": st.get("solve_s", 0.0)})
        if i < keep:
            kept[i] = (idx, out)
        else:
            j = int(rng.integers(0, i + 1))
            if j < keep:
                victim = sorted(kept)[j]
                del kept[victim]
                kept[i] = (idx, out)
        i += 1
    t1 = time.monotonic()
    return ClosedResult(t0=t0, t1=t1, batches=recs, queries=i * batch,
                        kept=kept)


@dataclasses.dataclass
class OpenResult:
    t0: float
    due: np.ndarray          # (n,) due times, monotonic
    submitted: np.ndarray    # (n,) submit times (nan: never submitted)
    done: np.ndarray         # (n,) resolve times (nan: never resolved)
    ok: np.ndarray           # (n,) bool: resolved with a result
    results: dict            # request index -> (ids, dists) of sampled
    pool_rows: np.ndarray    # (n,) pool row of each request

    @property
    def latency_s(self) -> np.ndarray:
        return (self.done - self.due)[self.ok]

    @property
    def late_s(self) -> np.ndarray:
        return self.submitted - self.due


def open_loop(submit, pool: QueryPool, *, vocab_size: int, rate_qps: float,
              seconds: float, rng: np.random.Generator, sample: int,
              ring: int = 1024, on_tick=None) -> OpenResult:
    """Requests at ``rate_qps`` over ``seconds`` through ``submit(r) ->
    Future``; the results of ``sample`` requests drawn with ``rng`` are
    kept for the comparison. Waits up to a minute past the close for the
    last futures."""
    n = max(1, int(round(rate_qps * seconds)))
    offsets = np.sort(rng.uniform(0.0, seconds, n))
    pool_rows = (rng.permutation(len(pool))[:n] if n <= len(pool)
                 else np.arange(n) % len(pool))
    sampled = set(rng.choice(n, size=min(sample, n), replace=False).tolist())
    rows = DenseRows(ring, vocab_size)
    futs: list = [None] * n
    done = np.full(n, np.nan)
    submitted = np.full(n, np.nan)
    ok = np.zeros(n, bool)
    results: dict = {}
    lock = threading.Lock()

    def finish(i, fut):
        t = time.monotonic()
        with lock:
            done[i] = t
            if fut.exception() is None:
                ok[i] = True
                if i in sampled:
                    results[i] = fut.result()

    t0 = time.monotonic()
    due = t0 + offsets
    for i in range(n):
        if on_tick is not None:
            on_tick(time.monotonic() - t0)
        slot = i % ring
        prev = futs[i - ring] if i >= ring else None
        if prev is not None:
            prev.exception()            # the row is still queued: wait
        wait = due[i] - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        q = pool_rows[i]
        r = rows.put(slot, pool.ids[q], pool.weights[q])
        submitted[i] = time.monotonic()
        try:
            f = submit(r)
        except Exception:               # rejected at admission: failed
            continue
        futs[i] = f
        f.add_done_callback(lambda fut, i=i: finish(i, fut))
    deadline = max(t0 + seconds, time.monotonic()) + WAIT_AFTER_CLOSE_S
    for f in futs:
        if f is None:
            continue
        left = deadline - time.monotonic()
        if left <= 0:
            break
        try:
            f.exception(timeout=left)
        except Exception:               # timed out: never came
            break
    with lock:
        return OpenResult(t0=t0, due=due, submitted=submitted,
                          done=done.copy(), ok=ok.copy(),
                          results=dict(results), pool_rows=pool_rows)
