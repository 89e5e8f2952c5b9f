"""Offline bulk-scoring mode: stream a query file through the engine at
maximum batch occupancy -- no admission windows, no deadlines, no queue.

A copy of `repro.serving.offline`; the query file format is the
reference's, so either package reads the other's files.

The online path (`QueryCoalescer`) optimizes *latency under uncertainty*:
it cuts a batch the moment waiting longer would hurt the oldest request,
so batches are as full as traffic allows. Offline scoring inverts the
contract -- the whole workload is known up front, nobody is waiting on any
single row -- so the right schedule is trivial and maximal: walk the query
list in order, cut every batch at the full ``max_batch`` bucket, and keep
the device at 100% occupancy. This is MLPerf's offline scenario applied to
WMD retrieval.

Top-k batches additionally use **union rerank** (``rerank="union"``,
`WMDService._top_k_union`): one (Q, chunk) stripes program per candidate
block for the whole batch instead of Q separate (1, chunk) programs --
exactly the batch-amortization the paper's headline is built on, now
applied to the rerank tier. For correlated queries (the realistic Zipf
workload) the candidate sets overlap heavily, so the union schedule runs
close to 1/Q the programs of the per-query loop.

Bitwise contract (gated by tests/test_torch_offline.py):

* **top-k** output is bit-identical to the online path on the same queries
  REGARDLESS of batch composition: the rerank tier's fixed-shape stripes
  programs compute each (query, doc) cell over its own nnz/v_r axes only
  (bit-stable across chunk-mates AND Q-mates -- the K-cache's fixed-shape
  reproducibility argument extended across Q), and union rerank prunes
  only docs provably outside the top-k. pruned == scan == union, bitwise.
* **plain** distance rows carry the coalescer's contract: bit-identical
  to a direct ``query_batch`` of the same queries in the same buckets.
  On the card the kernels reduce each (query, doc) cell over its own
  axes, so a row does not depend on its batch at all (`chip_smoke.py`
  phases 8 and 9); the plain versions promise equal bits only for the
  same compositions -- which a saturating in-order stream cuts -- and
  fp32 tolerance otherwise. Anything beyond that is a correctness bug,
  not a tuning regression.

CLI: ``launch/serve.py --offline queries.npz [--offline-out out.npz]``.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Sequence

import numpy as np

from repro_torch.core.formats import next_pow2 as _next_pow2


def load_query_file(path: str | os.PathLike) -> list[np.ndarray]:
    """Load an offline query workload: a ``.npz`` with a ``queries`` array
    (or a single unnamed array), or a ``.npy`` -- either way an (n, V)
    float matrix of query histograms, returned as n (V,) float32 rows."""
    path = os.fspath(path)
    if path.endswith(".npz"):
        with np.load(path) as z:
            if "queries" in z.files:
                mat = z["queries"]
            elif len(z.files) == 1:
                mat = z[z.files[0]]
            else:
                raise ValueError(
                    f"{path}: expected a 'queries' array, found {z.files}")
    else:
        mat = np.load(path)
    mat = np.asarray(mat, np.float32)
    if mat.ndim != 2:
        raise ValueError(f"{path}: expected (n, V) queries, "
                         f"got shape {mat.shape}")
    return [mat[i] for i in range(mat.shape[0])]


def save_query_file(path: str | os.PathLike,
                    queries: Sequence[np.ndarray]) -> str:
    """Write a query workload in `load_query_file`'s format."""
    path = os.fspath(path)
    mat = np.stack([np.asarray(q, np.float32) for q in queries])
    if path.endswith(".npz"):
        np.savez(path, queries=mat)
    else:
        np.save(path, mat)
    return path


@dataclasses.dataclass
class OfflineResult:
    """Outcome of one offline bulk-scoring run (results in input order)."""
    mode: str                     # "plain" | "top_k"
    n: int                        # queries scored
    batches: int                  # engine dispatches
    max_batch: int                # occupancy target (pow2)
    wall_s: float                 # first dispatch -> last result
    k: int | None
    rerank: str | None            # top-k only: "union" | "per_query"
    dists: np.ndarray | None      # plain: (n, N)
    topk_idx: np.ndarray | None   # top-k: (n, k)
    topk_dist: np.ndarray | None  # top-k: (n, k)
    solves_avoided: float | None  # top-k: pruned fraction, query-weighted
    rerank_programs: int | None   # top-k: total rerank dispatches

    @property
    def throughput_qps(self) -> float:
        return self.n / self.wall_s if self.wall_s else 0.0

    def summary(self) -> dict:
        """JSON-friendly fields of the run."""
        out = {"mode": self.mode, "n": self.n, "batches": self.batches,
               "max_batch": self.max_batch, "wall_s": self.wall_s,
               "throughput_qps": self.throughput_qps}
        if self.mode == "top_k":
            out.update(k=self.k, rerank=self.rerank,
                       solves_avoided=self.solves_avoided,
                       rerank_programs=self.rerank_programs)
        return out

    def save(self, path: str | os.PathLike) -> str:
        """Persist the scored outputs (npz) next to the summary fields."""
        arrays = {k: v for k, v in
                  (("dists", self.dists), ("topk_idx", self.topk_idx),
                   ("topk_dist", self.topk_dist)) if v is not None}
        np.savez(os.fspath(path), **arrays)
        return os.fspath(path)


def run_offline(svc, queries: Sequence[np.ndarray], *,
                k: int | None = None, max_batch: int = 16,
                rerank: str = "union", impl: str | None = None,
                use_cache: bool | None = None) -> OfflineResult:
    """Score every query at maximum batch occupancy.

    ``k=None`` scores plain distance rows; otherwise pruned top-k with
    ``rerank`` picking the rerank batching ("union" -- the offline
    default -- or "per_query", the online path's strategy, kept callable
    so the bitwise gate can compare both in one process). Queries are
    walked in order and cut into full ``max_batch`` buckets (the final
    partial batch pads like any online dispatch), so results are in input
    order; top-k output is bit-identical to ANY other batching of the
    same queries, plain rows to the same buckets (module docstring)."""
    if rerank not in ("union", "per_query"):
        raise ValueError(f"rerank must be union|per_query, got {rerank!r}")
    qs = list(queries)
    bucket = _next_pow2(max(int(max_batch), 1))
    kw = {}
    if impl is not None:
        kw["impl"] = impl
    if use_cache is not None:
        kw["use_cache"] = use_cache
    rows, idxs, dists = [], [], []
    solves = avoided_w = 0.0
    programs = 0
    batches = 0
    t0 = time.perf_counter()
    for lo in range(0, len(qs), bucket):
        batch = qs[lo:lo + bucket]
        batches += 1
        if k is None:
            rows.append(svc.query_batch(batch, **kw))
        else:
            idx_b, d_b = svc.top_k_batch(batch, k, prune=True,
                                         rerank=rerank, **kw)
            idxs.append(idx_b)
            dists.append(d_b)
            st = getattr(svc, "last_prune_stats", None) or {}
            if "solves_avoided" in st:
                avoided_w += st["solves_avoided"] * len(batch)
                solves += len(batch)
            programs += int(st.get("rerank_programs", 0))
    wall = time.perf_counter() - t0
    if k is None:
        return OfflineResult(
            mode="plain", n=len(qs), batches=batches, max_batch=bucket,
            wall_s=wall, k=None, rerank=None,
            dists=np.concatenate(rows) if rows else
            np.zeros((0, svc.ell.num_docs), np.float32),
            topk_idx=None, topk_dist=None,
            solves_avoided=None, rerank_programs=None)
    k_eff = min(k, svc.ell.num_docs)
    return OfflineResult(
        mode="top_k", n=len(qs), batches=batches, max_batch=bucket,
        wall_s=wall, k=k, rerank=rerank, dists=None,
        topk_idx=np.concatenate(idxs) if idxs else
        np.zeros((0, k_eff), np.int64),
        topk_dist=np.concatenate(dists) if dists else
        np.zeros((0, k_eff), np.float32),
        solves_avoided=(avoided_w / solves) if solves else None,
        rerank_programs=programs)
