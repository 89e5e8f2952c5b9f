"""Batched Sinkhorn-WMD query service on one GPU.

Port of the single-device serving path of `repro.serving.wmd_service`. The
corpus (embeddings + ELL, rebucketed to one vocab shard) is loaded onto the
device once; queries are solved by the fused SDDMM-SpMM engine.

Service API
-----------
  query(r)                  -- one (V,) histogram -> (N,) distances. Runs
      the batched engine at Q = 1, so a singleton goes through the same
      kernels as a batch.
  query_batch(rs, impl=..., docs_chunk=..., use_cache=...) -- Q histograms
      -> (Q, N). Queries are padded to the service's v_r bucket (exact
      mask-based padding, `core.distributed.pad_query_batch`) and admitted
      in power-of-two Q buckets (filler queries carry an all-zero row mask
      and are sliced off). Two routes, as in the reference:
        * stripes (``cache_capacity > 0`` or an explicit ``use_cache``):
          `core.kcache.KCache` dedups word ids across the batch, computes
          only missing K / K.*M rows (``kexp_impl``) and slot-gathers the
          (1, Q, v_r, V+1) stripes for `build_wmd_batch_fn_stripes`;
          ``use_cache=False`` is the transient baseline, bitwise identical
          to the cached path;
        * legacy (cache disabled, no routing request): the precompute runs
          inside the solve (`build_wmd_batch_fn`, `masked_k_batch`).
  query_batch_sequential(rs) -- the per-query loop (oracle / baseline).
  top_k(r, k) / top_k_batch(rs, k) -- nearest-k doc ids + distances, with
      the reference's tie-deterministic selection.

Not in this slice (each raises NotImplementedError naming the ROADMAP
queue item that brings it): ``prune=True`` and `top_k_scan_batch` (the
retrieval cascade), the bounds tier (`query_batch_bounds`,
`top_k_batch_bounds`), `from_live` and the corpus mutators (the live
corpus), and `async_service` (the async front-end).

Knobs (constructor fields): ``impl`` ("kernel" default: the CUDA kernels on
the card, their plain versions on the CPU; "fused" / "unfused" are the
paper's baselines), ``docs_chunk``, ``tol``, ``cache_capacity``,
``cache_rows_bucket``, ``kexp_impl`` ("kernel" default, or "jnp": the plain
matmul spelling; the value names are the reference's), ``guards``,
``metrics``. ``device`` replaces the reference's ``mesh``: "cuda" by
default; a default service on a machine without a card raises.

Observability: ``cache_stats`` (cumulative), ``cache_resident`` and
``last_batch_stats`` (``precompute_s`` / ``solve_s`` phase split and the
batch's hit_rate on the stripes route; ``solve_s`` with
``phases_separable=False`` on the legacy route). Host times are taken after
a device synchronize.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.configs import sinkhorn_wmd as wmd_cfg
from repro_torch.core import formats
from repro_torch.core import guards as _guards
from repro_torch.core.distributed import (build_wmd_batch_fn,
                                          build_wmd_batch_fn_stripes,
                                          pad_query_batch)
from repro_torch.core.kcache import KCache
from repro_torch.core.sinkhorn import select_query


def _serialized(fn):
    """Serialize an engine entry point on the service's reentrant lock (the
    K cache mutates a host slot map and device buffers)."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._engine_lock:
            return fn(self, *args, **kwargs)
    return wrapper


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet: ROADMAP.md Queue 1, "
        f"{item}")


# sentinel: "use the service's docs_chunk" (None already means unchunked)
_UNSET = object()


@dataclasses.dataclass
class WMDService:
    cfg: wmd_cfg.WMDConfig
    vecs: np.ndarray | torch.Tensor
    ell: formats.EllDocs | None = None
    device: str | torch.device = "cuda"
    impl: str = "kernel"
    docs_chunk: int | None = None
    tol: float = 0.0
    cache_capacity: int = 0
    cache_rows_bucket: int = 128
    kexp_impl: str = "kernel"
    guards: bool = True
    metrics: object | None = None       # repro_torch.obs.MetricsRegistry

    @classmethod
    def from_state(cls, cfg, state, **kw) -> "WMDService":
        """Build a service on a `repro_torch.convert.WMDState` (embeddings
        already on the device); the service runs where they lie."""
        kw.setdefault("device", state.vecs.device)
        return cls(cfg=cfg, vecs=state.vecs, ell=state.ell, **kw)

    @classmethod
    def from_live(cls, *args, **kw):
        _not_ported("WMDService.from_live (live corpus)",
                    "item 'Live corpus'")

    def __post_init__(self):
        if self.ell is None:
            raise ValueError("WMDService needs ell=")
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("WMDService(device='cuda') needs an NVIDIA "
                               "GPU; pass device='cpu' for the plain "
                               "PyTorch versions")
        self._vecs_d = torch.as_tensor(self.vecs, dtype=torch.float32,
                                       device=self.device).contiguous()
        vecs_np = self._vecs_d.cpu().numpy()
        self._rb = formats.rebucket_for_vocab_shards(self.ell, 1)
        self._cols_d = torch.from_numpy(self._rb.cols).to(self.device)
        self._vals_d = torch.from_numpy(self._rb.vals).to(self.device)
        self._batch_fns: dict[tuple, object] = {}
        self._stripe_fns: dict[tuple, object] = {}
        if self.metrics is None:
            from repro_torch.obs.metrics import MetricsRegistry
            self.metrics = MetricsRegistry()
        self._kcache = KCache(self.cache_capacity, self._vecs_d,
                              self.cfg.lamb, device=self.device,
                              rows_bucket=self.cache_rows_bucket,
                              kexp_impl=self.kexp_impl,
                              metrics=self.metrics)
        # numeric-guard state: the underflow gate needs the largest
        # embedding norm; docs with zero mass legitimately solve to 0
        self._max_vec_norm = float(np.sqrt(
            (vecs_np.astype(np.float64) ** 2).sum(axis=-1).max())) \
            if vecs_np.size else 0.0
        self._empty_doc_mask = np.asarray(self.ell.vals.sum(axis=-1) == 0)
        self.last_batch_stats: dict = {}
        self._engine_lock = threading.RLock()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- not in this slice --------------------------------------------------

    def async_service(self, **kw):
        _not_ported("WMDService.async_service (async front-end)",
                    "item 'Async serving front-end'")

    def add_docs(self, ids, docs):
        _not_ported("WMDService.add_docs (live corpus)",
                    "item 'Live corpus'")

    def remove_docs(self, ids):
        _not_ported("WMDService.remove_docs (live corpus)",
                    "item 'Live corpus'")

    def compact(self):
        _not_ported("WMDService.compact (live corpus)",
                    "item 'Live corpus'")

    def query_batch_bounds(self, rs):
        _not_ported("WMDService.query_batch_bounds (the bounds tier)",
                    "item 'The retrieval cascade'")

    def top_k_batch_bounds(self, rs, k: int = 10):
        _not_ported("WMDService.top_k_batch_bounds (the bounds tier)",
                    "item 'The retrieval cascade'")

    def top_k_scan_batch(self, rs, k: int = 10, **kw):
        _not_ported("WMDService.top_k_scan_batch (pruned top-k oracle)",
                    "item 'The retrieval cascade'")

    @_serialized
    def invalidate_embedding_rows(self, word_ids) -> int:
        """Scoped cache invalidation for embedding updates: drops exactly
        the K/K.*M rows of ``word_ids``; returns how many were resident."""
        return self._kcache.invalidate_ids(word_ids)

    # -- numeric guards -------------------------------------------------------

    def _underflow_risk(self) -> bool:
        """Is the lambda-underflow post-check armed for the current lambda?
        False at every shipped config."""
        return self.guards and _guards.underflow_possible(
            self.cfg.lamb, self._max_vec_norm)

    def _validate_queries(self, rs) -> None:
        if not self.guards:
            return
        v = self._vecs_d.shape[0]
        for i, r in enumerate(rs):
            try:
                _guards.validate_query(r, v)
            except _guards.InvalidQueryError as e:
                e.context["query_index"] = i
                raise

    def _check_km(self, km_s, mask_b) -> None:
        """Lambda-underflow pre-check on assembled K*M stripes; the big
        reduction runs on the device, only (Q, v_r) scalars come back."""
        if not self.guards:
            return
        rowmax = torch.amax(torch.abs(km_s), dim=(0, -1)).cpu().numpy()
        _guards.check_km_rows(rowmax, mask_b, lamb=self.cfg.lamb)

    def _check_result(self, d, *, what: str) -> None:
        if not self.guards:
            return
        _guards.check_distances(d, lamb=self.cfg.lamb,
                                risk=self._underflow_risk(),
                                empty_doc_mask=self._empty_doc_mask,
                                what=what)

    @property
    def cache_stats(self):
        """Cumulative cross-query cache counters (`core.kcache.KCacheStats`)."""
        return self._kcache.stats

    @property
    def cache_resident(self) -> int:
        """Word-id rows currently resident in the cross-query cache."""
        return self._kcache.resident

    # -- solver programs ------------------------------------------------------

    def _batch_fn(self, impl: str, docs_chunk: int | None):
        """Single-program batched solver (precompute inside), keyed like the
        reference's so a mutated tol / cfg.lamb never serves a stale fn."""
        key = (impl, docs_chunk, self.tol, self.cfg.lamb)
        fn = self._batch_fns.get(key)
        if fn is None:
            fn = build_wmd_batch_fn(lamb=self.cfg.lamb,
                                    max_iter=self.cfg.max_iter, impl=impl,
                                    docs_chunk=docs_chunk, tol=self.tol)
            self._batch_fns[key] = fn
        return fn

    def _stripe_fn(self, impl: str, docs_chunk: int | None):
        """Batched solver on cache-assembled stripes."""
        key = (impl, docs_chunk, self.tol)
        fn = self._stripe_fns.get(key)
        if fn is None:
            fn = build_wmd_batch_fn_stripes(max_iter=self.cfg.max_iter,
                                            impl=impl, docs_chunk=docs_chunk,
                                            tol=self.tol)
            self._stripe_fns[key] = fn
        return fn

    # -- queries --------------------------------------------------------------

    @_serialized
    def query(self, r: np.ndarray) -> np.ndarray:
        """r: (V,) sparse query histogram -> (N,) distances, through the
        batched engine at Q = 1."""
        return self.query_batch([r])[0]

    @_serialized
    def query_batch(self, rs: Sequence[np.ndarray],
                    impl: str | None = None,
                    docs_chunk=_UNSET,
                    use_cache: bool | None = None) -> np.ndarray:
        """Multiple queries -> (Q, N) via the batched (Q, v_r, N) engine.

        ``impl`` / ``docs_chunk`` override the service defaults for this
        call (docs_chunk=0 for explicitly unchunked); ``use_cache`` routes
        explicitly (False = transient stripes baseline, bitwise identical
        to the cached path; True = stripes engine even with the cache
        disabled). See the module docstring for the routes."""
        if len(rs) == 0:
            return np.zeros((0, self.ell.num_docs), np.float32)
        self._validate_queries(rs)
        # an armed underflow gate routes through the stripes engine so the
        # K*M pre-check sees the assembled rows (off at shipped lambdas)
        risk = self._underflow_risk()
        sel_b, r_b, mask_b = self._padded_query_batch(rs)
        q = len(rs)
        dc = self.docs_chunk if docs_chunk is _UNSET else (docs_chunk or None)
        r_d = torch.from_numpy(r_b).to(self.device)
        if use_cache is None and self.cache_capacity == 0 and not risk:
            fn = self._batch_fn(impl or self.impl, dc)
            t0 = time.perf_counter()
            vecs_sel = self._vecs_d[torch.from_numpy(
                sel_b.astype(np.int64)).to(self.device)]
            wmd = fn(vecs_sel, r_d, torch.from_numpy(mask_b).to(self.device),
                     self._vecs_d, self._cols_d, self._vals_d)
            wmd = wmd[:q].cpu().numpy()
            self.last_batch_stats = {
                "solve_s": time.perf_counter() - t0,
                "phases_separable": False, "route": "legacy_fused"}
            self._check_result(wmd, what="query_batch distances")
            return wmd
        fn = self._stripe_fn(impl or self.impl, dc)
        self._kcache.ensure_lamb(self.cfg.lamb)   # lambda-invalidation
        use = use_cache is not False              # False = transient baseline
        t0 = time.perf_counter()
        k_s, km_s, info = self._kcache.stripes_for_batch(sel_b, mask_b,
                                                         use_cache=use)
        self._sync()
        t_pre = time.perf_counter() - t0
        self._check_km(km_s, mask_b)
        t0 = time.perf_counter()
        wmd = fn(k_s, km_s, r_d, self._cols_d, self._vals_d)[:q]
        wmd = wmd.cpu().numpy()
        t_solve = time.perf_counter() - t0
        self.last_batch_stats = {"precompute_s": t_pre, "solve_s": t_solve,
                                 **info}
        self._check_result(wmd, what="query_batch distances")
        return wmd

    def query_batch_sequential(self, rs: Sequence[np.ndarray]) -> np.ndarray:
        """Per-query dispatch loop -- the oracle/baseline for query_batch."""
        return np.stack([self.query(r) for r in rs])

    def _padded_query_batch(self, rs: Sequence[np.ndarray]):
        """Select + bucket-pad queries and append pow2 admission filler
        (all-pad rows: zeroed K stripes, so they solve to 0 and are sliced
        off). Returns (sel_b, r_b, mask_b), each (Q_pow2, v_r)."""
        sels, rsels = zip(*[select_query(r) for r in rs])
        sel_b, r_b, mask_b = pad_query_batch(sels, rsels, self.cfg.v_r)
        q_pad = formats.next_pow2(len(rs)) - len(rs)
        if q_pad:
            sel_b = np.concatenate(
                [sel_b, np.zeros((q_pad, self.cfg.v_r), sel_b.dtype)])
            r_b = np.concatenate(
                [r_b, np.ones((q_pad, self.cfg.v_r), r_b.dtype)])
            mask_b = np.concatenate(
                [mask_b, np.zeros((q_pad, self.cfg.v_r), mask_b.dtype)])
        return sel_b, r_b, mask_b

    @staticmethod
    def _top_k(d: np.ndarray, k: int) -> np.ndarray:
        """Indices of the k smallest distances, ordered by (distance, doc
        id): argpartition + a tie sweep + a local sort of k. Ties at the
        k-th value go to the smallest doc id, so every route selects the
        same set."""
        k = min(k, d.shape[-1])
        if k <= 0:
            return np.zeros((*d.shape[:-1], 0), np.int64)
        flat = d.reshape(-1, d.shape[-1])
        out = np.empty((flat.shape[0], k), np.int64)
        for i, row in enumerate(flat):
            kth = np.partition(row, k - 1)[k - 1]
            below = np.nonzero(row < kth)[0]           # <= k - 1 of these
            ties = np.nonzero(row == kth)[0][:k - below.size]
            idx = np.concatenate([below, ties])
            out[i] = idx[np.lexsort((idx, row[idx]))]
        return out.reshape(*d.shape[:-1], k)

    def top_k(self, r: np.ndarray, k: int = 10, *, prune: bool = False,
              **kw) -> tuple[np.ndarray, np.ndarray]:
        """Nearest-k docs for one query."""
        idx, dist = self.top_k_batch([r], k, prune=prune, **kw)
        return idx[0], dist[0]

    def top_k_batch(self, rs: Sequence[np.ndarray], k: int = 10, *,
                    prune: bool = False, **kw
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched nearest-k: (Q, k) doc ids + distances. `query_batch`
        followed by the tie-deterministic selection; ``**kw`` forwards
        impl / docs_chunk / use_cache."""
        if prune:
            _not_ported("top_k_batch(prune=True) (the pruned cascade)",
                        "item 'The retrieval cascade'")
        d = self.query_batch(rs, **kw)
        idx = self._top_k(d, k)
        return idx, np.take_along_axis(d, idx, axis=-1)
