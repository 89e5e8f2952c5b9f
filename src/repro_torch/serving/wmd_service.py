"""Sinkhorn-WMD query service on one GPU or on a single-controller mesh.

Port of `repro.serving.wmd_service`. The corpus (embeddings + ELL,
rebucketed to the mesh's vocab shards) is loaded onto the devices once;
queries are solved by the fused SDDMM-SpMM engine.

The service always runs on a mesh: ``mesh=`` (a `launch.mesh.Mesh` with
a ``model`` axis and ``data``, and ``pod`` where it has one, as doc
axes), or without one the (1, 1) mesh of ``device``. ``device`` becomes
the mesh's first device; the ELL is rebucketed over
``mesh.shape["model"]`` and placed by `core.distributed.shard_wmd_inputs`,
the K cache holds one vocab stripe a model shard, and every exact entry
point runs the programs of `core.distributed` (the shards in lockstep,
one model-axis sum an iteration). The bound tiers, the tier-0 moments,
the M cache and the original ELL stay on the first device, replicated as
in the reference; the rerank block is rounded up to a multiple of the doc
shards. A (d, 1) mesh gives the one-device service's bits, except with
``tol > 0`` and a ``docs_chunk`` smaller than a doc shard: the chunks of
one group then share a vote (see `core.distributed`), so their n_iter is
the one-device service's and their distances differ within the
convergence tolerance. A (d, S) mesh differs from the one-device service
by the rounding of the split sum.

Service API
-----------
  query(r)                  -- one (V,) histogram -> (N,) distances through
      the per-query program (`core.distributed.build_wmd_fn`, as the
      reference): the query is padded to the v_r bucket, its stripe is
      computed (``kexp_impl``: kernel #5 `cdist_kexp` by default), then
      ``max_iter`` type1 iterations and the type2 distance
      (``impl="kernel"``: kernels #1 and #2; any other impl: the fused
      plain spelling, the reference's per-query program). It uses neither
      the K cache nor the batched engine; on the card its distances are
      bit for bit the batched kernel route's rows (the K rows of #5 are
      #6's, the single-query kernels share #3 / #4's step). ``tol`` does
      not apply: the per-query program runs ``max_iter`` iterations.
  query_batch(rs, impl=..., docs_chunk=..., use_cache=...) -- Q histograms
      -> (Q, N). Queries are padded to the service's v_r bucket (exact
      mask-based padding, `core.distributed.pad_query_batch`) and admitted
      in power-of-two Q buckets (filler queries carry an all-zero row mask
      and are sliced off). Two routes, as in the reference:
        * stripes (``cache_capacity > 0`` or an explicit ``use_cache``):
          `core.kcache.KCache` dedups word ids across the batch, computes
          only missing K / K.*M rows (``kexp_impl``) and slot-gathers each
          model shard's (Q, v_r, Vloc+1) stripes for
          `build_wmd_batch_fn_stripes`;
          ``use_cache=False`` is the transient baseline, bitwise identical
          to the cached path;
        * legacy (cache disabled, no routing request): the precompute runs
          inside the solve (`build_wmd_batch_fn`, `masked_k_batch`).
  query_batch_sequential(rs) -- `query` over the list (oracle / baseline).
  top_k(r, k) / top_k_batch(rs, k) -- nearest-k doc ids + distances, with
      the reference's tie-deterministic selection; `top_k` without
      pruning runs `query`, `top_k_batch` runs `query_batch`.
      With ``prune=True`` the retrieval cascade runs instead: every doc is
      scored by the enabled bound tiers (tier 0, the centroid screen of
      `core.cascade`; tier 1, LC-RWMD over all N through the
      ``lc_impl`` kernel; tier 2, the doc-side RWMD of `core.rwmd` on the
      ``tier2_cap`` most promising docs through the ``bound_impl`` kernel;
      the M rows from the M cache), docs are visited in ascending-bound
      order in fixed ``prune_chunk`` blocks, and the exact rerank (one
      stripes program per block, K rows from the K cache) stops once the
      next block's bounds exceed the running k-th distance. Pruned top-k
      returns the bitwise-identical set as `top_k_scan_batch`.
      ``rerank="per_query"`` solves (1, chunk) programs per query,
      ``"union"`` one (Q, chunk) program per shared candidate block; both
      give the same bits.
  top_k_scan_batch(rs, k) -- the pruned path's oracle: every doc through
      the same bound-ordered (1, chunk) programs, no pruning.
  query_batch_bounds(rs) / top_k_batch_bounds(rs, k) -- the degraded
      tier: (Q, N) doc-side RWMD lower bounds (one min-SDDMM, no Sinkhorn
      iterations), and the nearest-k by bound.
  async_service(**kw)       -- async admission front-end: a
      `serving.coalescer.QueryCoalescer` that turns a concurrent stream of
      single-query ``submit(r) -> Future`` calls into full `query_batch`
      dispatches (fill/window/deadline micro-batching, backpressure,
      ServingStats); `drain_async()` flushes every live front-end.
  warmup(max_batch=..., ks=...) -- one dispatch per shape of the serving
      envelope (`serving.warmup`); returns the `WarmupReport`.
  add_docs / remove_docs / compact -- live-corpus mutation, on a service
      built by `WMDService.from_live` over a `data.live_corpus.LiveCorpus`
      (a service without one raises `ValueError`): WAL-durable upserts and
      tombstones (the return acks fsynced state), a lazy refresh of the
      device state before each live dispatch, and interruptible
      compaction. A live dispatch runs the same programs once per
      non-empty segment (base and delta, one pair of vocab-major copies
      for both) and answers over the live docs in ascending-id order, bit
      for bit a one-shot build of the same docs; top-k returns real doc
      ids (`live_doc_ids`). Live pruned top-k runs the cascade over the
      base segment and solves the delta whole; ``rerank="union"`` falls
      back to the exact full scan, counted by ``wmd_prune_fallback_total``.
      The K cache is never invalidated by corpus mutation (its rows do not
      depend on the docs).

Knobs (constructor fields): ``impl`` ("kernel" default: the CUDA kernels on
the card, their plain versions on the CPU; "fused" / "unfused" are the
paper's baselines, and both give the per-query program its fused
spelling), ``docs_chunk``, ``tol``, ``cache_capacity``,
``cache_rows_bucket`` (also the M rows' bucket), ``kexp_impl`` ("kernel"
default, or "jnp": the plain matmul spelling; the value names are the
reference's; the M rows of the bound tiers follow it, see
`core.kcache.MCache`), ``prune_chunk``, ``prune_margin`` (a doc is pruned
only when ``bound * (1 - margin)`` exceeds the k-th exact distance),
``bound_impl`` and ``lc_impl`` ("kernel" default, or "fused": the plain
spelling; ``lc_impl=None`` disables tier 1), ``bound_docs_chunk``,
``mcache_capacity``, ``tier0``, ``tier2_cap`` (None = 4 x prune_chunk,
0 disables tier 2), ``guards``, ``live``, ``metrics``, ``device`` ("cuda"
by default; a default service on a machine without a card raises) and
``mesh`` (None: the (1, 1) mesh of ``device``; see above).

Observability: ``cache_stats`` / ``mcache_stats`` (cumulative),
``cache_resident`` / ``mcache_resident``, ``last_batch_stats``
(``precompute_s`` / ``solve_s`` phase split and the batch's hit_rate on the
stripes route; ``solve_s`` with ``phases_separable=False`` on the legacy
route; each phase's start on ``time.monotonic`` beside it, as
``precompute_t0`` / ``solve_t0``; on the bulk routes ``fused_launches``,
the batch's type1 / type2 launches that read the Sinkhorn iterate x
directly, ``max_iter + 1`` a program position on the kernel route and 0
on the plain impls; on query_batch's two routes of a static corpus
``peer_bytes``, below) and ``last_prune_stats`` (the
reference's fields: solves, programs, ``bound_s`` / ``rerank_s``, the
per-tier funnel ``tiers``; and ``kcache_misses``, the K-row misses of each
K-cache lookup of the call, in order, from which a run can count the
miss-row launches). Host times are taken after a device synchronize.
``wmd_peer_copy_bytes_total`` (a counter of ``metrics``) adds up, over
those query_batch calls, the bytes each program call copies between
distinct cards of the mesh: the K and K.*M stripes (or, on the legacy
route, the query rows) out to each card that holds doc shards, the row
scales, with a model axis the iterates' model-axis sums, and the
distances gathered back on the first card (counted on the host, with no
sync, where the program copies them: `core.distributed.peer_copies`; 0 on
one card, logical shards of one card included).
``tracer`` (default the no-op ``NULL_TRACER``; bind a
`repro_torch.obs.Tracer` at any time) records each `query_batch` /
`top_k_batch` / `top_k_scan_batch` call as one span tree of its host
steps, on the tracer's clock (docs/observability.md lists the steps);
query_batch's ``solve`` step carries ``cards`` (the mesh's distinct
devices) and the call's ``peer_bytes``.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
import time
import weakref
from typing import Sequence

import numpy as np
import torch

from repro_torch.configs import sinkhorn_wmd as wmd_cfg
from repro_torch.core import cascade as cascade_core
from repro_torch.core import formats
from repro_torch.core import guards as _guards
from repro_torch.core import rwmd as rwmd_core
from repro_torch.core.distributed import (build_wmd_batch_fn,
                                          build_wmd_batch_fn_stripes,
                                          build_wmd_fn, pad_query,
                                          pad_query_batch,
                                          peer_bytes_total, shard_docs,
                                          shard_wmd_inputs,
                                          vocab_major_stripes)
from repro_torch.core.kcache import KCache, MCache
from repro_torch.core.sinkhorn import select_query
from repro_torch.kernels.sddmm_spmm import reads_x_total
from repro_torch.launch.mesh import (check_placement, on_device,
                                     one_device_mesh, shard_grid)
from repro_torch.obs.trace import NULL_TRACER


def _serialized(fn):
    """Serialize an engine entry point on the service's reentrant lock (the
    K cache mutates a host slot map and device buffers), with the service's
    first card current: the kernels it launches outside the mesh programs
    (the K and M caches, the bound tiers) read tensors that lie there."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._engine_lock, on_device(self.device):
            return fn(self, *args, **kwargs)
    return wrapper


def _engine_call(op: str):
    """A batch entry point: serialized, on the first card, like
    `_serialized` and, with a tracer on, recorded as one span tree of the
    call's steps. The outermost such call opens the tree (seq
    ``batch-<n>``, attrs ``op``, ``q``, ``q_pad``, ``route``) and closes it
    once, ``failed`` with the exception's type name if it raises; the calls
    nested in it (one at a time, under the lock) add their steps to the
    same tree."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, rs, *args, **kwargs):
            with self._engine_lock, on_device(self.device):
                if not self.tracer.enabled or self._tree is not None:
                    return fn(self, rs, *args, **kwargs)
                return self._traced_call(op, fn, rs, args, kwargs)
        return wrapper
    return deco


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
    prune_chunk: int = 64
    prune_margin: float = 1e-3
    bound_impl: str = "kernel"
    bound_docs_chunk: int | None = 256
    mcache_capacity: int = 0
    tier0: bool = True
    lc_impl: str | None = "kernel"
    tier2_cap: int | None = None
    guards: bool = True
    live: object | None = None          # data.live_corpus.LiveCorpus
    metrics: object | None = None       # repro_torch.obs.MetricsRegistry
    mesh: object | None = None          # repro_torch.launch.mesh.Mesh

    @classmethod
    def from_state(cls, cfg, state, **kw) -> "WMDService":
        """Build a service on a `repro_torch.convert.WMDState` (embeddings
        already on the device); the service runs where they lie (on a
        ``mesh`` passed in ``kw``: on the mesh)."""
        kw.setdefault("device", state.vecs.device)
        return cls(cfg=cfg, vecs=state.vecs, ell=state.ell, **kw)

    @classmethod
    def from_live(cls, mesh, cfg, vecs, live, **kw) -> "WMDService":
        """Build a service over a mutable `data.live_corpus.LiveCorpus`,
        on ``mesh`` (None: one device, ``device`` in ``kw``), the
        reference's argument order.

        The corpus's base segment becomes the service ELL; the delta
        segment (and the tombstone gather map) is refreshed lazily before
        every live dispatch (`_refresh_live`). ``add_docs`` /
        ``remove_docs`` / ``compact`` then mutate the corpus through the
        service under the engine lock. ``device`` and the other knobs go
        in ``kw``, as for the constructor."""
        return cls(mesh=mesh, cfg=cfg, vecs=vecs, live=live, **kw)

    def __post_init__(self):
        if self.live is not None:
            # the base segment IS the service corpus; ell, if also passed,
            # is ignored in favor of the live corpus's current base
            self.ell = self.live.base_ell
        if self.ell is None:
            raise ValueError("WMDService needs either ell= or live=")
        if self.mesh is None:
            if torch.device(self.device).type == "cuda" and \
                    not torch.cuda.is_available():
                raise RuntimeError("WMDService(device='cuda') needs an "
                                   "NVIDIA GPU; pass device='cpu' for the "
                                   "plain PyTorch versions")
            self.mesh = one_device_mesh(self.device)
        self.device = self.mesh.device()
        self._doc_axes = tuple(a for a in ("pod", "data")
                               if a in self.mesh.axis_names)
        self._grid = shard_grid(self.mesh, self._doc_axes)
        self._doc_shards, self._model_shards = self._grid.shape
        # distinct devices (logical shards of one card are one card)
        self._cards = len(set(self.mesh.devices.flat))
        self._vecs_d = torch.as_tensor(self.vecs, dtype=torch.float32,
                                       device=self.device).contiguous()
        vecs_np = self._vecs_d.cpu().numpy()
        self._install_corpus()
        self._single_fns: dict[tuple, object] = {}
        self._batch_fns: dict[tuple, object] = {}
        self._stripe_fns: dict[tuple, object] = {}
        if self.metrics is None:
            from repro_torch.obs.metrics import MetricsRegistry
            self.metrics = MetricsRegistry()
        self._kcache = KCache(self.cache_capacity, self._vecs_d,
                              self.cfg.lamb, mesh=self.mesh,
                              device=self.device,
                              rows_bucket=self.cache_rows_bucket,
                              kexp_impl=self.kexp_impl,
                              metrics=self.metrics)
        # M rows of the bound tiers: same LRU machinery, keyed by word id
        # alone, spelled like the K rows (see MCache). Its transient path IS
        # assemble_m_stripes, so capacity 0 changes only the amortization.
        self._mcache = MCache(self.mcache_capacity, self._vecs_d,
                              device=self.device,
                              rows_bucket=self.cache_rows_bucket,
                              kexp_impl=self.kexp_impl, metrics=self.metrics)
        # the bytes query_batch's programs copy between distinct cards
        self._peer_bytes = self.metrics.counter(
            "wmd_peer_copy_bytes_total",
            "bytes query_batch copied between distinct cards")
        # any pruned dispatch that silently degrades to an exact full scan
        # must be countable, not just visible in last_prune_stats
        self._prune_fallbacks = self.metrics.counter(
            "wmd_prune_fallback_total",
            "pruned top-k dispatches that fell back to the exact full scan")
        # rerank blocks split over the doc shards: a multiple of them
        self._rerank_chunk = self._chunk_for(self.prune_chunk)
        # numeric-guard state: the underflow gate needs the largest
        # embedding norm
        self._max_vec_norm = float(np.sqrt(
            (vecs_np.astype(np.float64) ** 2).sum(axis=-1).max())) \
            if vecs_np.size else 0.0
        self.last_batch_stats: dict = {}
        self.last_prune_stats: dict = {}
        self._engine_lock = threading.RLock()
        # step spans of the batch entry points (late-bindable, like the
        # coalescer's and the live corpus's tracer); the open tree's seq
        self.tracer = NULL_TRACER
        self._tree: str | None = None
        self._route: str | None = None
        self._trees = 0
        # live async front-ends (async_service); weak so a shut-down
        # coalescer the caller dropped doesn't accumulate on the service
        self._coalescers: weakref.WeakSet = weakref.WeakSet()
        # live-corpus device state (refreshed lazily; see _refresh_live).
        # The base state was just built from live.base_ell, so only the
        # delta and gather state start stale.
        self._live_base_version = (self.live.base_version
                                   if self.live is not None else -1)
        self._live_version = -1
        if self.live is not None and self.live.metrics is None:
            # arm the corpus's compaction lock-hold histogram on this
            # service's registry (late-bindable, like its tracer)
            self.live.metrics = self.metrics

    def _install_corpus(self) -> None:
        """(Re)build every piece of device state derived from ``self.ell``
        (the corpus, or a live corpus's base segment): the rebucketed ELL
        the engine solves, the original ELL of the bound tiers, the rerank
        blocks' ELL with its pad doc, the empty-doc mask of the guards,
        and the tier-0 moments (dropped here, recomputed lazily)."""
        self._rb = formats.rebucket_for_vocab_shards(self.ell,
                                                     self._model_shards)
        self._vecs_sh, self._cols_d, self._vals_d = shard_wmd_inputs(
            self.mesh, self._vecs_d, self._rb.cols, self._rb.vals,
            doc_axes=self._doc_axes)
        # the bound tiers run on the original ELL, as in the reference
        self._ell_cols_d = torch.from_numpy(self.ell.cols).to(self.device)
        self._ell_vals_d = torch.from_numpy(self.ell.vals).to(self.device)
        # rerank blocks index the resident rebucketed ELL, each model
        # shard's on its first doc shard's device; row N is a pad doc
        # (every slot the pad id, val 0: it solves to 0)
        pad = lambda x, v: torch.nn.functional.pad(  # noqa: E731
            x, (0, 0, 0, 1), value=v)
        devs = self._grid[0]
        self._rerank_cols_d = [
            pad(torch.from_numpy(c).to(dev), self._rb.num_vocab)
            for c, dev in zip(self._rb.cols, devs)]
        self._rerank_vals_d = [pad(torch.from_numpy(v).to(dev), 0.0)
                               for v, dev in zip(self._rb.vals, devs)]
        check_placement(self._grid, self._rerank_cols_d, "rerank ELL")
        check_placement(self._grid, self._rerank_vals_d, "rerank ELL")
        # tier-0 moments of the corpus, computed on the first pruned call
        self._cent: tuple | None = None
        # docs with zero mass legitimately solve to distance 0
        self._empty_doc_mask = np.asarray(self.ell.vals.sum(axis=-1) == 0)

    def _place_ell(self, rb: formats.EllDocs):
        """A rebucketed ELL in the programs' layout: the (D, S) blocks of
        `shard_docs`."""
        return tuple(shard_docs(self.mesh, [torch.from_numpy(x) for x in a],
                                doc_axes=self._doc_axes)
                     for a in (rb.cols, rb.vals))

    def _chunk_for(self, prune_chunk: int) -> int:
        """A rerank block of at least ``prune_chunk`` docs that divides
        across the doc shards."""
        return -(-max(prune_chunk, 1) // self._doc_shards) * self._doc_shards

    def _vm(self, k_s, km_s, impl: str):
        """`vocab_major_stripes` of a stripe set, on this service's mesh."""
        return vocab_major_stripes(k_s, km_s, impl, self.mesh,
                                   doc_axes=self._doc_axes)

    def _count_peer_bytes(self, p0: int) -> int:
        """The bytes a program call copied between distinct cards since
        `core.distributed.peer_bytes_total` read ``p0``, added to
        ``wmd_peer_copy_bytes_total``."""
        peer = peer_bytes_total() - p0
        self._peer_bytes.inc(peer)
        return peer

    def _sync(self) -> None:
        for dev in set(self._grid.flat):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # -- step spans -----------------------------------------------------------
    #
    # With ``tracer`` on, a batch entry point records its host path step by
    # step (validate, select_pad, kcache, km_guard, solve, d2h,
    # distance_guard, ...; see docs/observability.md) in one tree on the
    # tracer's clock. A step reads the clock before and after its work, so
    # what lies between steps stays the root's own time. Off, a step costs a
    # None check: no clock read, no attrs.

    def _traced_call(self, op: str, fn, rs, args, kwargs):
        tr = self.tracer
        self._trees += 1
        seq = f"batch-{self._trees}"
        q = len(rs)
        tr.begin_request(seq, op=op, q=q,
                         q_pad=formats.next_pow2(q) if q else 0)
        self._tree, self._route = seq, None
        end = {}
        try:
            return fn(self, rs, *args, **kwargs)
        except BaseException as e:
            end = {"status": "failed", "reason": type(e).__name__}
            raise
        finally:
            self._tree = None
            tr.end_request(seq, route=self._route, **end)

    def _now(self) -> float | None:
        """The tracer's clock while a step tree is open, else None."""
        return self.tracer.now() if self._tree is not None else None

    def _step(self, name: str, t0: float, **attrs) -> float:
        """Close step ``name`` of the open tree, begun at ``t0``, now;
        returns now, where a next step may start."""
        t1 = self.tracer.now()
        self.tracer.add_span(self._tree, name, t0, t1, **attrs)
        return t1

    def _validate_attrs(self, rs) -> dict:
        return {"queries": len(rs),
                "bytes": sum(np.asarray(r).nbytes for r in rs)
                if self.guards else 0}

    # -- async front-end ------------------------------------------------------

    def async_service(self, **kw):
        """Async admission front-end: a `serving.coalescer.QueryCoalescer`
        whose dispatcher feeds this service's `query_batch` (thread-safe
        ``submit(r) -> Future``, micro-batching by fill/window/deadline --
        see the coalescer module docstring for knobs). Usable as a context
        manager (shutdown-with-drain on exit); `drain_async` flushes every
        front-end this service has handed out."""
        from repro_torch.serving.coalescer import QueryCoalescer
        co = QueryCoalescer(self, **kw)
        self._coalescers.add(co)
        return co

    def drain_async(self, timeout: float | None = None) -> None:
        """Drain hook: block until every live `async_service` front-end has
        an empty queue and no in-flight batch (coalescers stay open)."""
        for co in list(self._coalescers):
            co.drain(timeout=timeout)

    def warmup(self, *, max_batch: int = 16, ks: Sequence[int] = (),
               kinds: Sequence[str] | None = None,
               queries: Sequence[np.ndarray] | None = None,
               seed: int = 0):
        """Warm the full serving envelope (`serving.warmup`).

        Enumerates every program shape this service can be dispatched --
        pow2 Q buckets up to ``max_batch`` x request kinds ("plain", plus
        "top_k" per k in ``ks``; pass ``kinds`` to add the offline mode's
        "top_k_union") -- and runs one dispatch per shape, so a following
        serving session never pays a first call (the kernels' build or
        load, the caches' first rows). Combine with
        `serving.warmup.enable_compilation_cache` to keep the built
        kernels across processes. Returns the `WarmupReport` (per-shape
        seconds; hand it to `QueryCoalescer.record_warmup` to surface in
        `ServingStats`)."""
        from repro_torch.serving import warmup as _warmup
        registry = _warmup.ShapeRegistry.from_service(
            self, max_batch=max_batch, ks=ks, kinds=kinds)
        return _warmup.warm(self, registry, queries=queries, seed=seed)

    # -- live corpus (mutable base + delta segments) -------------------------
    #
    # With ``live`` set, every dispatch runs per SEGMENT: the same stripes
    # program solves the base and delta ELLs (the corpus cols / vals are
    # arguments, so one program serves both shapes), and the results are
    # gathered into ascending-doc-id order through the corpus's (segment,
    # row) location map. Tombstoned and pad rows are solved but never
    # gathered -- the kernels skip val = 0 slots, so they cannot touch a
    # live doc's bits -- and per-doc distances are bitwise those of a
    # one-shot build of the same docs (the incremental == batch contract).
    #
    # K-cache scoping: a cached K row is a function of (word_id, lambda,
    # vecs) only, so corpus mutation invalidates nothing (resident rows
    # survive add / remove / compact and still hit);
    # `invalidate_embedding_rows` is the scoped hook for vector updates.
    # The bound tiers need no invalidation either: bounds are recomputed
    # per call against the current segment ELLs.

    def _require_live(self):
        if self.live is None:
            raise ValueError("this WMDService has no live corpus "
                             "(construct with WMDService.from_live)")

    def _refresh_live(self) -> None:
        """Sync device state with the corpus (cheap when nothing changed).

        A base_version bump (a compaction swapped segments) rebuilds every
        piece of device state derived from the base (`_install_corpus`);
        a version bump (any mutation) uploads the delta segment once and
        rebuilds the gather map. Versions are read under the engine lock,
        which every mutating service entry point also holds, and under the
        corpus lock (reentrant), because `LiveCorpus.compact` builds
        outside its lock and swaps under it: without it, the version
        reads, the base_ell read and the locations() read here could
        straddle a concurrent swap and mix segments."""
        lc = self.live
        with lc._lock:
            self._refresh_live_locked(lc)

    def _refresh_live_locked(self, lc) -> None:
        if lc.base_version != self._live_base_version:
            self.ell = lc.base_ell
            self._install_corpus()
            self._live_base_version = lc.base_version
            self._live_version = -1          # gather map must follow
        if lc.version != self._live_version:
            d_ell = lc.delta_ell
            drb = formats.rebucket_for_vocab_shards(d_ell,
                                                    self._model_shards)
            self._dcols_d, self._dvals_d = self._place_ell(drb)
            self._dell_cols_d = torch.from_numpy(d_ell.cols).to(self.device)
            self._dell_vals_d = torch.from_numpy(d_ell.vals).to(self.device)
            ids, seg, row = lc.locations()
            self._live_ids = ids
            self._live_seg = seg
            self._live_row = row
            self._live_empty = lc.live_empty_mask()
            self._live_version = lc.version

    @_serialized
    def _query_batch_live(self, rs: Sequence[np.ndarray],
                          impl: str | None = None,
                          use_cache: bool | None = None) -> np.ndarray:
        """(Q, num_live) exact distances over the live corpus, columns in
        ascending doc-id order. One K-cache stripes assembly and one pair
        of vocab-major copies feed one stripes program per non-empty
        segment; a segment holding no live doc is skipped. docs_chunk is
        None: segments are capacity-bounded, and per-doc bits do not
        depend on chunking."""
        self._refresh_live()
        n_live = self._live_ids.size
        q = len(rs)
        if q == 0 or n_live == 0:
            self.last_batch_stats = {}
            return np.zeros((q, n_live), np.float32)
        t = self._now()
        self._validate_queries(rs)
        if t is not None:
            self._route = "live"
            t = self._step("validate", t, **self._validate_attrs(rs))
        sel_b, r_b, mask_b = self._padded_query_batch(rs)
        r_d = torch.from_numpy(r_b).to(self.device)
        if t is not None:
            t = self._step("select_pad", t, pad_rows=sel_b.shape[0] - q)
        self._kcache.ensure_lamb(self.cfg.lamb)
        use = use_cache is not False
        pre_t0 = time.monotonic()
        k_s, km_s, info = self._kcache.stripes_for_batch(sel_b, mask_b,
                                                         use_cache=use)
        self._sync()
        pre_t1 = time.monotonic()
        if t is not None:
            t = self._step("kcache", t, hits=info["hits"],
                           misses=info["misses"], unique=info["unique"])
        self._check_km(km_s, mask_b)
        if t is not None:
            self._step("km_guard", t)
        impl = impl or self.impl
        fn = self._stripe_fn(impl, None)
        out = np.empty((q, n_live), np.float32)
        segments = 0
        solve_t0 = time.monotonic()
        t = self._now()
        vm = self._vm(k_s, km_s, impl)   # one set, both segments
        fused = 0
        for seg_id, (cols_d, vals_d) in enumerate(
                ((self._cols_d, self._vals_d),
                 (self._dcols_d, self._dvals_d))):
            pick = self._live_seg == seg_id
            if not pick.any():
                continue
            n0 = reads_x_total()
            d_seg = fn(k_s, km_s, r_d, cols_d, vals_d, vm=vm)[:q]
            seg_fused = reads_x_total() - n0
            fused += seg_fused
            if t is not None:
                self._sync()
                t = self._step("solve", t, iters=self.cfg.max_iter,
                               segment=seg_id, fused=seg_fused)
            out[:, pick] = d_seg.cpu().numpy()[:, self._live_row[pick]]
            if t is not None:
                t = self._step("d2h", t, bytes=d_seg.nelement()
                               * d_seg.element_size())
            segments += 1
        solve_t1 = time.monotonic()
        self.last_batch_stats = {
            "precompute_t0": pre_t0, "precompute_s": pre_t1 - pre_t0,
            "solve_t0": solve_t0, "solve_s": solve_t1 - solve_t0,
            "segments": segments, "fused_launches": fused, **info}
        t = self._now()
        self._check_result(out, what="live query_batch distances",
                           empty_doc_mask=self._live_empty)
        if t is not None:
            self._step("distance_guard", t)
        return out

    def _bounds_live(self, rs: Sequence[np.ndarray]) -> np.ndarray:
        """(Q, num_live) RWMD lower bounds over the live corpus: one M-row
        assembly, one min-SDDMM per non-empty segment, the same
        ascending-id gather as the exact path."""
        self._refresh_live()
        n_live = self._live_ids.size
        q = len(rs)
        if q == 0 or n_live == 0:
            return np.zeros((q, n_live), np.float32)
        self._validate_queries(rs)
        sel_b, _, mask_b = self._padded_query_batch(rs)
        m_pad, _ = self._mcache.m_stripes_for_batch(sel_b, mask_b)
        out = np.empty((q, n_live), np.float32)
        for seg_id, (cols_d, vals_d) in enumerate(
                ((self._ell_cols_d, self._ell_vals_d),
                 (self._dell_cols_d, self._dell_vals_d))):
            pick = self._live_seg == seg_id
            if not pick.any():
                continue
            lb = rwmd_core.rwmd_bound_batch(
                m_pad, cols_d, vals_d, impl=self.bound_impl,
                docs_chunk=None)[:q].cpu().numpy()
            out[:, pick] = lb[:, self._live_row[pick]]
        return out

    @property
    def live_doc_ids(self) -> np.ndarray:
        """Ascending doc ids of the live corpus -- result column j of a
        live dispatch scores the doc ``live_doc_ids[j]`` (and live top-k
        returns these ids, not positions)."""
        self._require_live()
        with self._engine_lock:
            self._refresh_live()
            return self._live_ids

    @_serialized
    def add_docs(self, ids, docs) -> int:
        """Durable live upsert (see `data.live_corpus.LiveCorpus.add_docs`;
        the return acknowledges WAL-fsynced docs). Device state refreshes
        lazily at the next dispatch; the K cache is deliberately NOT
        invalidated -- see the section comment above."""
        self._require_live()
        return self.live.add_docs(ids, docs)

    @_serialized
    def remove_docs(self, ids) -> int:
        """Durable live remove; returns how many ids were actually live."""
        self._require_live()
        return self.live.remove_docs(ids)

    @_serialized
    def compact(self) -> None:
        """Run one interruptible corpus compaction (base <- base + delta,
        atomic swap); the next dispatch picks up the new base segment."""
        self._require_live()
        self.live.compact()

    @_serialized
    def invalidate_embedding_rows(self, word_ids) -> int:
        """Scoped cache invalidation for embedding updates: drops exactly
        the rows of ``word_ids`` from both row stores (K/K.*M and M);
        returns the total rows dropped."""
        return (self._kcache.invalidate_ids(word_ids)
                + self._mcache.invalidate_ids(word_ids))

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
        # the max over the shards' stripes (exact in any order)
        rowmax = functools.reduce(torch.maximum, [
            torch.amax(torch.abs(k), dim=-1).to(self.device) for k in km_s])
        rowmax = rowmax.cpu().numpy()
        _guards.check_km_rows(rowmax, mask_b, lamb=self.cfg.lamb)

    def _check_result(self, d, *, what: str,
                      empty_doc_mask: np.ndarray | None = None) -> None:
        if not self.guards:
            return
        if empty_doc_mask is None:
            empty_doc_mask = self._empty_doc_mask
        _guards.check_distances(d, lamb=self.cfg.lamb,
                                risk=self._underflow_risk(),
                                empty_doc_mask=empty_doc_mask, what=what)

    @property
    def cache_stats(self):
        """Cumulative cross-query cache counters (`core.kcache.KCacheStats`)."""
        return self._kcache.stats

    @property
    def cache_resident(self) -> int:
        """Word-id rows currently resident in the cross-query cache."""
        return self._kcache.resident

    @property
    def mcache_stats(self):
        """Cumulative M-row cache counters of the bound tiers."""
        return self._mcache.stats

    @property
    def mcache_resident(self) -> int:
        """M rows currently resident in the bound tiers' cache."""
        return self._mcache.resident

    # -- solver programs ------------------------------------------------------

    def _single_fn(self):
        """The per-query program, keyed by (impl, kexp_impl, lamb) so that a
        mutated knob never serves a stale program."""
        key = (self.impl, self.kexp_impl, self.cfg.lamb)
        fn = self._single_fns.get(key)
        if fn is None:
            fn = build_wmd_fn(self.mesh, lamb=self.cfg.lamb,
                              max_iter=self.cfg.max_iter,
                              doc_axes=self._doc_axes,
                              use_kernel=self.impl == "kernel",
                              kexp_impl=self.kexp_impl)
            self._single_fns[key] = fn
        return fn

    def _batch_fn(self, impl: str, docs_chunk: int | None):
        """Single-program batched solver (precompute inside), keyed like the
        reference's so a mutated tol / cfg.lamb never serves a stale fn."""
        key = (impl, docs_chunk, self.tol, self.cfg.lamb)
        fn = self._batch_fns.get(key)
        if fn is None:
            fn = build_wmd_batch_fn(self.mesh, lamb=self.cfg.lamb,
                                    max_iter=self.cfg.max_iter,
                                    doc_axes=self._doc_axes, impl=impl,
                                    docs_chunk=docs_chunk, tol=self.tol)
            self._batch_fns[key] = fn
        return fn

    def _stripe_fn(self, impl: str, docs_chunk: int | None):
        """Batched solver on cache-assembled stripes."""
        key = (impl, docs_chunk, self.tol)
        fn = self._stripe_fns.get(key)
        if fn is None:
            fn = build_wmd_batch_fn_stripes(self.mesh,
                                            max_iter=self.cfg.max_iter,
                                            doc_axes=self._doc_axes,
                                            impl=impl, docs_chunk=docs_chunk,
                                            tol=self.tol)
            self._stripe_fns[key] = fn
        return fn

    # -- queries --------------------------------------------------------------

    @_serialized
    def query(self, r: np.ndarray) -> np.ndarray:
        """r: (V,) sparse query histogram -> (N,) distances, through the
        per-query program (see the module docstring); on a live service
        (num_live,) distances in ascending doc-id order, through the
        per-segment dispatch, as in the reference."""
        if self.live is not None:
            return self._query_batch_live([r])[0]
        self._validate_queries([r])
        sel_idx, r_sel = select_query(r)
        sel_p, r_p, mask = pad_query(sel_idx, r_sel, self.cfg.v_r)
        vecs_sel = self._vecs_d[torch.from_numpy(
            sel_p.astype(np.int64)).to(self.device)]
        wmd = self._single_fn()(vecs_sel,
                                torch.from_numpy(r_p).to(self.device),
                                torch.from_numpy(mask).to(self.device),
                                self._vecs_sh, self._cols_d, self._vals_d)
        wmd = wmd.cpu().numpy()
        self._check_result(wmd, what="query distances")
        return wmd

    @_engine_call("query_batch")
    def query_batch(self, rs: Sequence[np.ndarray],
                    impl: str | None = None,
                    docs_chunk=_UNSET,
                    use_cache: bool | None = None) -> np.ndarray:
        """Multiple queries -> (Q, N) via the batched (Q, v_r, N) engine.

        ``impl`` / ``docs_chunk`` override the service defaults for this
        call (docs_chunk=0 for explicitly unchunked); ``use_cache`` routes
        explicitly (False = transient stripes baseline, bitwise identical
        to the cached path; True = stripes engine even with the cache
        disabled). See the module docstring for the routes.

        Live services route every call through the per-segment dispatch
        (`_query_batch_live`; docs_chunk is unchunked there) -- (Q,
        num_live) columns in ascending doc-id order, bitwise a one-shot
        build of the same docs."""
        if self.live is not None:
            return self._query_batch_live(rs, impl=impl,
                                          use_cache=use_cache)
        if len(rs) == 0:
            return np.zeros((0, self.ell.num_docs), np.float32)
        q = len(rs)
        t = self._now()
        self._validate_queries(rs)
        if t is not None:
            t = self._step("validate", t, **self._validate_attrs(rs))
        # an armed underflow gate routes through the stripes engine so the
        # K*M pre-check sees the assembled rows (off at shipped lambdas)
        risk = self._underflow_risk()
        sel_b, r_b, mask_b = self._padded_query_batch(rs)
        dc = self.docs_chunk if docs_chunk is _UNSET else (docs_chunk or None)
        r_d = torch.from_numpy(r_b).to(self.device)
        if t is not None:
            self._step("select_pad", t, pad_rows=sel_b.shape[0] - q)
        if use_cache is None and self.cache_capacity == 0 and not risk:
            fn = self._batch_fn(impl or self.impl, dc)
            solve_t0 = time.monotonic()
            t = self._now()
            vecs_sel = self._vecs_d[torch.from_numpy(
                sel_b.astype(np.int64)).to(self.device)]
            mask_d = torch.from_numpy(mask_b).to(self.device)
            n0, p0 = reads_x_total(), peer_bytes_total()
            wmd = fn(vecs_sel, r_d, mask_d, self._vecs_sh, self._cols_d,
                     self._vals_d)[:q]
            fused = reads_x_total() - n0
            peer = self._count_peer_bytes(p0)
            if t is not None:
                self._route = "legacy_fused"
                self._sync()
                t = self._step("solve", t, iters=self.cfg.max_iter,
                               fused=fused, cards=self._cards,
                               peer_bytes=peer)
            wmd = wmd.cpu().numpy()
            solve_t1 = time.monotonic()
            if t is not None:
                self._step("d2h", t, bytes=wmd.nbytes)
            self.last_batch_stats = {
                "solve_t0": solve_t0, "solve_s": solve_t1 - solve_t0,
                "phases_separable": False, "route": "legacy_fused",
                "fused_launches": fused, "peer_bytes": peer}
            t = self._now()
            self._check_result(wmd, what="query_batch distances")
            if t is not None:
                self._step("distance_guard", t)
            return wmd
        fn = self._stripe_fn(impl or self.impl, dc)
        t = self._now()
        self._kcache.ensure_lamb(self.cfg.lamb)   # lambda-invalidation
        use = use_cache is not False              # False = transient baseline
        pre_t0 = time.monotonic()
        k_s, km_s, info = self._kcache.stripes_for_batch(sel_b, mask_b,
                                                         use_cache=use)
        self._sync()
        pre_t1 = time.monotonic()
        if t is not None:
            self._route = "stripes" if use else "transient"
            t = self._step("kcache", t, hits=info["hits"],
                           misses=info["misses"], unique=info["unique"])
        self._check_km(km_s, mask_b)
        if t is not None:
            self._step("km_guard", t)
        solve_t0 = time.monotonic()
        t = self._now()
        n0, p0 = reads_x_total(), peer_bytes_total()
        wmd = fn(k_s, km_s, r_d, self._cols_d, self._vals_d)[:q]
        fused = reads_x_total() - n0
        peer = self._count_peer_bytes(p0)
        if t is not None:
            # the copy below waits for the device anyway: a sync while
            # tracing splits the program from the copy and moves no bit
            self._sync()
            t = self._step("solve", t, iters=self.cfg.max_iter, fused=fused,
                           cards=self._cards, peer_bytes=peer)
        wmd = wmd.cpu().numpy()
        solve_t1 = time.monotonic()
        if t is not None:
            self._step("d2h", t, bytes=wmd.nbytes)
        self.last_batch_stats = {
            "precompute_t0": pre_t0, "precompute_s": pre_t1 - pre_t0,
            "solve_t0": solve_t0, "solve_s": solve_t1 - solve_t0,
            "fused_launches": fused, "peer_bytes": peer, **info}
        t = self._now()
        self._check_result(wmd, what="query_batch distances")
        if t is not None:
            self._step("distance_guard", t)
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
        """Nearest-k docs for one query through `query` (``prune=True``:
        the cascade, see `top_k_batch`, which takes ``**kw``)."""
        if prune:
            idx, dist = self.top_k_batch([r], k, prune=True, **kw)
            return idx[0], dist[0]
        if kw:
            raise TypeError(f"top_k without prune takes no {sorted(kw)}")
        d = self.query(r)
        idx = self._top_k(d, k)
        dist = d[idx]
        if self.live is not None and idx.size:
            idx = self._live_ids[idx]      # positions -> real doc ids
        return idx, dist

    @_engine_call("top_k_batch")
    def top_k_batch(self, rs: Sequence[np.ndarray], k: int = 10, *,
                    prune: bool = False, rerank: str = "per_query",
                    **kw) -> tuple[np.ndarray, np.ndarray]:
        """Batched nearest-k: (Q, k) doc ids + distances.

        Default: `query_batch` followed by the tie-deterministic selection;
        ``**kw`` forwards impl / docs_chunk / use_cache. With ``prune=True``
        the retrieval cascade runs instead (see the module docstring), with
        ``rerank`` "per_query" or "union", and returns the bitwise-identical
        set as `top_k_scan_batch` while skipping the pruned docs' solves
        (stats in ``last_prune_stats``); ``**kw`` then forwards impl /
        use_cache / prune_chunk / prune_margin.

        Live services return REAL doc ids (ascending-id positions mapped
        through `live_doc_ids`), and ``prune=True`` runs the cascade over
        the base segment while exact-solving the delta outright
        (`_top_k_live_pruned`) -- the full scan's bits. ``rerank="union"``
        degrades to the exact full scan (`_top_k_live_fallback`, counted by
        the ``wmd_prune_fallback_total`` metric): the same answer, without
        the speedup."""
        if rerank not in ("per_query", "union"):
            raise ValueError(f"rerank must be per_query|union, "
                             f"got {rerank!r}")
        if rerank == "union" and not prune:
            raise ValueError("rerank='union' is a pruned-rerank strategy; "
                             "pass prune=True")
        if prune:
            if self.live is not None:
                if rerank == "union":
                    return self._top_k_live_fallback(rs, k, **kw)
                return self._top_k_live_pruned(rs, k, exhaustive=False,
                                               **kw)
            if rerank == "union":
                return self._top_k_union(rs, k, **kw)
            return self._top_k_pruned(rs, k, exhaustive=False, **kw)
        d = self.query_batch(rs, **kw)
        t = self._now()
        idx = self._top_k(d, k)
        dist = np.take_along_axis(d, idx, axis=-1)
        if self.live is not None and idx.size:
            idx = self._live_ids[idx]      # positions -> real doc ids
        if t is not None:
            self._step("host_topk", t, k=k)
        return idx, dist

    @_engine_call("top_k_scan_batch")
    def top_k_scan_batch(self, rs: Sequence[np.ndarray], k: int = 10,
                         **kw) -> tuple[np.ndarray, np.ndarray]:
        """The pruned path's exactness oracle: solve EVERY doc through the
        same bound-ordered, fixed-shape (1, chunk) programs, then select.
        Bitwise identical to ``top_k_batch(prune=True)``: identical programs
        on identical inputs for the shared prefix, sound bounds for the
        pruned suffix."""
        if self.live is not None:
            return self._top_k_live_pruned(rs, k, exhaustive=True, **kw)
        return self._top_k_pruned(rs, k, exhaustive=True, **kw)

    # -- the retrieval cascade ------------------------------------------------

    def _bounds_for_batch(self, sel_b: np.ndarray, mask_b: np.ndarray, *,
                          use_cache: bool = True) -> np.ndarray:
        """(Q_pow2, v_r) padded queries -> (Q_pow2, N) doc-side RWMD bounds
        over the whole corpus: M stripes from the M cache, one min-SDDMM.
        The bounds tier's bound; the pruned paths use `_cascade_bounds`."""
        m_pad, _ = self._mcache.m_stripes_for_batch(sel_b, mask_b,
                                                    use_cache=use_cache)
        lb = rwmd_core.rwmd_bound_batch(
            m_pad, self._ell_cols_d, self._ell_vals_d,
            impl=self.bound_impl, docs_chunk=self.bound_docs_chunk)
        return lb.cpu().numpy()

    def _base_centroids(self):
        """Cached tier-0 moments of the corpus (computed once)."""
        if self._cent is None:
            self._cent = cascade_core.doc_centroids(
                self._ell_cols_d, self._ell_vals_d, self._vecs_d)
        return self._cent

    def _cascade_bounds(self, sel_b: np.ndarray, r_b: np.ndarray,
                        mask_b: np.ndarray, *, use_cache: bool = True
                        ) -> tuple[np.ndarray, list]:
        """Run the enabled bound tiers over the corpus and compose them.

        Returns ``(combined, tiers)``: combined (Q_pow2, N) is the
        elementwise max of every enabled tier's bounds (a max of lower
        bounds is a lower bound; with every tier off it is all zeros, and
        the pruned path degenerates to the exhaustive scan, same bits).
        ``tiers`` holds per-tier (name, bounds, seconds) for `_tier_stats`.
        Tier 0 is one (Q, dim) x (dim, N) matmul over the cached moments;
        tier 1 reduces the M stripes to min-cost vectors once per query and
        scores every doc with one sparse dot; tier 2 re-derives the
        doc-side RWMD on the ``tier2_cap`` most promising docs (by the
        min-over-queries combined bound, one subset for all queries) --
        equal to tier 1 where both run, so it covers LC-disabled configs."""
        tiers: list[dict] = []
        n = int(self._ell_cols_d.shape[0])
        qp = sel_b.shape[0]
        combined = np.zeros((qp, n), np.float32)
        if self.tier0:
            t0 = time.monotonic()
            g, m = self._base_centroids()
            b = cascade_core.centroid_bound_batch(
                *(torch.from_numpy(x).to(self.device)
                  for x in (sel_b, r_b, mask_b)),
                self._vecs_d, g, m).cpu().numpy()
            tiers.append({"tier": "centroid", "bounds": b,
                          "seconds": time.monotonic() - t0})
            combined = np.maximum(combined, b)
        if self.lc_impl is not None or self.tier2_cap != 0:
            m_pad, _ = self._mcache.m_stripes_for_batch(
                sel_b, mask_b, use_cache=use_cache)
        if self.lc_impl is not None:
            t0 = time.monotonic()
            minm = cascade_core.min_cost_vectors(m_pad)
            b = cascade_core.lc_rwmd_bound_batch(
                minm, self._ell_cols_d, self._ell_vals_d,
                impl=self.lc_impl,
                docs_chunk=self.bound_docs_chunk).cpu().numpy()
            tiers.append({"tier": "lc_rwmd", "bounds": b,
                          "seconds": time.monotonic() - t0})
            combined = np.maximum(combined, b)
        t2 = (4 * self._rerank_chunk if self.tier2_cap is None
              else self.tier2_cap)
        t2 = min(t2, n)
        if t2 > 0:
            t0 = time.monotonic()
            key = combined.min(axis=0)
            subset = np.sort(np.argsort(key, kind="stable")[:t2])
            sub_t = torch.from_numpy(subset).to(self.device)
            lb2 = rwmd_core.rwmd_bound_batch(
                m_pad, self._ell_cols_d[sub_t], self._ell_vals_d[sub_t],
                impl=self.bound_impl, docs_chunk=None).cpu().numpy()
            b = np.zeros_like(combined)
            b[:, subset] = lb2
            tiers.append({"tier": "rwmd", "bounds": b,
                          "seconds": time.monotonic() - t0})
            combined = np.maximum(combined, b)
        return combined, tiers

    @staticmethod
    def _tier_stats(tiers: list, thresholds: np.ndarray, q: int, n: int,
                    margin: float) -> list[dict]:
        """Post-hoc per-tier survivor counts against the FINAL per-query
        thresholds: how many (query, doc) cells each tier's bound alone
        fails to prune (the rerank loop's ``bound * (1 - margin) <=
        threshold`` test), plus the cumulative survivors of the tiers
        composed so far -- the cascade's funnel."""
        out = []
        cum = None
        for t in tiers:
            b = t["bounds"][:q]
            cum = b if cum is None else np.maximum(cum, b)
            alive = b * (1.0 - margin) <= thresholds[:, None]
            alive_cum = cum * (1.0 - margin) <= thresholds[:, None]
            cells = max(q * n, 1)
            out.append({
                "tier": t["tier"], "seconds": t["seconds"],
                "survivors": int(alive.sum()),
                "solves_avoided": 1.0 - int(alive.sum()) / cells,
                "cascade_survivors": int(alive_cum.sum()),
                "cascade_solves_avoided":
                    1.0 - int(alive_cum.sum()) / cells,
            })
        return out

    def _solve_docs(self, fn, k_s, km_s, vm, r_q: torch.Tensor,
                    doc_ids: np.ndarray, chunk: int) -> np.ndarray:
        """Exact distances of the stripes batch against a doc subset via ONE
        fixed-shape (Q, chunk) stripes program (Q = 1 per query, the pow2
        batch on the union path). The block's ELL rows are gathered on the
        device from the resident ELL; a short block is filled with the pad
        doc (row N: every slot the pad id, val 0, solved to 0) and sliced
        off. Per-doc bits do not depend on chunk-mates, position or
        Q-mates (each (q, doc) cell reduces over its own nnz / v_r axes, in
        the kernels as in the plain engine), which makes pruned == scan ==
        union a bitwise statement. ``vm``: the stripes'
        `vocab_major_stripes` (K's and K.*M's), made once for all the
        programs of a stripe set."""
        m = doc_ids.size
        idx = np.full(chunk, self._rerank_cols_d[0].shape[0] - 1, np.int64)
        idx[:m] = doc_ids
        idx_t = torch.from_numpy(idx)
        # each model shard's block rows, split over the doc shards
        kw = dict(doc_axes=self._doc_axes)
        cols_b = shard_docs(self.mesh, [c[idx_t.to(c.device)] for c in
                                        self._rerank_cols_d], **kw)
        vals_b = shard_docs(self.mesh, [v[idx_t.to(v.device)] for v in
                                        self._rerank_vals_d], **kw)
        d = fn(k_s, km_s, r_q, cols_b, vals_b, vm=vm)
        return d.cpu().numpy()[:, :m]

    def _prune_setup(self, rs, prune_chunk, prune_margin):
        """Shared prologue of the pruned paths: (chunk, margin, q, sel_b,
        r_b, mask_b)."""
        t = self._now()
        self._validate_queries(rs)
        if t is not None:
            t = self._step("validate", t, **self._validate_attrs(rs))
        chunk = (self._rerank_chunk if prune_chunk is None
                 else self._chunk_for(prune_chunk))
        margin = self.prune_margin if prune_margin is None else prune_margin
        sel_b, r_b, mask_b = self._padded_query_batch(rs)
        if t is not None:
            self._step("select_pad", t, pad_rows=sel_b.shape[0] - len(rs))
        return chunk, margin, len(rs), sel_b, r_b, mask_b

    def _traced_bounds(self, sel_b, r_b, mask_b, use: bool):
        """`_cascade_bounds` as the ``bounds`` step (attrs: each tier's
        seconds); returns (combined, tiers, t0, t1), the step's times on
        the phase clock."""
        t = self._now()
        t0 = time.monotonic()
        combined, tiers = self._cascade_bounds(sel_b, r_b, mask_b,
                                               use_cache=use)
        t1 = time.monotonic()
        if t is not None:
            self._step("bounds", t, **{f"{x['tier']}_s": x["seconds"]
                                       for x in tiers})
        return combined, tiers, t0, t1

    def _traced_record_prune(self, *args) -> None:
        """`_record_prune` as the ``funnel`` step (attrs: the cascade's
        survivors after each tier, known only once the rerank has set the
        final thresholds)."""
        t = self._now()
        self._record_prune(*args)
        if t is not None:
            self._step("funnel", t, **{
                f"{x['tier']}_survivors": x["cascade_survivors"]
                for x in self.last_prune_stats["tiers"]})

    @_serialized
    def _top_k_pruned(self, rs: Sequence[np.ndarray], k: int, *,
                      exhaustive: bool, impl: str | None = None,
                      use_cache: bool | None = None,
                      prune_chunk: int | None = None,
                      prune_margin: float | None = None
                      ) -> tuple[np.ndarray, np.ndarray]:
        """Shared core of the pruned top-k and its exhaustive-scan oracle:
        the cascade's bounds over the corpus, then the per-query rerank
        (`_rerank_per_query`) over every doc."""
        n = self.ell.num_docs
        k_eff = min(k, n)
        if len(rs) == 0:
            return (np.zeros((0, k_eff), np.int64),
                    np.zeros((0, k_eff), np.float32))
        if self._tree is not None:
            self._route = "scan" if exhaustive else "pruned"
        chunk, margin, q, sel_b, r_b, mask_b = self._prune_setup(
            rs, prune_chunk, prune_margin)
        use = use_cache is not False
        combined, tiers, b_t0, b_t1 = self._traced_bounds(sel_b, r_b,
                                                          mask_b, use)
        bounds = combined[:q]
        r_t0 = time.monotonic()
        docs = np.arange(n)
        idx_out, d_out, solves, programs, hits, k_misses = \
            self._rerank_per_query(sel_b, r_b, mask_b, bounds, docs, docs,
                                   np.empty(0, np.int64), n, k_eff=k_eff,
                                   chunk=chunk, margin=margin,
                                   exhaustive=exhaustive,
                                   impl=impl or self.impl, use=use)
        r_t1 = time.monotonic()
        self._traced_record_prune(q, n, k_eff, chunk, margin, exhaustive,
                                  "per_query", solves, programs,
                                  b_t1 - b_t0, r_t1 - r_t0, tiers, d_out,
                                  k_misses)
        total = hits + sum(k_misses)
        self.last_batch_stats = {
            "hit_rate": hits / total if total else 0.0,
            "precompute_t0": b_t0, "precompute_s": b_t1 - b_t0,
            "solve_t0": r_t0, "solve_s": r_t1 - r_t0,
        }
        t = self._now()
        self._check_result(d_out, what="top_k distances",
                           empty_doc_mask=self._empty_doc_mask[idx_out])
        if t is not None:
            self._step("distance_guard", t)
        return idx_out, d_out

    def _rerank_per_query(self, sel_b, r_b, mask_b, bounds, bpos, brow,
                          delta, n_pos, *, k_eff, chunk, margin, exhaustive,
                          impl, use):
        """The per-query rerank loop of the pruned paths, over ``n_pos``
        answer positions: the docs at positions ``bpos`` are the resident
        ELL's rows ``brow``, visited in ascending ``bounds`` (columns:
        resident rows) order in fixed ``chunk`` blocks, one (1, chunk)
        stripes program a block (K rows from the K cache); once k docs are
        solved, every doc whose ``bound * (1 - margin)`` exceeds the
        running k-th exact distance is dropped -- ascending order makes
        the survivors a prefix, so the first empty block ends the query.
        ``exhaustive`` disables the drop (same programs, same order).
        ``delta``: the live delta's positions (empty on a static corpus),
        solved whole first by one unchunked program that seeds the
        threshold; the delta
        program and the blocks of a query share its pair of vocab-major
        copies. A pruned doc's exact distance is >= bound > threshold
        *strictly*, so it cannot displace or tie any selected doc.
        Returns (idx (Q, k), distances (Q, k), solves, programs, K-cache
        hits, K-cache misses a query)."""
        self._kcache.ensure_lamb(self.cfg.lamb)   # lambda-invalidation
        fn = self._stripe_fn(impl, None)          # chunk IS the block
        q = bounds.shape[0]
        idx_out = np.empty((q, k_eff), np.int64)
        d_out = np.empty((q, k_eff), np.float32)
        solves = programs = hits = 0
        k_misses = []
        r_d = torch.from_numpy(r_b).to(self.device)
        for i in range(q):
            t = self._now()
            k_s, km_s, info = self._kcache.stripes_for_batch(
                sel_b[i:i + 1], mask_b[i:i + 1], use_cache=use)
            if t is not None:
                t = self._step("kcache", t, hits=info["hits"],
                               misses=info["misses"], unique=info["unique"])
            self._check_km(km_s, mask_b[i:i + 1])
            if t is not None:
                t = self._step("km_guard", t)
            hits += info["hits"]
            k_misses.append(info["misses"])
            lb = bounds[i][brow]            # bounds per position in bpos
            order = np.argsort(lb, kind="stable")      # ascending bounds
            if t is not None:
                t = self._step("order", t)
                topk_s, programs0, solves0 = 0.0, programs, solves
            vm = self._vm(k_s, km_s, impl)     # once a query stripe
            r_q = r_d[i:i + 1]
            solved_d = np.full(n_pos, np.inf, np.float32)
            n_solved = 0
            threshold = np.inf
            if delta.size:
                d_seg = fn(k_s, km_s, r_q, self._dcols_d, self._dvals_d,
                           vm=vm)[0].cpu().numpy()
                solved_d[delta] = d_seg[self._live_row[delta]]
                programs += 1
                n_solved = delta.size
                if n_solved >= k_eff:
                    cur = self._top_k(solved_d, k_eff)
                    threshold = float(solved_d[cur[-1]])
            pos = 0
            while pos < bpos.size:
                block = order[pos:pos + chunk]
                if not exhaustive and n_solved >= k_eff:
                    # bounds ascend within the block, so the survivors are
                    # its prefix; an empty prefix proves every remaining
                    # doc is outside the top-k
                    block = block[lb[block] * (1.0 - margin) <= threshold]
                    if block.size == 0:
                        break
                solved_d[bpos[block]] = self._solve_docs(
                    fn, k_s, km_s, vm, r_q, brow[block], chunk)[0]
                solves += block.size
                programs += 1
                n_solved += block.size
                pos += block.size
                if n_solved >= k_eff:
                    ts = self._now()
                    cur = self._top_k(solved_d, k_eff)
                    threshold = float(solved_d[cur[-1]])
                    if ts is not None:
                        topk_s += self.tracer.now() - ts
            sel = self._top_k(solved_d, k_eff)
            idx_out[i] = sel
            d_out[i] = solved_d[sel]
            if t is not None:
                # one span over the query's blocks: a span a block would
                # crowd the tracer's ring
                self._step("rerank", t, blocks=programs - programs0,
                           solves=solves - solves0, topk_s=topk_s)
        return idx_out, d_out, solves, programs, hits, k_misses

    def _record_prune(self, q, n, k_eff, chunk, margin, exhaustive, rerank,
                      solves, programs, t_bound, t_rerank, tiers, d_out,
                      k_misses) -> None:
        """``last_prune_stats`` of a pruned call over ``n`` docs; the tier
        funnel counts the bound columns, the resident ELL's rows (a live
        corpus's base segment)."""
        final_thresh = (d_out[:, -1].astype(np.float32) if k_eff
                        else np.full(q, np.inf, np.float32))
        self.last_prune_stats = {
            "queries": q, "docs": n, "k": k_eff, "chunk": chunk,
            "margin": margin, "exhaustive": exhaustive, "rerank": rerank,
            "exact_solves": solves, "scan_solves": q * n,
            "solves_avoided": 1.0 - solves / (q * n),
            "rerank_programs": programs,
            "bound_s": t_bound, "rerank_s": t_rerank,
            "tiers": self._tier_stats(tiers, final_thresh, q,
                                      int(self._ell_cols_d.shape[0]),
                                      margin),
            "kcache_misses": k_misses,
        }

    @_serialized
    def _top_k_live_fallback(self, rs: Sequence[np.ndarray], k: int, *,
                             impl: str | None = None,
                             use_cache: bool | None = None,
                             prune_chunk: int | None = None,
                             prune_margin: float | None = None
                             ) -> tuple[np.ndarray, np.ndarray]:
        """Pruned top-k fallback on a live corpus: the exact full scan
        through the per-segment dispatch. The prune knobs are accepted and
        ignored (there is nothing to prune); ``last_prune_stats`` records
        the route and ``wmd_prune_fallback_total`` counts the dispatch.
        Only ``rerank="union"`` (whose shared block schedule does not span
        segments) routes here."""
        self._prune_fallbacks.inc()
        t0 = time.monotonic()
        ids, dist = self.top_k_batch(rs, k, impl=impl, use_cache=use_cache)
        if self._tree is not None:
            self._route = "live_full_scan"
        q, k_eff = ids.shape
        n = self._live_ids.size
        self.last_prune_stats = {
            "queries": q, "docs": n, "k": k_eff, "chunk": 0, "margin": 0.0,
            "exhaustive": True, "rerank": "live_full_scan",
            "exact_solves": q * n, "scan_solves": q * n,
            "solves_avoided": 0.0, "rerank_programs": 0,
            "bound_s": 0.0, "rerank_s": time.monotonic() - t0,
        }
        return ids, dist

    @_serialized
    def _top_k_live_pruned(self, rs: Sequence[np.ndarray], k: int, *,
                           exhaustive: bool, impl: str | None = None,
                           use_cache: bool | None = None,
                           prune_chunk: int | None = None,
                           prune_margin: float | None = None
                           ) -> tuple[np.ndarray, np.ndarray]:
        """Pruned top-k over a live corpus: cascade bounds over the base
        segment, exact-solve the delta outright.

        Per query, the delta segment -- small, capacity-bounded, and the
        only part that mutates between compactions -- is solved whole with
        the same unchunked per-segment program `_query_batch_live`
        dispatches, seeding the running k-th-distance threshold. Live base
        docs are then visited in ascending cascade-bound order through the
        same fixed ``(1, chunk)`` stripes programs as the static pruned
        path, pruning against that threshold; the delta program and the
        base blocks of a query share its pair of vocab-major copies. The
        result is bitwise the full-scan answer: per-doc distance bits do
        not depend on chunk-mates or batch-mates, the K cache assembles
        bit-identical rows either way, and a pruned doc's exact distance
        strictly exceeds the final threshold. ``exhaustive`` disables the
        drop (same programs, same order) -- the live scan oracle."""
        self._refresh_live()
        n_live = self._live_ids.size
        q = len(rs)
        k_eff = min(k, n_live)
        if q == 0 or n_live == 0:
            return (np.zeros((q, k_eff), np.int64),
                    np.zeros((q, k_eff), np.float32))
        if self._tree is not None:
            self._route = "live_scan" if exhaustive else "live_pruned"
        chunk, margin, q, sel_b, r_b, mask_b = self._prune_setup(
            rs, prune_chunk, prune_margin)
        use = use_cache is not False
        combined, tiers, b_t0, b_t1 = self._traced_bounds(sel_b, r_b,
                                                          mask_b, use)
        bounds = combined[:q]               # columns: base-segment rows
        bpos = np.nonzero(self._live_seg == 0)[0]   # live base positions
        dpos = np.nonzero(self._live_seg == 1)[0]   # live delta positions
        r_t0 = time.monotonic()
        idx_out, d_out, solves, programs, hits, k_misses = \
            self._rerank_per_query(sel_b, r_b, mask_b, bounds, bpos,
                                   self._live_row[bpos], dpos, n_live,
                                   k_eff=k_eff, chunk=chunk, margin=margin,
                                   exhaustive=exhaustive,
                                   impl=impl or self.impl, use=use)
        r_t1 = time.monotonic()
        self._traced_record_prune(q, n_live, k_eff, chunk, margin,
                                  exhaustive, "live_pruned",
                                  solves + q * int(dpos.size), programs,
                                  b_t1 - b_t0, r_t1 - r_t0, tiers, d_out,
                                  k_misses)
        self.last_prune_stats["delta_docs"] = int(dpos.size)
        t = self._now()
        self._check_result(d_out, what="top_k distances",
                           empty_doc_mask=self._live_empty[idx_out])
        if t is not None:
            self._step("distance_guard", t)
        total = hits + sum(k_misses)
        self.last_batch_stats = {
            "hit_rate": hits / total if total else 0.0,
            "precompute_t0": b_t0, "precompute_s": b_t1 - b_t0,
            "solve_t0": r_t0, "solve_s": r_t1 - r_t0,
        }
        ids = self._live_ids[idx_out] if idx_out.size else idx_out
        return ids, d_out

    @_serialized
    def _top_k_union(self, rs: Sequence[np.ndarray], k: int, *,
                     impl: str | None = None,
                     use_cache: bool | None = None,
                     prune_chunk: int | None = None,
                     prune_margin: float | None = None
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Union rerank: the offline bulk strategy -- one (Q, chunk) stripes
        program per candidate block instead of Q (1, chunk) programs.

        All queries share one block schedule: among docs still *needed* by
        at least one query, visit the lowest min-over-queries bound first,
        and every program solves the block for the whole batch. A doc is
        needed by query q until q has k exact distances and
        ``bound_q(doc) * (1 - margin) > threshold_q``; thresholds only
        tighten, so the loop ends at the first round with no needed doc.
        Bitwise identical to the per-query rerank: per-cell bits do not
        depend on the program's shape or the K rows' batch, and pruning is
        sound and strict."""
        n = self.ell.num_docs
        k_eff = min(k, n)
        if len(rs) == 0:
            return (np.zeros((0, k_eff), np.int64),
                    np.zeros((0, k_eff), np.float32))
        if self._tree is not None:
            self._route = "union"
        chunk, margin, q, sel_b, r_b, mask_b = self._prune_setup(
            rs, prune_chunk, prune_margin)
        use = use_cache is not False
        combined, tiers, b_t0, b_t1 = self._traced_bounds(sel_b, r_b,
                                                          mask_b, use)
        lb = combined[:q]                                     # (q, N)
        t = self._now()
        self._kcache.ensure_lamb(self.cfg.lamb)   # lambda-invalidation
        impl = impl or self.impl
        fn = self._stripe_fn(impl, None)
        # ONE stripes assembly (and one pair of vocab-major copies) for the
        # whole batch (rows are bit-reproducible either way)
        k_s, km_s, info = self._kcache.stripes_for_batch(sel_b, mask_b,
                                                         use_cache=use)
        if t is not None:
            t = self._step("kcache", t, hits=info["hits"],
                           misses=info["misses"], unique=info["unique"])
        self._check_km(km_s, mask_b)
        if t is not None:
            t = self._step("km_guard", t)
            topk_s = 0.0
        vm = self._vm(k_s, km_s, impl)
        r_all = torch.from_numpy(r_b).to(self.device)        # (Q_pow2, v_r)
        min_lb = lb.min(axis=0)                   # union visit order key
        solved_d = np.full((q, n), np.inf, np.float32)
        unsolved = np.ones(n, bool)
        thresholds = np.full(q, np.inf, np.float32)
        n_solved = 0
        programs = 0
        r_t0 = time.monotonic()
        while True:
            if n_solved >= k_eff:
                need = unsolved & (lb * (1.0 - margin)
                                   <= thresholds[:, None]).any(axis=0)
            else:
                # until every query has k exact distances, every unsolved
                # doc is a candidate (thresholds are still +inf)
                need = unsolved
            cand = np.nonzero(need)[0]
            if cand.size == 0:
                break
            block = cand[np.argsort(min_lb[cand], kind="stable")][:chunk]
            solved_d[:, block] = self._solve_docs(fn, k_s, km_s, vm,
                                                  r_all, block, chunk)[:q]
            unsolved[block] = False
            programs += 1
            n_solved += block.size
            if n_solved >= k_eff:
                ts = self._now()
                for i in range(q):
                    cur = self._top_k(solved_d[i], k_eff)
                    thresholds[i] = solved_d[i][cur[-1]]
                if ts is not None:
                    topk_s += self.tracer.now() - ts
        r_t1 = time.monotonic()
        solves = q * (n - int(unsolved.sum()))
        if t is not None:
            t = self._step("rerank", t, blocks=programs, solves=solves,
                           topk_s=topk_s)
        idx_out = np.empty((q, k_eff), np.int64)
        d_out = np.empty((q, k_eff), np.float32)
        for i in range(q):
            sel = self._top_k(solved_d[i], k_eff)
            idx_out[i] = sel
            d_out[i] = solved_d[i][sel]
        if t is not None:
            self._step("host_topk", t, k=k_eff)
        self._traced_record_prune(q, n, k_eff, chunk, margin, False, "union",
                                  solves, programs, b_t1 - b_t0,
                                  r_t1 - r_t0, tiers, d_out,
                                  [info["misses"]])
        self.last_batch_stats = {
            "hit_rate": info.get("hit_rate", 0.0),
            "precompute_t0": b_t0, "precompute_s": b_t1 - b_t0,
            "solve_t0": r_t0, "solve_s": r_t1 - r_t0,
        }
        t = self._now()
        self._check_result(d_out, what="top_k distances",
                           empty_doc_mask=self._empty_doc_mask[idx_out])
        if t is not None:
            self._step("distance_guard", t)
        return idx_out, d_out

    # -- degraded tier: bound-only answers ------------------------------------

    @_serialized
    def query_batch_bounds(self, rs: Sequence[np.ndarray]) -> np.ndarray:
        """Degraded tier: (Q, N) doc-side RWMD *lower bounds* instead of
        exact distances -- the brownout answer. One min-SDDMM over the
        corpus, no Sinkhorn iterations; a sound lower bound at any budget
        (see `core.rwmd`). On a live service: (Q, num_live) bounds, one
        min-SDDMM per non-empty segment (`_bounds_live`)."""
        if self.live is not None:
            t0 = time.monotonic()
            lb = self._bounds_live(rs)
            t1 = time.monotonic()
            self.last_batch_stats = {
                "precompute_t0": t0, "precompute_s": t1 - t0,
                "solve_t0": t1, "solve_s": 0.0, "degraded": True}
            if self.guards and lb.size:
                _guards.check_finite(lb, "rwmd bounds", lamb=self.cfg.lamb)
            return lb
        if len(rs) == 0:
            return np.zeros((0, self.ell.num_docs), np.float32)
        self._validate_queries(rs)
        q = len(rs)
        sel_b, _, mask_b = self._padded_query_batch(rs)
        t0 = time.monotonic()
        lb = self._bounds_for_batch(sel_b, mask_b)[:q]
        t1 = time.monotonic()
        self.last_batch_stats = {
            "precompute_t0": t0, "precompute_s": t1 - t0,
            "solve_t0": t1, "solve_s": 0.0, "degraded": True}
        if self.guards:
            _guards.check_finite(lb, "rwmd bounds", lamb=self.cfg.lamb)
        return lb

    @_serialized
    def top_k_batch_bounds(self, rs: Sequence[np.ndarray], k: int = 10
                           ) -> tuple[np.ndarray, np.ndarray]:
        """Degraded top-k: nearest-k by RWMD bound only (no rerank), with
        the exact paths' tie-deterministic selection."""
        lb = self.query_batch_bounds(rs)
        k_eff = min(k, lb.shape[-1])
        if len(rs) == 0:
            return (np.zeros((0, k_eff), np.int64),
                    np.zeros((0, k_eff), np.float32))
        idx = self._top_k(lb, k_eff)
        dist = np.take_along_axis(lb, idx, axis=-1)
        if self.live is not None and idx.size:
            idx = self._live_ids[idx]      # positions -> real doc ids
        return idx, dist
