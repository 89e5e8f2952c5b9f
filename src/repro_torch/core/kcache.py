"""Cross-query precompute cache: word-id-keyed K / K.*M row store.

Port of `repro.core.kcache` (`KCacheStats`, `_RowCacheBase`, `KCache` and
the bound tiers' M-row store `MCache`), on one device or on a mesh.

Each row of the (Q, v_r, V) precompute stripes is keyed purely by
``(word_id, lambda)``; nothing query-specific enters until the per-query
1/r scale inside the solver. Zipf query streams repeat most rows across
batches, so the store keeps them resident and the per-batch precompute cost
drops from O(Q * v_r * V * w) to O(misses * V * w).

Layout. Rows live in two device buffers a vocab shard,

    (capacity + 1, Vloc + 1)      S = model-axis shards, Vloc = V // S

(S = 1 without a mesh; with ``mesh=`` shard ``s`` lives on the device of
the mesh position (0, .., model = s, .., 0), the first doc shard's), so
each vocab shard owns the same slice of every cached row that it owns of
the rebucketed ELL (`core.formats.rebucket_for_vocab_shards`). The
reference's two pad tricks keep assembly a pure slot-gather
``k_buf[slots]``:

  * the trailing column of every shard's rows is the shard-local zero pad
    column that ELL pad slots gather (no `pad_k` on the hot path);
  * row index ``capacity`` is a reserved all-zero row that pad *query* rows
    (row_mask == 0) point at, so masking is a host-side ``np.where`` on the
    (Q, v_r) slot map.

Bookkeeping is host-side: exact LRU over a monotone tick, with the current
batch's rows pinned so a miss never evicts a row the same batch hits.
Misses are computed in fixed ``rows_bucket`` chunks (pad ids point at word
0) by `kernels.ops.cdist_kexp_rows` (``kexp_impl="kernel"``: the CUDA kernel
on the card, its plain version on the CPU) or `core.sinkhorn.precompute_rows`
(``kexp_impl="jnp"``, the plain matmul spelling; the value keeps the
reference's name). Both compute a row from its own embedding and the
vocabulary alone, in a fixed order, so a row's bits do not depend on its
chunk-mates: cached rows are bitwise equal to recomputed rows and solver
output is bitwise identical with the cache on or off.

At S > 1 the "kernel" rows run #6 once per model shard per chunk, against
that shard's vocab stripe, on the shard's device; each output column of
#6 is one thread's fma chain whatever its tile, so a shard's rows are the
S = 1 rows split at the stripe boundaries, bit for bit. The "jnp" rows
are computed whole on the first device and split, as the reference does.
The reference refuses ``kexp_impl="kernel"`` at S > 1 (Pallas does not run
under its vocab sharding); the port has no such limit.

Batches whose unique-id count exceeds ``capacity`` (and every call when
``capacity == 0`` or ``use_cache=False``) take the *transient* path: the
same dedup, row compute and slot-gather from a throwaway store -- the
cache-off baseline, bitwise equal to the cached path by construction.

Invalidation: `ensure_lamb` drops the whole store when lambda changes;
`invalidate_ids` drops the rows of words whose embeddings changed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.rwmd import _m_row_block, assemble_m_stripes
from repro_torch.core.sinkhorn import precompute_rows
from repro_torch.launch.mesh import (check_placement, on_device,
                                     one_device_mesh, shard_grid)


@dataclasses.dataclass
class KCacheStats:
    """Cumulative counters (unique rows, not query-row slots)."""

    lookups: int = 0        # stripes_for_batch calls
    hit_rows: int = 0       # unique ids served from resident rows
    miss_rows: int = 0      # unique ids computed fresh
    evictions: int = 0
    bypasses: int = 0       # calls that skipped the store entirely
    invalidations: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hit_rows + self.miss_rows
        return self.hit_rows / total if total else 0.0


class _RowCacheBase:
    """Host-side bookkeeping: exact LRU over a monotone tick with the
    current batch's rows pinned, free-list slot allocation, full and scoped
    invalidation, registry mirroring. Subclasses own the device buffers and
    the row compute; they set ``capacity``, ``stats`` and ``_m`` before
    calling `_reset_map`."""

    def _mirror(self, name: str, n: float = 1) -> None:
        """Mirror a KCacheStats bump into the registry (no-op unattached)."""
        if self._m is not None:
            self._m[name].inc(n)
            self._m["resident"].set(len(self._slot_of))

    def _reset_map(self):
        self._slot_of: dict[int, int] = {}
        self._id_of = np.full(self.capacity, -1, np.int64)
        self._last_used = np.zeros(self.capacity, np.int64)
        self._free = list(range(self.capacity - 1, -1, -1))  # pop() -> 0,1,..
        self._tick = 0

    @property
    def resident(self) -> int:
        return len(self._slot_of)

    def invalidate(self):
        """Drop every cached row (all ids become misses)."""
        self._reset_map()
        self.stats.invalidations += 1
        self._mirror("invalidations")

    def invalidate_ids(self, word_ids) -> int:
        """Drop exactly the rows for ``word_ids``; returns how many were
        resident (the scoped invalidation for embedding updates)."""
        dropped = 0
        for wid in word_ids:
            s = self._slot_of.pop(int(wid), None)
            if s is None:
                continue
            self._id_of[s] = -1
            self._last_used[s] = 0
            self._free.append(s)
            dropped += 1
        if dropped:
            self.stats.invalidations += 1
            self._mirror("invalidations")
        return dropped

    def _alloc_slots(self, n: int) -> list[int]:
        """Free slots first, then exact-LRU eviction among rows not touched
        this tick (the current batch's hits are pinned by construction)."""
        slots = []
        while self._free and len(slots) < n:
            slots.append(self._free.pop())
        need = n - len(slots)
        if need:
            evictable = (self._id_of >= 0) & (self._last_used < self._tick)
            cand = np.nonzero(evictable)[0]
            order = cand[np.argsort(self._last_used[cand], kind="stable")]
            for s in order[:need]:
                del self._slot_of[int(self._id_of[s])]
                self._id_of[s] = -1
            self.stats.evictions += need
            self._mirror("evictions", need)
            slots.extend(int(s) for s in order[:need])
        return slots


def _row_stripes(ids: torch.Tensor, vecs: torch.Tensor, b2: torch.Tensor,
                 stripes: list, devices: list, *, lamb: float,
                 kexp_impl: str) -> tuple[list, list]:
    """(m,) word ids -> the shards' (K, K.*M) rows in cache layout, each
    (m, Vloc+1) on its shard's device: the appended zero column is the
    shard-local ELL pad column. "kernel": #6 once a shard against its
    stripe; "jnp": whole rows on the first device, split."""
    if kexp_impl == "kernel":
        from repro_torch.kernels import ops
        a = vecs[ids]
        rows = []
        for stripe, dev in zip(stripes, devices):
            with on_device(dev):
                rows.append(ops.cdist_kexp_rows(a.to(dev), stripe,
                                                lamb=lamb))
    else:
        k, km = precompute_rows(ids, vecs, lamb, b2=b2)
        vloc = k.shape[1] // len(devices)
        rows = [(k[:, s * vloc:(s + 1) * vloc].to(dev),
                 km[:, s * vloc:(s + 1) * vloc].to(dev))
                for s, dev in enumerate(devices)]

    def layout(x):
        return torch.nn.functional.pad(x, (0, 1))

    return [layout(k) for k, _ in rows], [layout(km) for _, km in rows]


class KCache(_RowCacheBase):
    """Device-resident (word_id, lambda)-keyed K / K.*M row cache.

    Args:
      capacity:    resident row slots; 0 disables the store (every call takes
                   the transient path -- the exact cache-off baseline).
      vecs:        (V, w) float32 embeddings, numpy or a tensor; moved to
                   the (first) device.
      lamb:        entropy regularization the rows are keyed under.
      mesh:        a `launch.mesh.Mesh`: the rows split into
                   S = ``mesh.shape[model_axis]`` vocab stripes, each on its
                   model shard's device (see the module docstring). None:
                   the (1, 1) mesh of ``device``, one shard.
      device:      where the buffers and the row compute live without a
                   mesh ("cuda" by default; pass "cpu" for the plain
                   versions).
      rows_bucket: fixed chunk size of the miss compute (the
                   bit-reproducibility guarantee above).
      kexp_impl:   "kernel" (`kernels.ops.cdist_kexp_rows`, the default) or
                   "jnp" (`core.sinkhorn.precompute_rows`).
      metrics:     optional `repro_torch.obs.MetricsRegistry`; when set,
                   every KCacheStats counter is mirrored into ``wmd_kcache_*``
                   registry metrics at the same mutation sites.

    `stripes_for_batch` returns the list of the S shards' (Q, v_r,
    Vloc+1) stripes (one without a mesh).
    """

    def __init__(self, capacity: int, vecs, lamb: float, *, mesh=None,
                 model_axis: str = "model",
                 device: str | torch.device = "cuda",
                 rows_bucket: int = 128, kexp_impl: str = "kernel",
                 metrics=None):
        if kexp_impl not in ("jnp", "kernel"):
            raise ValueError(f"kexp_impl must be 'jnp' or 'kernel', "
                             f"got {kexp_impl!r}")
        self.capacity = int(capacity)
        self.lamb = float(lamb)
        self.rows_bucket = int(rows_bucket)
        self.kexp_impl = kexp_impl
        if mesh is None:
            mesh = one_device_mesh(device)
        self._grid = shard_grid(mesh, (), model_axis)
        self._devices = list(self._grid[0])
        self.device = self._devices[0]
        self.num_shards = len(self._devices)
        self._vecs = torch.as_tensor(vecs, dtype=torch.float32,
                                     device=self.device).contiguous()
        self.vocab = self._vecs.shape[0]
        if self.vocab % self.num_shards:
            raise ValueError(f"vocab {self.vocab} not divisible by model "
                             f"shards {self.num_shards}")
        self.vloc = self.vocab // self.num_shards
        self._b2 = torch.sum(self._vecs * self._vecs, dim=-1)
        # each shard's vocab stripe, on its device (the whole vocabulary
        # itself at S = 1)
        self._stripes = [
            self._vecs[s * self.vloc:(s + 1) * self.vloc].to(dev).contiguous()
            for s, dev in enumerate(self._devices)]
        self._alloc_buffers()
        self.stats = KCacheStats()
        self._m = None
        if metrics is not None:
            self._m = {
                "lookups": metrics.counter(
                    "wmd_kcache_lookups_total",
                    "stripes_for_batch calls"),
                "hit_rows": metrics.counter(
                    "wmd_kcache_hit_rows_total",
                    "unique rows served from the resident store"),
                "miss_rows": metrics.counter(
                    "wmd_kcache_miss_rows_total",
                    "unique rows computed fresh"),
                "evictions": metrics.counter(
                    "wmd_kcache_evictions_total", "LRU evictions"),
                "bypasses": metrics.counter(
                    "wmd_kcache_bypasses_total",
                    "calls that skipped the resident store"),
                "invalidations": metrics.counter(
                    "wmd_kcache_invalidations_total",
                    "full or scoped row invalidations"),
                "resident": metrics.gauge(
                    "wmd_kcache_resident_rows",
                    "rows currently resident"),
            }
        self._reset_map()
        for what, ts in (("K-cache stripes", self._stripes),
                         ("K buffers", self._k_bufs),
                         ("K.*M buffers", self._km_bufs)):
            check_placement(self._grid, ts, what)

    def _alloc_buffers(self):
        """All-zero row buffers, one pair a shard on its device (+1 row:
        the reserved zero row pad query rows gather)."""
        self._k_bufs = [torch.zeros((self.capacity + 1, self.vloc + 1),
                                    dtype=torch.float32, device=dev)
                        for dev in self._devices]
        self._km_bufs = [torch.zeros_like(b) for b in self._k_bufs]

    def invalidate(self, lamb: float | None = None):
        """Drop every cached row (all ids become misses). Pass ``lamb`` to
        re-key the store under a new regularization strength."""
        if lamb is not None:
            self.lamb = float(lamb)
        super().invalidate()

    def ensure_lamb(self, lamb: float):
        """Invalidate iff ``lamb`` differs from the store's key."""
        if float(lamb) != self.lamb:
            self.invalidate(lamb)

    def _compute_chunks(self, ids: np.ndarray):
        """Yield (chunk_len, k_rows, km_rows) over fixed rows_bucket chunks,
        the rows a list of the shards' (rows_bucket, Vloc+1) (pad ids point
        at word 0; their rows are discarded by the caller)."""
        rb = self.rows_bucket
        for lo in range(0, len(ids), rb):
            chunk = ids[lo:lo + rb]
            ids_p = np.zeros(rb, np.int64)
            ids_p[:len(chunk)] = chunk
            k_r, km_r = _row_stripes(
                torch.from_numpy(ids_p).to(self.device), self._vecs,
                self._b2, self._stripes, self._devices, lamb=self.lamb,
                kexp_impl=self.kexp_impl)
            yield len(chunk), k_r, km_r

    def stripes_for_batch(self, sel_b: np.ndarray, row_mask: np.ndarray, *,
                          use_cache: bool = True):
        """Assemble the batch's precompute stripes, computing only missing
        rows.

        Args:
          sel_b:    (Q, v_r) int word ids (pad slots point at word 0).
          row_mask: (Q, v_r) f32, 0.0 on pad query rows.
          use_cache: False forces the transient path (the cache-off
                     baseline) without reading or mutating the store.

        Returns (k_stripes, km_stripes, info): the stripe pairs for
        `core.distributed.build_wmd_batch_fn_stripes`, the list of the S
        shards' (Q, v_r, Vloc+1) device tensors (one shard without a mesh:
        ``[0]`` is the stripe of `sinkhorn_wmd_sparse_batch_stripes`), and
        a per-call info dict (unique / hits / misses / hit_rate / cached).
        """
        sel_b = np.asarray(sel_b)
        ids = np.unique(sel_b)                       # sorted: stable dedup
        self.stats.lookups += 1
        self._mirror("lookups")
        cached = use_cache and 0 < len(ids) <= self.capacity
        if not cached:
            return self._transient(ids, sel_b, row_mask, use_cache)
        self._tick += 1
        slot_arr = np.array([self._slot_of.get(int(i), -1) for i in ids],
                            np.int64)
        hit = slot_arr >= 0
        self._last_used[slot_arr[hit]] = self._tick  # pin the batch's hits
        miss_ids = ids[~hit]
        if len(miss_ids):
            new_slots = self._alloc_slots(len(miss_ids))
            try:
                rb = self.rows_bucket
                for lo, (n_c, k_r, km_r) in zip(
                        range(0, len(miss_ids), rb),
                        self._compute_chunks(miss_ids)):
                    # the chunk's pad rows are dropped here (the reference
                    # aims them out of bounds of its scatter instead)
                    for s, dev in enumerate(self._devices):
                        slots_t = torch.as_tensor(new_slots[lo:lo + n_c],
                                                  device=dev)
                        self._k_bufs[s][slots_t] = k_r[s][:n_c]
                        self._km_bufs[s][slots_t] = km_r[s][:n_c]
            except BaseException:
                # a failed row compute must not poison the map: the new ids
                # were never (fully) written, so their slots go back to the
                # free list unmapped. Evicted victims stay evicted (a later
                # miss recomputes them); only unsubstantiated residency
                # would break exactness. The update is in place, so the
                # buffers themselves survive.
                self._free.extend(new_slots)
                raise
            for i, s in zip(miss_ids, new_slots):
                self._slot_of[int(i)] = s
                self._id_of[s] = int(i)
                self._last_used[s] = self._tick
            slot_arr[~hit] = new_slots
        n_hit, n_miss = int(hit.sum()), len(miss_ids)
        self.stats.hit_rows += n_hit
        self.stats.miss_rows += n_miss
        if self._m is not None:
            self._mirror("hit_rows", n_hit)
            self._mirror("miss_rows", n_miss)
        slots_b = slot_arr[np.searchsorted(ids, sel_b)]
        # pad query rows gather the reserved zero row (index capacity)
        slots_b = np.where(np.asarray(row_mask) > 0, slots_b, self.capacity)
        k_s, km_s = self._gather(self._k_bufs, self._km_bufs, slots_b)
        return k_s, km_s, {"unique": len(ids), "hits": n_hit,
                           "misses": n_miss,
                           "hit_rate": n_hit / len(ids), "cached": True}

    def _gather(self, k_bufs, km_bufs, slots_b: np.ndarray):
        """Slot-gather (Q, v_r) slots from each shard's row table -> the
        stripes in `stripes_for_batch`'s layout."""
        idx = torch.from_numpy(slots_b.astype(np.int64))
        k_s, km_s = [], []
        for k_buf, km_buf, dev in zip(k_bufs, km_bufs, self._devices):
            idx_d = idx.to(dev)
            k_s.append(k_buf[idx_d])
            km_s.append(km_buf[idx_d])
        return k_s, km_s

    def _transient(self, ids, sel_b, row_mask, use_cache):
        """Compute every unique row fresh into a throwaway store (cache off,
        or the batch's unique ids exceed capacity). Identical dedup, row
        compute and slot-gather as the resident path."""
        if use_cache and self.capacity > 0:
            # capacity overflow: real misses of an enabled store; a disabled
            # or bypassed store only counts a bypass
            self.stats.miss_rows += len(ids)
            self._mirror("miss_rows", len(ids))
        self.stats.bypasses += 1
        self._mirror("bypasses")
        parts = [(k_r, km_r, n_c)
                 for n_c, k_r, km_r in self._compute_chunks(ids)]
        k_t, km_t = [], []
        for s, dev in enumerate(self._devices):
            zero = torch.zeros((1, self.vloc + 1), dtype=torch.float32,
                               device=dev)
            k_t.append(torch.cat([p[0][s][:p[2]] for p in parts] + [zero]))
            km_t.append(torch.cat([p[1][s][:p[2]] for p in parts] + [zero]))
        zero_row = k_t[0].shape[0] - 1
        pos_b = np.where(np.asarray(row_mask) > 0,
                         np.searchsorted(ids, sel_b), zero_row)
        k_s, km_s = self._gather(k_t, km_t, pos_b)
        return k_s, km_s, {"unique": len(ids), "hits": 0,
                           "misses": len(ids), "hit_rate": 0.0,
                           "cached": False}


class MCache(_RowCacheBase):
    """Device-resident word-id-keyed M-row cache for the bound tiers.

    Same LRU, pinning, ``rows_bucket`` and rollback machinery as `KCache`,
    over ONE (capacity + 1, V + 1) buffer: rows are keyed by ``word_id``
    alone (M is pure geometry, no lambda), and row index ``capacity`` is a
    reserved **+inf** row that pad query rows gather (the doc-side min must
    never be won by a pad row -- the opposite sign of the K store's
    reserved zero row). Misses go through `core.rwmd._m_row_block` in fixed
    ``rows_bucket`` chunks, the spelling of the transient assembly
    (`core.rwmd.assemble_m_stripes`), so cache on / off stripes are bitwise
    equal by construction.

    Unlike the reference, whose M rows have one spelling shared with its K
    rows (`m_rows`), this store takes ``kexp_impl`` and computes M the way
    the service's K cache computes K: "kernel" with `kernels.ops.cdist`
    (on the card, the distance epilogue of the CUDA kernel whose exp
    epilogue makes the K and K.*M rows), "jnp" with `core.sinkhorn.m_rows`.
    The bound's soundness argument (``rwmd <= the engine's distance``, see
    `core.rwmd`) needs the M rows to be bit for bit the M that the K rows
    exponentiate; a matmul-spelled M beside kernel-made K rows would differ
    by up to 2.5e-2 on a word's own column (measured at w = 300).

    Args:
      capacity:    resident row slots; 0 disables the store.
      vecs:        (V, w) float32 embeddings, numpy or a tensor; moved to
                   ``device``.
      device:      where the buffer and the row compute live ("cuda" by
                   default).
      rows_bucket: fixed chunk of the miss compute (must match the
                   service's, for the on / off bitwise contract).
      kexp_impl:   "kernel" (default) or "jnp", as above.
      metrics:     optional `repro_torch.obs.MetricsRegistry` ->
                   ``wmd_mcache_*``.
    """

    def __init__(self, capacity: int, vecs, *,
                 device: str | torch.device = "cuda",
                 rows_bucket: int = 128, kexp_impl: str = "kernel",
                 metrics=None):
        if kexp_impl not in ("jnp", "kernel"):
            raise ValueError(f"kexp_impl must be 'jnp' or 'kernel', "
                             f"got {kexp_impl!r}")
        self.capacity = int(capacity)
        self.rows_bucket = int(rows_bucket)
        self.kexp_impl = kexp_impl
        self.device = torch.device(device)
        self._vecs = torch.as_tensor(vecs, dtype=torch.float32,
                                     device=self.device).contiguous()
        self.vocab = self._vecs.shape[0]
        self._b2 = torch.sum(self._vecs * self._vecs, dim=-1)
        self._m_buf = torch.full((self.capacity + 1, self.vocab + 1),
                                 float("inf"), dtype=torch.float32,
                                 device=self.device)
        self.stats = KCacheStats()
        self._m = None
        if metrics is not None:
            self._m = {
                "lookups": metrics.counter(
                    "wmd_mcache_lookups_total",
                    "m_stripes_for_batch calls"),
                "hit_rows": metrics.counter(
                    "wmd_mcache_hit_rows_total",
                    "unique M rows served from the resident store"),
                "miss_rows": metrics.counter(
                    "wmd_mcache_miss_rows_total",
                    "unique M rows computed fresh"),
                "evictions": metrics.counter(
                    "wmd_mcache_evictions_total", "LRU evictions"),
                "bypasses": metrics.counter(
                    "wmd_mcache_bypasses_total",
                    "calls that skipped the resident store"),
                "invalidations": metrics.counter(
                    "wmd_mcache_invalidations_total",
                    "full or scoped M-row invalidations"),
                "resident": metrics.gauge(
                    "wmd_mcache_resident_rows",
                    "M rows currently resident"),
            }
        self._reset_map()

    def m_stripes_for_batch(self, sel_b: np.ndarray, row_mask: np.ndarray, *,
                            use_cache: bool = True):
        """Assemble the batch's (Q, v_r, V+1) M stripes, computing only
        missing rows. Mirrors `KCache.stripes_for_batch`; the transient path
        IS `core.rwmd.assemble_m_stripes`. Returns (m_pad, info)."""
        sel_b = np.asarray(sel_b)
        ids = np.unique(sel_b)                       # sorted: stable dedup
        self.stats.lookups += 1
        self._mirror("lookups")
        cached = use_cache and 0 < len(ids) <= self.capacity
        if not cached:
            if use_cache and self.capacity > 0:
                self.stats.miss_rows += len(ids)
                self._mirror("miss_rows", len(ids))
            self.stats.bypasses += 1
            self._mirror("bypasses")
            m_pad = assemble_m_stripes(sel_b, row_mask, self._vecs,
                                       b2=self._b2,
                                       rows_bucket=self.rows_bucket,
                                       impl=self.kexp_impl)
            return m_pad, {"unique": len(ids), "hits": 0,
                           "misses": len(ids), "hit_rate": 0.0,
                           "cached": False}
        self._tick += 1
        slot_arr = np.array([self._slot_of.get(int(i), -1) for i in ids],
                            np.int64)
        hit = slot_arr >= 0
        self._last_used[slot_arr[hit]] = self._tick  # pin the batch's hits
        miss_ids = ids[~hit]
        if len(miss_ids):
            new_slots = self._alloc_slots(len(miss_ids))
            try:
                rb = self.rows_bucket
                for lo in range(0, len(miss_ids), rb):
                    chunk = miss_ids[lo:lo + rb]
                    ids_p = np.zeros(rb, np.int64)   # pad ids: word 0
                    ids_p[:len(chunk)] = chunk
                    rows = _m_row_block(
                        torch.from_numpy(ids_p).to(self.device), self._vecs,
                        self._b2, impl=self.kexp_impl)
                    slots_t = torch.as_tensor(new_slots[lo:lo + len(chunk)],
                                              device=self.device)
                    self._m_buf[slots_t] = rows[:len(chunk)]
            except BaseException:
                # same rollback contract as the K store: never leave
                # unsubstantiated residency behind (the update is in place,
                # so the buffer itself survives)
                self._free.extend(new_slots)
                raise
            for i, s in zip(miss_ids, new_slots):
                self._slot_of[int(i)] = s
                self._id_of[s] = int(i)
                self._last_used[s] = self._tick
            slot_arr[~hit] = new_slots
        n_hit, n_miss = int(hit.sum()), len(miss_ids)
        self.stats.hit_rows += n_hit
        self.stats.miss_rows += n_miss
        if self._m is not None:
            self._mirror("hit_rows", n_hit)
            self._mirror("miss_rows", n_miss)
        slots_b = slot_arr[np.searchsorted(ids, sel_b)]
        # pad query rows gather the reserved +inf row (index capacity)
        slots_b = np.where(np.asarray(row_mask) > 0, slots_b, self.capacity)
        idx = torch.from_numpy(slots_b.astype(np.int64)).to(self.device)
        return self._m_buf[idx], {"unique": len(ids), "hits": n_hit,
                                  "misses": n_miss,
                                  "hit_rate": n_hit / len(ids),
                                  "cached": True}
