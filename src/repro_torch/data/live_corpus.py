"""Crash-consistent mutable corpus: WAL-backed upserts, tombstones, and
interruptible compaction over the frozen ELL machinery of `core.formats`.

A copy of `repro.data.live_corpus` on the port's `core.formats`, with the
same disk layout, snapshot and WAL bytes (the port's msgpack codec,
`data._msgpack`, writes what ``msgpack.packb(use_bin_type=True)``
writes), so a directory written by either package opens in the other.

Every serving scenario before this module assumed a corpus built once at
startup. `LiveCorpus` makes the *data* path mutable without giving up one
bit of the engine's determinism, by an LSM-style two-segment layout:

  * **base segment** -- an immutable capacity-padded `EllDocs` built at the
    last compaction (or recovery), exactly the ELL a one-shot build
    produces for the same docs in the same (ascending-id) order;
  * **delta segment** -- an append-only capacity-padded ELL absorbing
    recent `add_docs`; rows are written in place into pow2-grown arrays
    (`core.formats.write_doc_row` / `ell_with_capacity`), so the device
    program shapes stay stable between growth events;
  * **tombstones** -- `remove_docs` (and the old copy an upsert shadows)
    never rewrites a segment: the doc's id simply leaves the location map,
    and its delta row (if any) is cleared to ELL padding. Pad slots gather
    the engine's appended all-zero K column and contribute exactly 0 --
    the same pad-slot inertness the frozen engine already relies on -- so
    a dead row costs flops but can never change a live doc's bits.

The **incremental == batch contract**: per-doc Sinkhorn distances are
bitwise independent of ELL layout (row order, row count, nnz_max slack,
dead neighbors -- each (query, doc) cell reduces over its own slots only,
verified empirically across radically different layouts). Therefore a
corpus assembled by any interleaving of adds/removes/upserts answers
queries bit-for-bit like the same logical doc set built in one shot --
`serving.wmd_service.WMDService` gathers per-segment results into
ascending-doc-id order, and the golden table + ingest chaos suite pin it.

Durability (`data.wal`): every mutation is appended to a checksummed WAL
and fsynced BEFORE it is applied in memory or acknowledged, so **acked
means recoverable** after a kill -9 at any instant. Recovery loads the
newest complete snapshot generation and replays its WAL with
truncate-at-first-bad-record semantics. Raw (word_id, count) docs -- not
derived ELL arrays -- are what's logged and snapshotted, so every rebuild
runs the identical `ell_from_doc_lists` arithmetic and bits never drift.

Compaction is an *interruptible* job with an atomic segment swap, the
checkpointer's tmp-dir/rename pattern (the reference's
`repro.checkpoint.checkpointer._write`):
build the new base from the live docs, write ``snapshot_<gen+1>.tmp``,
fsync, rename, THEN swap segments in memory, rotate to ``wal_<gen+1>``
and garbage-collect old generations. A crash anywhere before the rename
leaves the old generation fully live (retry is idempotent); a crash after
it recovers to the new generation with an empty delta -- either way the
logical corpus is exactly the pre-crash one.

Crash boundaries (`crash_hook` -- `serving.faultinject.CrashInjector`):
``wal.append.pre`` / ``wal.append.torn`` / ``wal.append.synced`` inside
every append, and ``compact.begin`` / ``compact.built`` /
``compact.snapshot.tmp`` / ``compact.renamed`` / ``compact.done`` across
compaction. The chaos suite dry-runs an op sequence to enumerate its
boundaries, then sweeps a kill over every single one and asserts bitwise
recovery. Production passes no hook.

Disk layout (all inside one directory)::

    snapshot_<gen>/docs.msgpack   raw docs, ascending id (sha256 in meta)
    snapshot_<gen>/meta.json      gen, num_vocab, num_docs, checksum
    snapshot_<gen>.tmp/           crashed-writer leftovers (ignored)
    wal_<gen>.log                 mutations since snapshot <gen>
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.core import formats
from repro_torch.data import _msgpack
from repro_torch.data import wal as wal_mod

_BASE, _DELTA = 0, 1


def _no_hook(name: str) -> None:
    pass


Doc = list  # [(word_id, count), ...] -- raw counts, normalized at ELL time


class LiveCorpus:
    """WAL-backed mutable corpus over a base + delta ELL segment pair.

    Opening is recovery: a fresh directory starts empty at generation 0;
    an existing one loads its newest complete snapshot and replays that
    generation's WAL (truncating any torn tail a crashed writer left).

    Args:
      path:        corpus directory (created if missing).
      num_vocab:   V; word ids are validated against it at the API edge.
      nnz_align:   ELL row-width rounding, as in `core.formats`.
      min_capacity: smallest segment row capacity (pow2-grown above it);
                   also keeps even an empty segment shard-divisible.
      normalize:   normalize doc weights at ELL-build time (pass False
                   when feeding already-normalized weights).
      crash_hook:  test-only boundary callback (see module docstring).
      tracer:      optional `repro_torch.obs` tracer; WAL/compaction boundaries
                   are recorded as structured events (also settable after
                   construction via the ``tracer`` property).
    """

    def __init__(self, path: str, num_vocab: int, *, nnz_align: int = 8,
                 min_capacity: int = 8, normalize: bool = True,
                 crash_hook: Callable[[str], None] | None = None,
                 tracer=None):
        self.path = path
        self.num_vocab = int(num_vocab)
        self.nnz_align = int(nnz_align)
        self.min_capacity = max(int(min_capacity), 1)
        self.normalize = bool(normalize)
        self._hook = crash_hook or _no_hook
        if tracer is None:
            from repro_torch.obs.trace import NULL_TRACER
            tracer = NULL_TRACER
        self._tracer = tracer
        self._lock = threading.RLock()
        # compactions serialize among themselves on a separate lock so the
        # corpus lock is held only for the begin capture and the final swap
        # -- never across the O(docs) rebuild or the snapshot fsyncs
        self._compact_lock = threading.Lock()
        self._compacting = False
        self._pending: list[dict] = []
        self._metrics = None
        self._lock_hold = None
        self.version = 0
        self.base_version = 0

        os.makedirs(path, exist_ok=True)
        gens = [int(d.split("_")[1]) for d in os.listdir(path)
                if d.startswith("snapshot_") and not d.endswith(".tmp")]
        self.gen = max(gens) if gens else 0
        snap_docs: list = []
        if gens:
            snap_docs = self._read_snapshot(self.gen)
        self._docs: dict[int, Doc] = {
            int(i): [(int(w), float(c)) for w, c in d] for i, d in snap_docs}
        self._install_base()
        # replay EVERY surviving WAL generation ascending, not only the
        # snapshot's own (missing file = empty log; a torn tail is
        # truncated so the reopened writer extends a verified log). A
        # compaction that crashed between the snapshot rename and the
        # pending re-log leaves records acked during its build phase only
        # in the PREVIOUS generation's log; replay is idempotent -- a
        # doc's final state is its last op, so re-applying records the
        # snapshot already folded in changes nothing.
        wal_gens = sorted(
            int(n.split("_")[1].split(".")[0]) for n in os.listdir(path)
            if n.startswith("wal_"))
        for g in wal_gens:
            for rec in wal_mod.replay(self._wal_path(g)):
                if rec["op"] == "add":
                    self._apply_add(rec["ids"], rec["docs"])
                elif rec["op"] == "remove":
                    self._apply_remove(rec["ids"])
        self._wal = wal_mod.WalWriter(self._wal_path(self.gen),
                                      hook=self._hook, tracer=self._tracer)

    # -- observability -----------------------------------------------------
    # compaction/WAL boundaries are emitted to an optional repro_torch.obs tracer
    # alongside (and strictly BEFORE) the test-only crash hook, so even an
    # injected-crash run leaves the boundary it died at in the event log.
    # The tracer is late-bindable: `lc.tracer = t` after construction also
    # rebinds the open WAL writer.

    @property
    def tracer(self):
        return self._tracer

    @tracer.setter
    def tracer(self, t) -> None:
        self._tracer = t
        wal = getattr(self, "_wal", None)
        if wal is not None:
            wal.tracer = t

    @property
    def metrics(self):
        return self._metrics

    @metrics.setter
    def metrics(self, registry) -> None:
        """Late-bindable `repro_torch.obs` MetricsRegistry; wiring one arms the
        ``wmd_compact_lock_hold_seconds`` histogram, the observable proof
        that compaction's corpus-lock holds stay O(swap), not O(rebuild)."""
        self._metrics = registry
        self._lock_hold = None if registry is None else registry.histogram(
            "wmd_compact_lock_hold_seconds",
            "corpus-lock hold time of each compaction locked phase")

    def _observe_hold(self, t0: float) -> None:
        if self._lock_hold is not None:
            self._lock_hold.observe(time.perf_counter() - t0)

    def _boundary(self, name: str, **fields) -> None:
        if self._tracer.enabled:
            self._tracer.event(name, gen=self.gen, **fields)
        self._hook(name)

    # -- paths / snapshot io ----------------------------------------------

    def _wal_path(self, gen: int) -> str:
        return os.path.join(self.path, f"wal_{gen:08d}.log")

    def _snap_dir(self, gen: int) -> str:
        return os.path.join(self.path, f"snapshot_{gen:08d}")

    def _read_snapshot(self, gen: int) -> list:
        snap = self._snap_dir(gen)
        with open(os.path.join(snap, "meta.json")) as f:
            meta = json.load(f)
        if meta["num_vocab"] != self.num_vocab:
            raise ValueError(f"snapshot vocab {meta['num_vocab']} != "
                             f"corpus vocab {self.num_vocab}")
        with open(os.path.join(snap, "docs.msgpack"), "rb") as f:
            blob = f.read()
        digest = hashlib.sha256(blob).hexdigest()
        if digest != meta["sha256"]:
            raise RuntimeError(
                f"snapshot generation {gen} failed its checksum "
                f"({digest[:12]} != {meta['sha256'][:12]}) -- the rename "
                "was atomic, so this is disk corruption, not a crash")
        return _msgpack.unpackb(blob)

    def _write_snapshot(self, gen: int, ids: list[int],
                        docs: list[Doc]) -> None:
        """Atomic snapshot write: tmp dir -> fsync files -> rename -> fsync
        parent (the checkpointer's pattern, plus directory durability)."""
        final = self._snap_dir(gen)
        tmp = final + ".tmp"
        if os.path.exists(tmp):      # a previously killed compaction's
            shutil.rmtree(tmp)       # leftovers must not leak into this one
        os.makedirs(tmp)
        blob = _msgpack.packb(
            [[i, [[w, c] for w, c in d] or []] for i, d in zip(ids, docs)])
        with open(os.path.join(tmp, "docs.msgpack"), "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        meta = {"gen": gen, "num_vocab": self.num_vocab,
                "num_docs": len(ids), "normalize": self.normalize,
                "nnz_align": self.nnz_align,
                "sha256": hashlib.sha256(blob).hexdigest()}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        self._boundary("compact.snapshot.tmp")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        dirfd = os.open(self.path, os.O_RDONLY)
        try:
            os.fsync(dirfd)          # make the rename itself durable
        finally:
            os.close(dirfd)

    # -- segment construction ---------------------------------------------

    def _segment_ell(self, docs: Sequence[Doc]) -> formats.EllDocs:
        """Capacity-padded ELL of ``docs`` -- the EXACT `ell_from_doc_lists`
        arithmetic a one-shot build runs, then pow2 row slack."""
        ell = formats.ell_from_doc_lists(docs, self.num_vocab,
                                         nnz_align=self.nnz_align,
                                         normalize=self.normalize)
        cap = formats.next_pow2(max(ell.num_docs, self.min_capacity))
        return formats.ell_with_capacity(ell, cap)

    def _install_base(self) -> None:
        """(Re)build the base segment from the current live docs (ascending
        id) and reset the delta to empty minimum capacity."""
        ids = sorted(self._docs)
        self._base_ell = self._segment_ell([self._docs[i] for i in ids])
        self._where: dict[int, tuple[int, int]] = {
            i: (_BASE, row) for row, i in enumerate(ids)}
        nnz = formats._round_up(1, self.nnz_align)
        self._dcols = np.full((self.min_capacity, nnz), self.num_vocab,
                              np.int32)
        self._dvals = np.zeros((self.min_capacity, nnz), np.float32)
        self._dlen = 0
        self.base_version += 1
        self.version += 1

    def _grow_delta(self, need_nnz: int) -> None:
        rows, nnz = self._dcols.shape
        new_rows = rows if self._dlen < rows else \
            formats.next_pow2(max(rows * 2, self.min_capacity))
        new_nnz = nnz if need_nnz <= nnz else \
            formats._round_up(need_nnz, self.nnz_align)
        cols = np.full((new_rows, new_nnz), self.num_vocab, np.int32)
        vals = np.zeros((new_rows, new_nnz), np.float32)
        cols[:rows, :nnz] = self._dcols
        vals[:rows, :nnz] = self._dvals
        self._dcols, self._dvals = cols, vals

    def _tombstone(self, doc_id: int) -> bool:
        loc = self._where.pop(doc_id, None)
        if loc is None:
            return False
        seg, row = loc
        if seg == _DELTA:
            # clear the dead delta row to padding: pad-slot inertness makes
            # it contribute exactly 0 until compaction reclaims it (base
            # rows are left stale -- the result gather never reads them)
            self._dcols[row, :] = self.num_vocab
            self._dvals[row, :] = 0.0
        self._docs.pop(doc_id, None)
        return True

    # -- mutation application (shared by live ops and WAL replay) ---------

    def _apply_add(self, ids, docs) -> None:
        for i, doc in zip(ids, docs):
            i = int(i)
            doc = [(int(w), float(c)) for w, c in doc]
            self._tombstone(i)                        # upsert semantics
            if len(doc) > self._dcols.shape[1] \
                    or self._dlen >= self._dcols.shape[0]:
                self._grow_delta(len(doc))
            row = self._dlen
            self._dlen += 1
            formats.write_doc_row(self._dcols, self._dvals, row, doc,
                                  self.num_vocab, normalize=self.normalize)
            self._where[i] = (_DELTA, row)
            self._docs[i] = doc
        self.version += 1

    def _apply_remove(self, ids) -> int:
        removed = sum(self._tombstone(int(i)) for i in ids)
        self.version += 1
        return removed

    # -- public mutation API ----------------------------------------------

    def add_docs(self, ids: Sequence[int],
                 docs: Sequence[Sequence[tuple[int, float]]]) -> int:
        """Durable upsert: WAL-append + fsync, THEN apply. Returns the
        number of docs acked (all of them -- a raised exception acks
        nothing the WAL didn't already make recoverable).

        Upsert semantics: an id already live is replaced (its old copy is
        tombstoned); duplicate ids within one call resolve last-wins.
        Empty docs are legal (they solve to distance 0, exactly as in a
        one-shot build). Validation happens BEFORE the WAL append so a
        rejected call leaves neither log nor state behind."""
        if len(ids) != len(docs):
            raise ValueError(f"{len(ids)} ids but {len(docs)} docs")
        ids_c = [int(i) for i in ids]
        docs_c = []
        for d in docs:
            doc = [(int(w), float(c)) for w, c in d]
            for w, c in doc:
                if not 0 <= w < self.num_vocab:
                    raise ValueError(f"word id {w} outside vocab "
                                     f"[0, {self.num_vocab})")
                if not np.isfinite(c) or c < 0:
                    raise ValueError(f"bad count {c} for word {w}")
            docs_c.append(doc)
        rec = {"op": "add", "ids": ids_c,
               "docs": [[[w, c] for w, c in d] for d in docs_c]}
        with self._lock:
            self._wal.append(rec)
            # the append returned => fsynced => acked-and-recoverable
            self._apply_add(ids_c, docs_c)
            if self._compacting:     # re-logged into the next generation's
                self._pending.append(rec)    # WAL at swap (see compact())
            return len(ids_c)

    def remove_docs(self, ids: Sequence[int]) -> int:
        """Durable remove; returns how many ids were actually live.
        Removing a never-added id is a durable no-op (logged, replayed,
        still a no-op) -- idempotence keeps WAL replay trivially safe."""
        ids_c = [int(i) for i in ids]
        rec = {"op": "remove", "ids": ids_c}
        with self._lock:
            self._wal.append(rec)
            removed = self._apply_remove(ids_c)
            if self._compacting:
                self._pending.append(rec)
            return removed

    def compact(self) -> None:
        """Merge the delta into a fresh rebuilt base: an interruptible job
        with an atomic segment swap (see the module docstring). Safe to
        call from a background thread; killed anywhere, the old segments
        stay live and a retry is idempotent.

        The corpus lock is held only for two short windows -- capturing
        the doc set at ``compact.begin`` and the WAL-rotation + in-memory
        swap at the end -- NOT across the O(docs) segment rebuild or the
        snapshot write/fsync between them. Readers and writers proceed
        against the old segments throughout the build; writes landing
        then are applied normally (and WAL-acked in the old generation)
        and additionally buffered, then at swap time re-logged fsynced
        into the new generation's WAL *before* the generation bump and
        re-applied onto the rebuilt base -- exactly the state recovery
        would produce from snapshot + logs. Until a buffered record lands
        in the new log it remains covered by the old one (recovery
        replays every surviving WAL generation ascending), so no
        acknowledged write is ever orphaned by a crash mid-swap.
        Compactions serialize among themselves on ``_compact_lock``."""
        with self._compact_lock:
            with self._lock:
                t0 = time.perf_counter()
                self._boundary("compact.begin", docs=len(self._docs))
                ids = sorted(self._docs)
                docs = [list(self._docs[i]) for i in ids]
                self._compacting = True
                self._pending = []
            self._observe_hold(t0)
            try:
                self._boundary("compact.built")
                new_gen = self.gen + 1
                self._write_snapshot(new_gen, ids, docs)
                # the rename landed: generation new_gen is durable.
                # Everything below is WAL rotation + in-memory swap; a
                # crash anywhere here recovers to new_gen plus every
                # surviving log -- the same logical corpus.
                with self._lock:
                    t0 = time.perf_counter()
                    self._boundary("compact.renamed")
                    pending = self._pending
                    old_wal = self._wal
                    self._wal = wal_mod.WalWriter(self._wal_path(new_gen),
                                                  hook=self._hook,
                                                  tracer=self._tracer)
                    for rec in pending:      # re-log build-window writes
                        self._wal.append(rec)
                    old_wal.close()
                    self.gen = new_gen
                    # rebuild exactly what recovery would produce: base =
                    # the snapshot's docs, delta = the re-applied pending
                    self._docs = {int(i): list(d)
                                  for i, d in zip(ids, docs)}
                    self._install_base()
                    for rec in pending:
                        if rec["op"] == "add":
                            self._apply_add(rec["ids"], rec["docs"])
                        else:
                            self._apply_remove(rec["ids"])
                    self._boundary("compact.done")
                self._observe_hold(t0)
            finally:
                with self._lock:
                    self._compacting = False
                    self._pending = []
            self._gc(keep_gen=self.gen)

    def _gc(self, keep_gen: int) -> None:
        for name in os.listdir(self.path):
            full = os.path.join(self.path, name)
            try:
                if name.endswith(".tmp"):
                    shutil.rmtree(full, ignore_errors=True)
                elif name.startswith("snapshot_"):
                    if int(name.split("_")[1]) < keep_gen:
                        shutil.rmtree(full, ignore_errors=True)
                elif name.startswith("wal_"):
                    if int(name.split("_")[1].split(".")[0]) < keep_gen:
                        os.remove(full)
            except (ValueError, OSError):
                continue             # foreign / already-gone files: skip

    def close(self) -> None:
        with self._lock:
            self._wal.close()

    def __enter__(self) -> "LiveCorpus":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- read API (what the service's refresh consumes) -------------------

    @property
    def num_live(self) -> int:
        return len(self._docs)

    @property
    def base_ell(self) -> formats.EllDocs:
        return self._base_ell

    @property
    def delta_ell(self) -> formats.EllDocs:
        """Copy of the delta segment as an EllDocs (copied so the device
        refresh can never alias a row a concurrent writer rewrites)."""
        with self._lock:
            return formats.EllDocs(cols=self._dcols.copy(),
                                   vals=self._dvals.copy(),
                                   num_vocab=self.num_vocab)

    def live_ids(self) -> np.ndarray:
        with self._lock:
            return np.array(sorted(self._docs), np.int64)

    def locations(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(ids, segment, row) aligned arrays in ascending doc-id order --
        the result-gather map: live column j of a query answer is
        ``d_segment[segment[j]][:, row[j]]``."""
        with self._lock:
            ids = sorted(self._docs)
            seg = np.array([self._where[i][0] for i in ids], np.int8)
            row = np.array([self._where[i][1] for i in ids], np.int64)
            return np.array(ids, np.int64), seg, row

    def live_empty_mask(self) -> np.ndarray:
        """Per live doc (ascending id): is it legitimately massless (empty
        or all-zero counts)? Such docs solve to exact distance 0, which the
        numeric guards must not mistake for lambda underflow."""
        with self._lock:
            return np.array([sum(c for _, c in self._docs[i]) == 0
                             for i in sorted(self._docs)], bool)

    def live_docs(self) -> list[tuple[int, Doc]]:
        """(id, raw doc) pairs ascending -- what a one-shot rebuild (and
        the incremental == batch tests) consume."""
        with self._lock:
            return [(i, list(self._docs[i])) for i in sorted(self._docs)]

    def stats(self) -> dict:
        with self._lock:
            wal_path = self._wal_path(self.gen)
            return {"gen": self.gen, "num_live": self.num_live,
                    "base_rows": self._base_ell.num_docs,
                    "delta_rows": self._dlen,
                    "delta_capacity": int(self._dcols.shape[0]),
                    "delta_nnz_max": int(self._dcols.shape[1]),
                    "version": self.version,
                    "base_version": self.base_version,
                    "compacting": self._compacting,
                    "wal_bytes": (os.path.getsize(wal_path)
                                  if os.path.exists(wal_path) else 0)}
