"""Sparse matrix formats for the Sinkhorn-WMD document-frequency matrix ``c``.

A numpy copy of `repro.core.formats` (the port imports nothing of the JAX
package); same builders, same bits for the same input.

The paper stores ``c`` (vocab_size x num_docs, density ~3.5e-5) as CSR and
partitions its *nonzeros* equally across threads with a binary search into the
row pointer (their "2-D partitioning"). The accelerator kernels want fixed
per-doc work instead, so ``c`` is stored as a **doc-major padded ELL**:

    cols : (num_docs, nnz_max) int32  word-ids, padded with ``pad_id == V``
    vals : (num_docs, nnz_max) f32    normalized counts, padded with 0.0

Fixed-shape doc tiles give equal work per tile *by construction* -- the moral
equivalent of equal-nnz partitioning -- and the pad id points at an appended
all-zero column of K so padding lanes contribute exactly 0 without branches.

``rebucket_for_vocab_shards`` produces the per-shard ELL used by the
distributed engine: shard ``s`` keeps only the nonzeros whose word-id falls in
its vocab stripe, with ids localized; this is how "a word's K column lives
with its nonzero" is realized.

Host-side construction uses numpy (data prep); `repro_torch.convert` moves
the arrays to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class EllDocs:
    """Doc-major padded ELL view of the (V x N) document-frequency matrix."""

    cols: np.ndarray  # (N, nnz_max) int32, pad = num_vocab
    vals: np.ndarray  # (N, nnz_max) f32, pad = 0.0
    num_vocab: int    # V (pad id == num_vocab)

    @property
    def num_docs(self) -> int:
        return self.cols.shape[0]

    @property
    def nnz_max(self) -> int:
        return self.cols.shape[1]

    @property
    def nnz(self) -> int:
        return int((self.vals != 0.0).sum())

    @property
    def pad_waste(self) -> float:
        """Fraction of slots that are padding (the ELL regularity tax)."""
        total = self.cols.size
        return 1.0 - self.nnz / total if total else 0.0

    def to_dense(self) -> np.ndarray:
        """(V, N) dense reconstruction -- test/oracle use only."""
        dense = np.zeros((self.num_vocab, self.num_docs), dtype=self.vals.dtype)
        for j in range(self.num_docs):
            live = self.vals[j] != 0.0
            np.add.at(dense[:, j], self.cols[j][live], self.vals[j][live])
        return dense


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def ell_from_dense(c: np.ndarray, *, nnz_align: int = 8) -> EllDocs:
    """Build ELL from a dense (V, N) matrix. nnz_max rounds up to nnz_align."""
    v, n = c.shape
    per_doc = (c != 0.0).sum(axis=0)
    nnz_max = max(int(per_doc.max(initial=0)), 1)
    nnz_max = _round_up(nnz_max, nnz_align)
    cols = np.full((n, nnz_max), v, dtype=np.int32)
    vals = np.zeros((n, nnz_max), dtype=np.float32)
    for j in range(n):
        (idx,) = np.nonzero(c[:, j])
        cols[j, : idx.size] = idx
        vals[j, : idx.size] = c[idx, j]
    return EllDocs(cols=cols, vals=vals, num_vocab=v)


def ell_from_csc(indptr: np.ndarray, indices: np.ndarray, values: np.ndarray,
                 num_vocab: int, *, nnz_align: int = 8) -> EllDocs:
    """Build ELL from CSC of the (V, N) matrix (per-doc column slices).

    This is the ingest path from the paper's dataset: documents arrive as
    (word-id, count) lists, i.e. exactly CSC columns of ``c``.
    """
    n = indptr.size - 1
    per_doc = np.diff(indptr)
    nnz_max = max(int(per_doc.max(initial=0)), 1)
    nnz_max = _round_up(nnz_max, nnz_align)
    cols = np.full((n, nnz_max), num_vocab, dtype=np.int32)
    vals = np.zeros((n, nnz_max), dtype=np.float32)
    for j in range(n):
        lo, hi = int(indptr[j]), int(indptr[j + 1])
        cols[j, : hi - lo] = indices[lo:hi]
        vals[j, : hi - lo] = values[lo:hi]
    return EllDocs(cols=cols, vals=vals, num_vocab=num_vocab)


def ell_from_doc_lists(docs: Sequence[Sequence[tuple[int, float]]],
                       num_vocab: int, *, nnz_align: int = 8,
                       normalize: bool = True) -> EllDocs:
    """Build ELL straight from bag-of-words (word_id, count) documents."""
    n = len(docs)
    nnz_max = max(max((len(d) for d in docs), default=1), 1)
    nnz_max = _round_up(nnz_max, nnz_align)
    cols = np.full((n, nnz_max), num_vocab, dtype=np.int32)
    vals = np.zeros((n, nnz_max), dtype=np.float32)
    for j, doc in enumerate(docs):
        tot = sum(cnt for _, cnt in doc) if normalize else 1.0
        for k, (wid, cnt) in enumerate(doc):
            cols[j, k] = wid
            vals[j, k] = cnt / tot if normalize else cnt
    return EllDocs(cols=cols, vals=vals, num_vocab=num_vocab)


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1). The segment-capacity rule of the
    live corpus: padded row capacity grows in pow2 steps so the device
    program shapes stay stable between growth events."""
    return 1 << max(n - 1, 0).bit_length()


def write_doc_row(cols: np.ndarray, vals: np.ndarray, row: int,
                  doc: Sequence[tuple[int, float]], num_vocab: int, *,
                  normalize: bool = True) -> None:
    """Write one bag-of-words doc into row ``row`` of preallocated ELL
    arrays, in place, clearing the remainder of the row to padding.

    The normalization arithmetic is *identical* to `ell_from_doc_lists`
    (python-float total, same accumulation order, same f32 cast), so a doc
    written incrementally lands bit-for-bit equal to the same doc in a
    one-shot build -- the foundation of the live corpus's incremental ==
    batch contract. Duplicate word-ids within one doc occupy separate
    slots, exactly as the one-shot builders store them (the engine sums
    slot contributions, so duplicates are equivalent to a merged count,
    though not bitwise so -- which is why both paths store them unmerged).
    """
    if len(doc) > cols.shape[1]:
        raise ValueError(f"doc nnz {len(doc)} exceeds row width "
                         f"{cols.shape[1]}")
    cols[row, :] = num_vocab
    vals[row, :] = 0.0
    tot = sum(cnt for _, cnt in doc) if normalize else 1.0
    for k, (wid, cnt) in enumerate(doc):
        cols[row, k] = wid
        vals[row, k] = cnt / tot if normalize else cnt


def ell_with_capacity(ell: EllDocs, capacity: int, *,
                      nnz_max: int | None = None) -> EllDocs:
    """Grow an ELL to ``capacity`` rows (and optionally a wider nnz_max),
    the new slots all padding. The live corpus's segment-growth primitive:
    unlike `pad_docs` this may also widen the nnz axis, so a delta segment
    can absorb a doc longer than anything it has seen."""
    nz = ell.nnz_max if nnz_max is None else nnz_max
    if capacity < ell.num_docs:
        raise ValueError(f"cannot shrink: {capacity} < {ell.num_docs}")
    if nz < ell.nnz_max:
        raise ValueError(f"cannot narrow: {nz} < {ell.nnz_max}")
    if capacity == ell.num_docs and nz == ell.nnz_max:
        return ell
    cols = np.full((capacity, nz), ell.num_vocab, np.int32)
    vals = np.zeros((capacity, nz), np.float32)
    cols[:ell.num_docs, :ell.nnz_max] = ell.cols
    vals[:ell.num_docs, :ell.nnz_max] = ell.vals
    return EllDocs(cols=cols, vals=vals, num_vocab=ell.num_vocab)


def doc_lists_from_ell(ell: EllDocs) -> list[list[tuple[int, float]]]:
    """Recover bag-of-words (word_id, weight) docs from an ELL (pad slots
    dropped; empty/pad rows come back as empty docs). The ingest bridge:
    a frozen corpus built by `make_corpus` feeds a live corpus through
    this (with normalize=False -- the weights are already normalized)."""
    docs = []
    for j in range(ell.num_docs):
        live = ell.vals[j] != 0.0
        docs.append(list(zip(ell.cols[j][live].tolist(),
                             ell.vals[j][live].tolist())))
    return docs


def pad_docs(ell: EllDocs, num_docs: int) -> EllDocs:
    """Pad the doc axis to ``num_docs`` with empty documents (for even shards)."""
    if num_docs < ell.num_docs:
        raise ValueError(f"cannot shrink: {num_docs} < {ell.num_docs}")
    if num_docs == ell.num_docs:
        return ell
    extra = num_docs - ell.num_docs
    cols = np.concatenate(
        [ell.cols, np.full((extra, ell.nnz_max), ell.num_vocab, np.int32)])
    vals = np.concatenate(
        [ell.vals, np.zeros((extra, ell.nnz_max), np.float32)])
    return EllDocs(cols=cols, vals=vals, num_vocab=ell.num_vocab)


@dataclasses.dataclass(frozen=True)
class BucketedEll:
    """Doc-length-bucketed ELL (beyond-paper optimization, EXPERIMENTS.md
    §Perf): one EllDocs per power-of-two length class, so nnz_max tracks the
    bucket's own maximum instead of the global tail.

    The lognormal doc-length distribution of the paper's corpus makes a
    single global nnz_max ~4x larger than the median doc (measured 4.15
    slots/nnz); bucketing cuts padded-slot work to ~1.3 slots/nnz. The
    solver runs per bucket (equal-shape tiles inside each bucket keep the
    equal-work property); ``doc_ids`` maps bucket-local rows back to corpus
    order.
    """

    buckets: tuple[EllDocs, ...]
    doc_ids: tuple[np.ndarray, ...]   # original doc index per bucket row
    num_vocab: int

    @property
    def nnz(self) -> int:
        return sum(b.nnz for b in self.buckets)

    @property
    def total_slots(self) -> int:
        return sum(b.cols.size for b in self.buckets)

    def scatter(self, per_bucket: Sequence[np.ndarray],
                num_docs: int) -> np.ndarray:
        """Reassemble per-bucket (N_b,) results into corpus order."""
        out = np.zeros(num_docs, dtype=per_bucket[0].dtype)
        for ids, vals in zip(self.doc_ids, per_bucket):
            out[ids] = vals[: len(ids)]
        return out


def bucket_by_length(ell: EllDocs, *, nnz_align: int = 8,
                     min_bucket: int = 8) -> BucketedEll:
    """Split docs into power-of-two length classes with per-class nnz_max."""
    lengths = (ell.vals != 0.0).sum(axis=1)
    edges: list[int] = []
    b = max(min_bucket, nnz_align)
    while b < ell.nnz_max:
        edges.append(b)
        b *= 2
    edges.append(max(int(lengths.max(initial=1)), 1))
    buckets, ids = [], []
    lo = 0
    for hi in edges:
        (sel,) = np.nonzero((lengths > lo) & (lengths <= hi))
        lo = hi
        if sel.size == 0:
            continue
        nnz_b = _round_up(hi, nnz_align)
        cols = ell.cols[sel][:, :nnz_b].copy()
        vals = ell.vals[sel][:, :nnz_b].copy()
        # slots beyond nnz_b are guaranteed padding for this bucket
        buckets.append(EllDocs(cols=cols, vals=vals,
                               num_vocab=ell.num_vocab))
        ids.append(sel)
    return BucketedEll(buckets=tuple(buckets), doc_ids=tuple(ids),
                       num_vocab=ell.num_vocab)


def rebucket_for_vocab_shards(ell: EllDocs, num_shards: int,
                              *, nnz_align: int = 8) -> EllDocs:
    """Re-bucket per vocab stripe for `model`-axis sharding.

    Returns an EllDocs whose arrays carry a leading shard axis folded into
    shape (num_shards, N, nnz_max_shard): shard ``s`` holds only nonzeros with
    word-id in [s*Vs, (s+1)*Vs), ids localized to the stripe, pad id == Vs.
    The result is fed to shard_map with the leading axis mapped to `model`.
    """
    if ell.num_vocab % num_shards:
        raise ValueError(
            f"vocab {ell.num_vocab} not divisible by shards {num_shards}")
    vs = ell.num_vocab // num_shards
    n = ell.num_docs
    shard_of = ell.cols // vs  # pads map to shard num_shards (out of range)
    # worst-case nnz per (shard, doc)
    nnz_shard = 1
    for s in range(num_shards):
        per_doc = ((shard_of == s) & (ell.vals != 0.0)).sum(axis=1)
        nnz_shard = max(nnz_shard, int(per_doc.max(initial=0)))
    nnz_shard = _round_up(nnz_shard, nnz_align)
    cols = np.full((num_shards, n, nnz_shard), vs, dtype=np.int32)
    vals = np.zeros((num_shards, n, nnz_shard), dtype=np.float32)
    for s in range(num_shards):
        for j in range(n):
            live = (shard_of[j] == s) & (ell.vals[j] != 0.0)
            k = int(live.sum())
            cols[s, j, :k] = ell.cols[j][live] - s * vs
            vals[s, j, :k] = ell.vals[j][live]
    return EllDocs(cols=cols, vals=vals, num_vocab=vs)
