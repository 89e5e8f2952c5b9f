"""The least time a batch's Sinkhorn-WMD solve can take on an H100, from
the problem alone, whatever implements it.

Frozen yardstick: it counts what the algorithm needs for these inputs, not
what today's kernels move, so a later change that reads less or fuses more
can approach it but never read past it.

Bytes, each input read once and each output written once:
  * K and K .* M: for each real query word (pad rows excluded), the
    columns of the corpus's distinct words, float32;
  * the ELL: each real nonzero's word id (int32) and weight (float32);
  * r: one float32 a real query word;
  * the (Q, N) distances, float32.
Operations (add, multiply, divide and reciprocal each one), for a query
of v real words:
  * each of the ``max_iter`` iterations: at every nonzero slot, v
    multiply-adds for K^T u, one divide for v, v multiply-adds for K v;
    at every (word, doc), one reciprocal for u (the 1/r scale can be
    folded into K, so it is not counted);
  * the distance: at every nonzero slot, v multiply-adds for K^T u, one
    divide, v multiply-adds for (K .* M) v and one multiply-add of u
    folded in per word; at every (word, doc), one reciprocal.

On a mesh that shards the documents, each card solves the doc shards it
holds (contiguous docs in doc order, as `doc_shards` splits them) for
every query: a card's work is the count above for its docs, their
nonzeros and the distinct words they use (a card reads only the K columns
of its own docs), and the batch's least time is its slowest card's at one
H100's peaks (`slowest`). With one doc shard, or every shard on one card,
that is the whole problem's count. A mesh that also splits the vocabulary
over model shards gets no count here (each card would hold part of every
document's words, and the split sum would have to be counted too), so the
harness takes no solve reading there and ``solve_roofline`` reads
nothing.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, outside the tensor cores
PEAK_FLOPS_FP32 = 67e12
PEAK_BYTES_S = 3.35e12


def solve_work(*, words: list[int], num_docs: int, nnz: int,
               distinct_words: int, max_iter: int) -> dict:
    """Operations and bytes of one batch's solve: ``words`` the real word
    count of each query, ``nnz`` the corpus's nonzero slots,
    ``distinct_words`` the number of distinct word ids among them."""
    rows = sum(words)
    flops = 0
    for v in words:
        per_iter = nnz * (4 * v + 1) + v * num_docs
        final = nnz * (4 * v + 1) + 3 * v * num_docs
        flops += max_iter * per_iter + final
    nbytes = (2 * rows * distinct_words * 4      # K, K .* M columns
              + nnz * 8                          # ELL ids and weights
              + rows * 4                         # r
              + len(words) * num_docs * 4)       # distances out
    return {"flops": flops, "bytes": nbytes}


def least_seconds(work: dict) -> tuple[float, str]:
    """The larger of the compute and memory times, and which it is."""
    t_c = work["flops"] / PEAK_FLOPS_FP32
    t_m = work["bytes"] / PEAK_BYTES_S
    return (t_c, "operations") if t_c >= t_m else (t_m, "bytes")


def doc_shards(num_docs: int, parts: int) -> list[tuple[int, int]]:
    """Contiguous (lo, hi) doc ranges of ``parts`` doc shards, in order,
    the first ``num_docs % parts`` one doc larger (the service's split,
    `repro_torch.core.distributed.shard_docs`)."""
    out, lo = [], 0
    for i in range(parts):
        hi = lo + num_docs // parts + (i < num_docs % parts)
        out.append((lo, hi))
        lo = hi
    return out


def slowest(works: list[dict]) -> tuple[float, str, int]:
    """`least_seconds` of the card whose work (one `solve_work` a card)
    takes longest, and its index: the batch ends when that card does."""
    times = [least_seconds(w) for w in works]
    i = max(range(len(times)), key=lambda j: times[j][0])
    return (*times[i], i)
