"""Seeded synthetic WMD data, generated in bulk on the device.

A vectorized copy of the statistics of `repro_torch/data/corpus.py` (the
program's own generator loops per doc in Python, which is far too slow at a
million documents). Frozen here so that a later change to the program
cannot move the benchmark's inputs:

  * embeddings: (V, w) float32, normal with scale 1.3;
  * doc lengths: lognormal with mean ``mean_words`` (sigma 0.55, so the
    median is ~0.86 of it), truncated to an integer and clipped to
    [3, 4 * mean_words];
  * word ids: Zipf(s) over 1..V (ids above V are rejected in the original,
    which is the truncated Zipf sampled here by inverse CDF), distinct
    within a doc: the first ``n`` distinct ids of a stream of draws;
  * counts: integers 1..3, normalized per doc in float64, stored float32;
  * queries: ``query_words`` distinct Zipf ids with weights 1..3,
    normalized in float32.

Everything is drawn from one `torch.Generator` seeded with ``--seed`` on
the device the data is made on, in a fixed order, so the same seed on the
same device gives the same data.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

SIGMA = 0.55          # lognormal shape of the doc lengths
EMBED_SCALE = 1.3     # std of the embedding coordinates
# Zipf draws a row first takes its distinct ids from (doubled for a row
# that holds too few): ~250 distinct ids expected in 512 draws, against
# docs of at most 140 words; ~80 in 128, against queries of 19
DOC_DRAWS = 512
QUERY_DRAWS = 128


@dataclasses.dataclass
class Corpus:
    vecs: torch.Tensor        # (V, w) float32 on the device
    cols: np.ndarray          # (N, nnz_max) int32, pad id == V
    vals: np.ndarray          # (N, nnz_max) float32, pad 0.0
    lengths: np.ndarray       # (N,) words a doc


def generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def zipf_cdf(vocab: int, s: float, device) -> torch.Tensor:
    """Cumulative weights of the Zipf(s) law truncated to ids 1..vocab,
    normalized to end at 1 (float64)."""
    k = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    c = torch.cumsum(k.pow(-s), 0)
    return c / c[-1]


def zipf_draws(g: torch.Generator, cdf: torch.Tensor, shape) -> torch.Tensor:
    """Word ids (0-based) drawn from the truncated Zipf law of ``cdf``."""
    u = torch.rand(shape, generator=g, dtype=torch.float64,
                   device=cdf.device)
    return torch.searchsorted(cdf, u, right=True).clamp_(max=cdf.numel() - 1)


def first_distinct(draws: torch.Tensor, n_max: int):
    """Per row of ``draws`` (B, D): the first ``n_max`` distinct values in
    draw order, and how many distinct values the row holds."""
    d = draws.shape[1]
    vals, perm = torch.sort(draws, dim=1, stable=True)
    first = torch.ones_like(vals, dtype=torch.bool)
    first[:, 1:] = vals[:, 1:] != vals[:, :-1]
    pos = torch.where(first, perm, torch.full_like(perm, d))
    pos, _ = torch.sort(pos, dim=1)
    pos = pos[:, :n_max]
    ids = torch.gather(draws, 1, pos.clamp(max=d - 1))
    return ids, first.sum(dim=1)


def distinct_zipf_rows(g: torch.Generator, cdf: torch.Tensor,
                       lengths: torch.Tensor, n_max: int,
                       draws: int) -> torch.Tensor:
    """(B, n_max) int64 rows of distinct Zipf ids; row j holds
    ``lengths[j]`` ids (the rest of the row is -1). A row whose draws hold
    too few distinct ids is drawn again with twice as many draws."""
    b = lengths.shape[0]
    out = torch.full((b, n_max), -1, dtype=torch.int64, device=cdf.device)
    todo = torch.arange(b, device=cdf.device)
    d = draws
    while todo.numel():
        ids, n_distinct = first_distinct(
            zipf_draws(g, cdf, (todo.numel(), d)), n_max)
        ok = n_distinct >= lengths[todo]
        done = todo[ok]
        out[done, :ids.shape[1]] = ids[ok]
        todo = todo[~ok]
        d *= 2
    slot = torch.arange(n_max, device=cdf.device)
    return torch.where(slot[None] < lengths[:, None], out, -1)


def make_corpus(*, seed: int, device, vocab_size: int, embed_dim: int,
                num_docs: int, mean_words: float, zipf_s: float,
                nnz_align: int, doc_block: int = 65_536) -> Corpus:
    """Embeddings and the doc-major padded ELL of ``num_docs`` docs."""
    top = int(4 * mean_words)
    if vocab_size < top:
        raise ValueError(f"a vocabulary of {vocab_size} words cannot hold "
                         f"a doc of {top} distinct words")
    g = generator(device, seed)
    vecs = torch.randn((vocab_size, embed_dim), generator=g,
                       dtype=torch.float32, device=device) * EMBED_SCALE
    mu = math.log(mean_words) - SIGMA ** 2 / 2
    lengths = torch.exp(mu + SIGMA * torch.randn(
        num_docs, generator=g, dtype=torch.float64, device=device))
    lengths = lengths.clamp(3, top).floor().to(torch.int64)
    n_max = int(lengths.max())
    width = -(-n_max // nnz_align) * nnz_align
    cdf = zipf_cdf(vocab_size, zipf_s, device)
    cols = np.full((num_docs, width), vocab_size, np.int32)
    vals = np.zeros((num_docs, width), np.float32)
    for lo in range(0, num_docs, doc_block):
        ln = lengths[lo:lo + doc_block]
        ids = distinct_zipf_rows(g, cdf, ln, n_max, DOC_DRAWS)
        counts = torch.randint(1, 4, ids.shape, generator=g,
                               device=device).to(torch.float64)
        live = ids >= 0
        counts = torch.where(live, counts, 0.0)
        w = (counts / counts.sum(dim=1, keepdim=True)).to(torch.float32)
        hi = lo + ln.shape[0]
        cols[lo:hi, :n_max] = torch.where(live, ids, vocab_size).to(
            torch.int32).cpu().numpy()
        vals[lo:hi, :n_max] = w.cpu().numpy()
    return Corpus(vecs=vecs, cols=cols, vals=vals,
                  lengths=lengths.cpu().numpy())


@dataclasses.dataclass
class QueryPool:
    """``n`` queries, each ``words`` distinct ids with their weights."""
    ids: np.ndarray           # (n, words) int64
    weights: np.ndarray       # (n, words) float32, each row sums to ~1

    def __len__(self) -> int:
        return self.ids.shape[0]


def make_queries(*, seed: int, device, vocab_size: int, n: int, words: int,
                 zipf_s: float) -> QueryPool:
    """A pool of Zipf(s) queries, drawn from a generator of its own (the
    corpus's seed, offset), so the pool does not depend on the corpus
    size."""
    g = generator(device, int(seed) + 0x5EED)
    cdf = zipf_cdf(vocab_size, zipf_s, device)
    lengths = torch.full((n,), words, dtype=torch.int64, device=device)
    ids = distinct_zipf_rows(g, cdf, lengths, words, QUERY_DRAWS)
    freq = torch.randint(1, 4, ids.shape, generator=g,
                         device=device).to(torch.float32)
    w = freq / freq.sum(dim=1, keepdim=True)
    return QueryPool(ids=ids.cpu().numpy(), weights=w.cpu().numpy())


class DenseRows:
    """Dense (V,) float32 histograms written into a ring of reused rows, so
    that a client hands the service the (V,) arrays its API takes without
    allocating and zeroing 400 KB a query. A row is rewritten only by
    `put`, which clears the ids it held before."""

    def __init__(self, rows: int, vocab_size: int):
        self.buf = np.zeros((rows, vocab_size), np.float32)
        self._held = [np.empty(0, np.int64)] * rows

    def put(self, row: int, ids: np.ndarray, weights: np.ndarray
            ) -> np.ndarray:
        r = self.buf[row]
        r[self._held[row]] = 0.0
        r[ids] = weights
        self._held[row] = ids
        return r
