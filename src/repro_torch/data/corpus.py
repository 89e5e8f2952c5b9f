"""Synthetic dbpedia-like corpus generator for the Sinkhorn-WMD workload.

A numpy copy of `repro.data.corpus`: the same seed draws the same numbers
in the same order, so both packages build bit-identical corpora.

The paper's dataset is private-ish (kaggle mirrors of crawl-300d-2M +
dbpedia.train); this generator reproduces its *statistics* deterministically:
  * vocab V = 100k, embedding width w = 300 (f32),
  * doc lengths ~ lognormal matched to nnz/doc ~ 35 median (so that 5000 docs
    give nnz ~ 173k, density ~0.0035% -- the paper's numbers),
  * word ids ~ Zipf (s ~ 1.07), frequencies normalized per doc,
  * query docs with v_r ~ 19 words (the paper's running example).

Embeddings are unit-ish gaussian scaled so pairwise distances land in the
1-10 range of real word2vec clouds (keeps exp(-lambda*M) in f32 range at the
paper's lambda).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.formats import EllDocs, ell_from_doc_lists


@dataclasses.dataclass(frozen=True)
class WMDData:
    vecs: np.ndarray          # (V, w) f32
    ell: EllDocs              # target docs
    queries: list[np.ndarray]  # list of (V,) sparse frequency vectors
    nnz: int


def zipf_ids(rng: np.random.Generator, n: int, vocab: int,
             s: float = 1.07) -> np.ndarray:
    """Zipf-distributed distinct word ids."""
    # rejection-free: sample with replacement then dedup, top up as needed
    ids: set[int] = set()
    while len(ids) < n:
        draw = rng.zipf(s, size=2 * n)
        ids.update(int(x) - 1 for x in draw if x <= vocab)
    return np.fromiter(list(ids)[:n], dtype=np.int64)


def zipf_query_stream(*, vocab_size: int, query_words: int = 19,
                      s: float = 1.07, seed: int = 0):
    """Infinite seeded generator of Zipf-skewed (V,) query histograms.

    The realistic serving workload in one line: successive queries draw
    their word ids from the same Zipf(s) head, so most ids repeat across
    queries -- exactly the redundancy the cross-query K cache
    (`core.kcache`) exploits. Shared by `benchmarks/bench_query_batch.py
    --zipf` and the cache tests; take Q-sized batches with
    ``[next(stream) for _ in range(q)]`` (or itertools.islice).

    Args:
      vocab_size:  V (ids above it are rejected, as in `zipf_ids`).
      query_words: distinct nonzero words per query (the paper's v_r ~ 19).
      s:           Zipf exponent; larger = heavier head = higher hit rates.
      seed:        stream is fully determined by (seed, s, query_words, V).
    """
    rng = np.random.default_rng(seed)
    while True:
        r = np.zeros(vocab_size, np.float32)
        ids = zipf_ids(rng, query_words, vocab_size, s=s)
        freq = rng.integers(1, 4, size=query_words).astype(np.float32)
        r[ids] = freq / freq.sum()
        yield r


def make_corpus(*, vocab_size: int = 100_000, embed_dim: int = 300,
                num_docs: int = 5_000, num_queries: int = 10,
                mean_words: float = 35.0, query_words: int = 19,
                nnz_align: int = 8, seed: int = 0) -> WMDData:
    rng = np.random.default_rng(seed)
    vecs = rng.normal(scale=1.3, size=(vocab_size, embed_dim)) \
        .astype(np.float32)

    docs = []
    total_nnz = 0
    sigma = 0.55
    mu = np.log(mean_words) - sigma ** 2 / 2
    for _ in range(num_docs):
        n_words = int(np.clip(rng.lognormal(mu, sigma), 3, 4 * mean_words))
        ids = zipf_ids(rng, n_words, vocab_size)
        counts = rng.integers(1, 4, size=n_words).astype(np.float64)
        docs.append(list(zip(ids.tolist(), counts.tolist())))
        total_nnz += n_words
    ell = ell_from_doc_lists(docs, vocab_size, nnz_align=nnz_align)

    queries = []
    for _ in range(num_queries):
        r = np.zeros(vocab_size, np.float32)
        ids = zipf_ids(rng, query_words, vocab_size)
        freq = rng.integers(1, 4, size=query_words).astype(np.float32)
        r[ids] = freq / freq.sum()
        queries.append(r)
    return WMDData(vecs=vecs, ell=ell, queries=queries, nnz=total_nnz)
