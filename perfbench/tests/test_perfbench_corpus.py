"""The vectorized generator keeps the statistics of the program's own
generator, and the same seed gives the same data."""
import numpy as np
import torch

import perfbench_tiny  # noqa: F401  (paths)
from perfbench import corpus


def _make(seed, docs=2000):
    return corpus.make_corpus(seed=seed, device="cpu", vocab_size=5000,
                              embed_dim=8, num_docs=docs, mean_words=35.0,
                              zipf_s=1.07, nnz_align=8, doc_block=700)


def test_same_seed_same_corpus_and_large_seeds():
    seed = 2 ** 31 + 12345
    a, b = _make(seed), _make(seed)
    assert np.array_equal(a.cols, b.cols) and np.array_equal(a.vals, b.vals)
    assert torch.equal(a.vecs, b.vecs)
    c = _make(seed + 1)
    assert not np.array_equal(a.cols, c.cols)


def test_doc_statistics():
    c = _make(7, docs=4000)
    n = c.lengths
    assert n.min() >= 3 and n.max() <= 140
    assert 32.0 < n.mean() < 38.0               # lognormal, mean 35
    assert c.cols.shape[1] % 8 == 0
    live = c.vals != 0
    assert np.array_equal(live.sum(1), n)
    np.testing.assert_allclose(c.vals.sum(1), 1.0, rtol=1e-5)
    assert np.all(c.cols[~live] == 5000)
    for j in range(0, 4000, 97):                 # distinct ids in a doc
        ids = c.cols[j][live[j]]
        assert np.unique(ids).size == ids.size
    # Zipf(1.07): word 0 is the most frequent, in about 1 doc in 3 or more
    counts = np.bincount(c.cols[live].ravel(), minlength=5000)
    assert counts.argmax() == 0 and counts[0] > 4000 / 3
    assert counts[0] > counts[10] > counts[1000]
    assert abs(float(c.vecs.std()) - 1.3) < 0.05


def test_query_pool():
    p = corpus.make_queries(seed=3, device="cpu", vocab_size=5000, n=300,
                            words=19, zipf_s=1.07)
    assert p.ids.shape == (300, 19)
    assert all(np.unique(r).size == 19 for r in p.ids)
    np.testing.assert_allclose(p.weights.sum(1), 1.0, rtol=1e-6)
    assert np.all(p.weights > 0)


def test_dense_rows_clear_what_they_held():
    rows = corpus.DenseRows(2, 50)
    a = rows.put(0, np.array([1, 2]), np.array([0.5, 0.5], np.float32))
    assert a.sum() == 1.0
    b = rows.put(0, np.array([7]), np.array([1.0], np.float32))
    assert b[1] == 0 and b[2] == 0 and b[7] == 1.0 and b.sum() == 1.0
