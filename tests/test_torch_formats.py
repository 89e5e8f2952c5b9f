"""Host-side data path of the port against the JAX package, exactly: ELL
formats, the synthetic corpus and query stream, query selection and
padding (same inputs -> same bits)."""
import jax  # noqa: F401  (JAX stays on the CPU here)
import numpy as np
import pytest
import torch

from repro.core import formats as jf
from repro.core import select_query as j_select_query
from repro.core.distributed import pad_query as j_pad_query
from repro.core.distributed import pad_query_batch as j_pad_query_batch
from repro.data import corpus as jc
from repro_torch.core import formats as tf
from repro_torch.core.distributed import pad_query, pad_query_batch
from repro_torch.core.sinkhorn import select_query
from repro_torch.data import corpus as tc


def _dense(seed=0, v=96, n=24):
    rng = np.random.default_rng(seed)
    c = np.zeros((v, n), np.float32)
    for j in range(n):
        idx = rng.choice(v, rng.integers(1, 12), replace=False)
        c[idx, j] = rng.random(idx.size).astype(np.float32)
    c[:, 3] = 0.0                                    # one empty doc
    return c


def _same_ell(a, b):
    np.testing.assert_array_equal(a.cols, b.cols)
    np.testing.assert_array_equal(a.vals, b.vals)
    assert a.cols.dtype == b.cols.dtype and a.vals.dtype == b.vals.dtype
    assert a.num_vocab == b.num_vocab


@pytest.mark.parametrize("align", [1, 8])
def test_ell_builders_match(align):
    c = _dense()
    _same_ell(tf.ell_from_dense(c, nnz_align=align),
              jf.ell_from_dense(c, nnz_align=align))
    docs = [[(int(i), float(c[i, j])) for i in np.nonzero(c[:, j])[0]]
            for j in range(c.shape[1])]
    _same_ell(tf.ell_from_doc_lists(docs, c.shape[0], nnz_align=align),
              jf.ell_from_doc_lists(docs, c.shape[0], nnz_align=align))


def test_ell_properties_and_dense_roundtrip():
    c = _dense(1)
    t, j = tf.ell_from_dense(c), jf.ell_from_dense(c)
    assert (t.num_docs, t.nnz_max, t.nnz) == (j.num_docs, j.nnz_max, j.nnz)
    assert t.pad_waste == j.pad_waste
    np.testing.assert_array_equal(t.to_dense(), j.to_dense())


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_rebucket_for_vocab_shards_matches(shards):
    ell = jf.ell_from_dense(_dense(2))
    t = tf.rebucket_for_vocab_shards(tf.ell_from_dense(_dense(2)), shards)
    _same_ell(t, jf.rebucket_for_vocab_shards(ell, shards))
    if shards == 1:
        assert t.cols.shape[0] == 1      # the leading S = 1 shard axis


def test_pad_docs_matches():
    c = _dense(3)
    _same_ell(tf.pad_docs(tf.ell_from_dense(c), 30),
              jf.pad_docs(jf.ell_from_dense(c), 30))


def test_make_corpus_matches_bitwise():
    kw = dict(vocab_size=600, embed_dim=12, num_docs=20, num_queries=3,
              seed=7)
    t, j = tc.make_corpus(**kw), jc.make_corpus(**kw)
    np.testing.assert_array_equal(t.vecs, j.vecs)
    _same_ell(t.ell, j.ell)
    assert t.nnz == j.nnz
    for a, b in zip(t.queries, j.queries):
        np.testing.assert_array_equal(a, b)


def test_zipf_query_stream_matches():
    ts = tc.zipf_query_stream(vocab_size=512, seed=3)
    js = jc.zipf_query_stream(vocab_size=512, seed=3)
    for _ in range(6):
        np.testing.assert_array_equal(next(ts), next(js))


def test_select_query_and_padding_match():
    rng = np.random.default_rng(4)
    rs = []
    for i in range(3):
        r = np.zeros(64, np.float32)
        r[rng.choice(64, 3 + 2 * i, replace=False)] = rng.random(3 + 2 * i)
        rs.append(r)
    sels = []
    for r in rs:
        (s, rr), (js, jrr) = select_query(r), j_select_query(r)
        np.testing.assert_array_equal(s, js)
        np.testing.assert_array_equal(rr, jrr)
        assert s.dtype == js.dtype and rr.dtype == jrr.dtype
        sels.append((s, rr))
        for a, b in zip(pad_query(s, rr, 10), j_pad_query(js, jrr, 10)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    got = pad_query_batch([s for s, _ in sels], [r for _, r in sels], 12)
    want = j_pad_query_batch([s for s, _ in sels], [r for _, r in sels], 12)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    with pytest.raises(ValueError):
        pad_query(sels[-1][0], sels[-1][1], 2)


def test_state_from_numpy_copies_bits():
    from repro_torch.convert import state_from_numpy
    data = jc.make_corpus(vocab_size=600, embed_dim=8, num_docs=6,
                          num_queries=1, seed=1)
    st = state_from_numpy(data.vecs, data.ell.cols, data.ell.vals,
                          data.ell.num_vocab, device="cpu")
    assert st.vecs.device == torch.device("cpu")
    np.testing.assert_array_equal(st.vecs.numpy(), data.vecs)
    _same_ell(st.ell, data.ell)
    with pytest.raises(ValueError):
        state_from_numpy(data.vecs, data.ell.cols, data.ell.vals, 5,
                         device="cpu")
