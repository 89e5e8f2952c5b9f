"""The port's offline bulk-scoring mode (`repro_torch.serving.offline`) on
the CPU: the reference's query-file format in both directions, plain rows
bitwise the direct `query_batch` of the same bucket compositions, top-k
bitwise `top_k_batch(prune=True, rerank=...)` for both reranks (and the
scan), and `OfflineResult.save` round-tripping."""
import numpy as np
import pytest

import repro.serving.offline as ref_offline
from repro_torch.serving import (OfflineResult, load_query_file, run_offline,
                                 save_query_file)


@pytest.fixture(scope="module")
def stack():
    from repro_torch.configs.sinkhorn_wmd import WMDConfig
    from repro_torch.data import make_corpus
    from repro_torch.serving import WMDService
    cfg = WMDConfig(name="t-offline", vocab_size=192, embed_dim=16,
                    num_docs=32, nnz_max=32, v_r=8, lamb=1.0, max_iter=8)
    data = make_corpus(vocab_size=192, embed_dim=16, num_docs=32,
                       num_queries=12, query_words=6, mean_words=6.0,
                       seed=0)
    svc = WMDService(cfg=cfg, vecs=data.vecs, ell=data.ell, device="cpu",
                     cache_capacity=48, cache_rows_bucket=8, prune_chunk=8)
    return data, svc


@pytest.mark.parametrize("name", ["golden.npz", "golden.npy"])
def test_query_files_cross_between_packages(tmp_path, stack, name):
    qs = list(stack[0].queries[:5])
    for save, load in ((ref_offline.save_query_file, load_query_file),
                       (save_query_file, ref_offline.load_query_file)):
        path = save(tmp_path / name, qs)
        back = load(path)
        assert len(back) == 5
        for a, b in zip(qs, back):
            assert b.dtype == np.float32
            np.testing.assert_array_equal(np.asarray(a, np.float32), b)


def test_query_file_bytes_equal_reference(tmp_path, stack):
    qs = list(stack[0].queries[:3])
    save_query_file(tmp_path / "a.npy", qs)
    ref_offline.save_query_file(tmp_path / "b.npy", qs)
    assert (tmp_path / "a.npy").read_bytes() == \
        (tmp_path / "b.npy").read_bytes()


def test_bad_query_files_are_refused(tmp_path):
    np.savez(tmp_path / "bad.npz", a=np.zeros(3), b=np.zeros(3))
    np.save(tmp_path / "bad1d.npy", np.zeros(4, np.float32))
    np.savez(tmp_path / "one.npz", np.ones((2, 4), np.float32))
    for bad in ("bad.npz", "bad1d.npy"):
        with pytest.raises(ValueError):
            load_query_file(tmp_path / bad)
    assert len(load_query_file(tmp_path / "one.npz")) == 2


def test_offline_plain_bitwise_same_compositions(stack):
    data, svc = stack
    qs = list(data.queries[:10])             # 4 + 4 + 2 under max_batch=4
    off = run_offline(svc, qs, max_batch=3)  # rounded up to 4
    assert off.mode == "plain" and off.n == 10 and off.batches == 3
    assert off.max_batch == 4 and off.dists.shape == (10, 32)
    for lo in range(0, len(qs), 4):
        np.testing.assert_array_equal(off.dists[lo:lo + 4],
                                      svc.query_batch(qs[lo:lo + 4]))


@pytest.mark.parametrize("rerank", ["union", "per_query"])
def test_offline_topk_bitwise_top_k_batch(stack, rerank):
    data, svc = stack
    qs = list(data.queries[:6])
    off = run_offline(svc, qs, k=3, max_batch=4, rerank=rerank)
    assert off.mode == "top_k" and off.batches == 2
    for lo in (0, 4):
        idx, dist = svc.top_k_batch(qs[lo:lo + 4], 3, prune=True,
                                    rerank=rerank)
        np.testing.assert_array_equal(off.topk_idx[lo:lo + 4], idx)
        np.testing.assert_array_equal(off.topk_dist[lo:lo + 4], dist)
    idx_s, d_s = svc.top_k_scan_batch(qs, 3)
    np.testing.assert_array_equal(off.topk_idx, idx_s)
    np.testing.assert_array_equal(off.topk_dist, d_s)
    s = off.summary()
    assert s["rerank"] == rerank and s["n"] == 6 and s["throughput_qps"] > 0
    assert 0 <= s["solves_avoided"] <= 1 and s["rerank_programs"] > 0


@pytest.mark.parametrize("k", [None, 3])
def test_offline_result_save_round_trips(tmp_path, stack, k):
    data, svc = stack
    qs = list(data.queries[:5])
    off = run_offline(svc, qs, k=k, max_batch=4)
    assert isinstance(off, OfflineResult)
    out = off.save(tmp_path / "scored.npz")
    with np.load(out) as z:
        if k is None:
            assert z.files == ["dists"]
            np.testing.assert_array_equal(z["dists"], off.dists)
        else:
            assert sorted(z.files) == ["topk_dist", "topk_idx"]
            np.testing.assert_array_equal(z["topk_idx"], off.topk_idx)
            np.testing.assert_array_equal(z["topk_dist"], off.topk_dist)


def test_run_offline_rejects_unknown_rerank_and_handles_empty(stack):
    data, svc = stack
    with pytest.raises(ValueError):
        run_offline(svc, list(data.queries[:2]), k=3, rerank="sideways")
    empty = run_offline(svc, [], k=3)
    assert empty.n == 0 and empty.topk_idx.shape == (0, 3)
    assert run_offline(svc, []).dists.shape == (0, 32)
