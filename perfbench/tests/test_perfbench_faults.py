"""The comparison fails what it must: the control (the reference computed
in TF32) against the cell's limits, and a run whose timed path is broken
underneath. These drive the harness on the CPU, skipping its look for a
card; the CPU route's own spelling is held to the CPU limit of
`perfbench_tiny`."""
import dataclasses

import numpy as np
import pytest
import torch

import perfbench_tiny
from perfbench import cells, compare, corpus, reference, run


def _run(name, fault=None, seed=2 ** 31 + 101):
    c = perfbench_tiny.tiny(name)
    result, checks = run.run_cell(c, seed=seed, seconds=0.6, trace=False,
                                  device="cpu", fault=fault)
    return result


def _no_iterations(svc):
    """Every Sinkhorn step returns its state unchanged."""
    svc.cfg = dataclasses.replace(svc.cfg, max_iter=0)
    svc._stripe_fns.clear()


def _half_batch(svc):
    """Half of each batch left out: its rows are the mean of the rest."""
    qb, tk = svc.query_batch, svc.top_k_batch

    def query_batch(rs, **kw):
        h = max(1, len(rs) // 2)
        d = qb(rs[:h], **kw)
        return np.concatenate([d, np.repeat(d.mean(0, keepdims=True),
                                            len(rs) - h, 0)])

    def top_k_batch(rs, k=10, **kw):
        h = max(1, len(rs) // 2)
        idx, dist = tk(rs[:h], k, **kw)
        fill = len(rs) - h
        return (np.concatenate([idx, np.repeat(idx[:1], fill, 0)]),
                np.concatenate([dist, np.repeat(dist[:1], fill, 0)]))
    svc.query_batch, svc.top_k_batch = query_batch, top_k_batch


def _altered_answer(svc):
    """One answer of each dispatch altered where it is produced."""
    qb, tk = svc.query_batch, svc.top_k_batch

    def query_batch(rs, **kw):
        d = qb(rs, **kw).copy()
        d[0, 1] *= 1.05
        return d

    def top_k_batch(rs, k=10, **kw):
        idx, dist = tk(rs, k, **kw)
        idx = idx.copy()
        idx[:, 0] = idx[:, -1] + 1
        return idx, dist
    svc.query_batch, svc.top_k_batch = query_batch, top_k_batch


CELLS = ["paper_5k.bulk_q64", "prod_5m_shard4.bulk_q16",
         "prod_5m_shard4.serve_top10"]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("fault", [_no_iterations, _half_batch,
                                   _altered_answer])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    r = _run(name, fault=fault)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", [w["name"] for w in
                                  cells.benchmark()["workloads"]])
def test_the_control_fails_the_cells_limits(name):
    """At a small size with the cell's widths (w 300), the TF32 control
    reads above the cell's own limit on three seeds."""
    c = cells.load(name)
    limits = c.spec["limits"]
    for seed in (11, 12, 13):
        data = corpus.make_corpus(seed=seed, device="cpu", vocab_size=2048,
                                  embed_dim=300, num_docs=400,
                                  mean_words=35.0, zipf_s=1.07,
                                  nnz_align=8, doc_block=400)
        pool = corpus.make_queries(seed=seed, device="cpu",
                                   vocab_size=2048, n=4, words=19,
                                   zipf_s=1.07)
        rows = np.arange(4)
        cfg = {"lamb": 1.0, "max_iter": 15}
        ctl = compare.ref_rows(data, pool, rows, cfg, precision="tf32",
                               device="cpu").numpy()
        if c.traffic["loop"] == "closed":
            nums = compare.bulk({0: (rows, ctl)}, data, pool, cfg,
                                device="cpu")
        else:
            res = {i: (np.argsort(ctl[i], kind="stable")[:10],
                       ctl[i][np.argsort(ctl[i], kind="stable")[:10]])
                   for i in range(4)}
            nums = compare.top_k(res, rows, data, pool, cfg, device="cpu",
                                 k=10)
        assert any(nums[k] > limits[k] for k in limits), (seed, nums)


def test_reference_tf32_differs_from_float32_everywhere_it_multiplies():
    data = corpus.make_corpus(seed=1, device="cpu", vocab_size=700,
                              embed_dim=300, num_docs=30, mean_words=20.0,
                              zipf_s=1.07, nnz_align=8)
    pool = corpus.make_queries(seed=1, device="cpu", vocab_size=700, n=2,
                               words=9, zipf_s=1.07)
    args = (data.vecs, torch.from_numpy(data.cols),
            torch.from_numpy(data.vals), pool.ids, pool.weights)
    a = reference.wmd(*args, lamb=1.0, max_iter=5)
    b = reference.wmd(*args, lamb=1.0, max_iter=5, precision="tf32")
    assert not torch.equal(a, b)
