"""The plain reference (`perfbench.reference`) against a float64 dense
Sinkhorn written from the algorithm, and against the port's CPU route."""
import numpy as np
import pytest
import torch

import perfbench_tiny  # noqa: F401  (paths)
from perfbench import corpus, reference


def _problem(seed=5, vocab=600, dim=24, docs=40):
    data = corpus.make_corpus(seed=seed, device="cpu", vocab_size=vocab,
                              embed_dim=dim, num_docs=docs, mean_words=20.0,
                              zipf_s=1.07, nnz_align=8, doc_block=16)
    pool = corpus.make_queries(seed=seed, device="cpu", vocab_size=vocab,
                               n=3, words=9, zipf_s=1.07)
    return data, pool


def _dense64(data, pool, q, lamb, iters):
    """Algorithm 1 in float64 on the dense (V, N) document matrix."""
    vecs = data.vecs.double().numpy()
    v, n = vecs.shape[0], data.cols.shape[0]
    c = np.zeros((v + 1, n))
    for j in range(n):
        np.add.at(c[:, j], data.cols[j], data.vals[j])
    c = c[:v]
    ids, r = pool.ids[q], pool.weights[q].astype(np.float64)
    m = np.sqrt(((vecs[ids][:, None, :] - vecs[None]) ** 2).sum(-1))
    k = np.exp(-lamb * m)
    x = np.full((len(ids), n), 1.0 / len(ids))
    for _ in range(iters):
        u = 1.0 / x
        w = k.T @ u
        vv = np.where(c != 0, c / np.where(w == 0, 1, w), 0.0)
        x = (k / r[:, None]) @ vv
    u = 1.0 / x
    w = k.T @ u
    vv = np.where(c != 0, c / np.where(w == 0, 1, w), 0.0)
    return (u * ((k * m) @ vv)).sum(0)


@pytest.mark.parametrize("doc_block", [7, 64])
def test_reference_matches_float64_algorithm(doc_block):
    data, pool = _problem()
    ref = reference.wmd(data.vecs, torch.from_numpy(data.cols),
                        torch.from_numpy(data.vals), pool.ids, pool.weights,
                        lamb=1.0, max_iter=8, doc_block=doc_block,
                        vocab_block=100).numpy()
    for q in range(3):
        exact = _dense64(data, pool, q, 1.0, 8)
        np.testing.assert_allclose(ref[q], exact, rtol=2e-5)


def test_reference_matches_the_ports_cpu_route():
    from repro_torch.configs.sinkhorn_wmd import WMDConfig
    from repro_torch.core.formats import EllDocs
    from repro_torch.serving.wmd_service import WMDService
    data, pool = _problem(seed=9, vocab=800, dim=32, docs=60)
    cfg = WMDConfig(name="t", vocab_size=800, embed_dim=32, num_docs=60,
                    nnz_max=data.cols.shape[1], v_r=16, lamb=1.0,
                    max_iter=10)
    svc = WMDService(cfg=cfg, vecs=data.vecs,
                     ell=EllDocs(cols=data.cols, vals=data.vals,
                                 num_vocab=800),
                     device="cpu", cache_capacity=64)
    rows = corpus.DenseRows(3, 800)
    rs = [rows.put(i, pool.ids[i], pool.weights[i]) for i in range(3)]
    prog = svc.query_batch(rs)
    ref = reference.wmd(data.vecs, torch.from_numpy(data.cols),
                        torch.from_numpy(data.vals), pool.ids, pool.weights,
                        lamb=1.0, max_iter=10).numpy()
    rel = np.abs(prog - ref) / ref
    assert rel.max() < perfbench_tiny.CPU_ROUTE_LIMIT


def test_reference_imports_nothing_of_the_program():
    import ast
    import pathlib
    src = pathlib.Path(reference.__file__).read_text()
    tops = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add((node.module or "").split(".")[0])
    assert tops <= {"__future__", "numpy", "torch"}


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      1.0 + 2 ** -10, -3.14159265, 1e-20])
    y = reference.tf32(x)
    assert y[0] == 1.0
    assert y[1] == 1.0                       # a tie goes to even
    assert y[2] == 1.0 + 2 ** -9             # a tie goes to even
    assert y[3] == 1.0 + 2 ** -10            # representable: kept
    bits = y.view(torch.int32) & 0x1FFF
    assert bool((bits == 0).all())
    assert abs(float(y[4]) + 3.14159265) < 3.14159265 * 2 ** -11


def test_control_moves_the_distances():
    data, pool = _problem(vocab=600, dim=64, docs=40)
    args = (data.vecs, torch.from_numpy(data.cols),
            torch.from_numpy(data.vals), pool.ids, pool.weights)
    ref = reference.wmd(*args, lamb=1.0, max_iter=8).numpy()
    ctl = reference.wmd(*args, lamb=1.0, max_iter=8,
                        precision="tf32").numpy()
    rel = np.abs(ctl - ref) / ref
    assert rel.max() > 1e-5
