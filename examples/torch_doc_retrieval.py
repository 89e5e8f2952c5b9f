"""Document retrieval demo on the PyTorch / CUDA port: WMD top-k vs the
centroid-cosine baseline, plus a convergence study of the "while x
changes" loop (paper section III-B1).

    PYTHONPATH=src python examples/torch_doc_retrieval.py [--device cpu]

The port of `examples/doc_retrieval.py`. The 200-iteration solve runs the
hand-written CUDA kernels (``impl="kernel"``: #1 for each iteration, #2 for
the final distance) on the card (``--device cuda``, the default; without a
card it raises) or their plain PyTorch versions with ``--device cpu``. The
converged loop (`sinkhorn_wmd_converged`) runs the plain contractions on
either device, as the reference's does.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (select_query, sinkhorn_wmd_converged,
                              sinkhorn_wmd_sparse)
from repro_torch.data import make_corpus
from repro_torch.launch.mesh import resolve_device

VOCAB, EMBED, DOCS, QUERIES = 4096, 32, 256, 3
LAMB, ITERS = 0.5, 200
MAX_ITER, TOL = 500, 1e-4


def centroid_baseline(query, ell_dense, vecs):
    """Cheap baseline: cosine distance between frequency-weighted centroids."""
    qc = query @ vecs
    dc = ell_dense.T @ vecs                             # (N, w)
    qn = qc / np.linalg.norm(qc)
    dn = dc / np.maximum(np.linalg.norm(dc, axis=1, keepdims=True), 1e-9)
    return 1.0 - dn @ qn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels, the default) or "
                         "cpu (their plain PyTorch versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    data = make_corpus(vocab_size=VOCAB, embed_dim=EMBED, num_docs=DOCS,
                       num_queries=QUERIES, seed=1)
    c_dense = data.ell.to_dense()
    cols = torch.from_numpy(data.ell.cols).to(dev)
    vals = torch.from_numpy(data.ell.vals).to(dev)
    vecs = torch.from_numpy(data.vecs).to(dev)

    out = []
    for qi, query in enumerate(data.queries):
        sel, r_sel = select_query(query)
        sel_d, r_d = (torch.from_numpy(x).to(dev) for x in (sel, r_sel))
        wmd = sinkhorn_wmd_sparse(sel_d, r_d, cols, vals, vecs, LAMB, ITERS,
                                  impl="kernel").cpu().numpy()
        cen = centroid_baseline(query, c_dense, data.vecs)
        top_wmd = np.argsort(wmd)[:10]
        top_cen = np.argsort(cen)[:10]
        overlap = len(set(top_wmd) & set(top_cen))
        print(f"query {qi}: WMD top10 {top_wmd[:5].tolist()}... "
              f"centroid overlap {overlap}/10")

        # convergence: the 'ideal' while-x-changes loop vs the fixed cutoff
        conv = sinkhorn_wmd_converged(sel_d, r_d, cols, vals, vecs, LAMB,
                                      MAX_ITER, tol=TOL)
        agree = np.argsort(conv.wmd.cpu().numpy())[:10]
        print(f"         converged in {int(conv.n_iter)} iters "
              f"(top10 matches {ITERS}-iter solve: "
              f"{np.array_equal(agree, top_wmd)})")
        out.append({"wmd": wmd, "top_wmd": top_wmd, "overlap": overlap,
                    "n_iter": int(conv.n_iter),
                    "converged_wmd": conv.wmd.cpu().numpy()})
    return out


if __name__ == "__main__":
    main()
