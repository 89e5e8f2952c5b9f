"""Quickstart on the PyTorch / CUDA port: Word-Movers Distances of one query
against a corpus.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The port of `examples/quickstart.py`: builds the same synthetic
dbpedia-statistics corpus, runs the paper-faithful dense solver and the
PASWD sparse-fused solver (``impl="kernel"``: the hand-written CUDA
kernels, #1 for each iteration and #2 for the final distance, on the
query's vocab-major K and K.*M copies), checks they agree, and prints the
nearest documents. It runs on the card (``--device cuda``, the default;
without a card it raises) or, with ``--device cpu``, on the kernels' plain
PyTorch versions. The first sparse call is the warm call: it builds the
kernel library with nvcc, or loads it from the build directory.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import (select_query, sinkhorn_wmd_dense,
                              sinkhorn_wmd_sparse)
from repro_torch.data import make_corpus
from repro_torch.launch.mesh import resolve_device

VOCAB, EMBED, DOCS = 8_000, 300, 256
LAMB, ITERS = 1.0, 15


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels, the default) or "
                         "cpu (their plain PyTorch versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    print(f"corpus: V={VOCAB} w={EMBED} N={DOCS}")
    data = make_corpus(vocab_size=VOCAB, embed_dim=EMBED, num_docs=DOCS,
                       num_queries=1, seed=0)
    query = data.queries[0]
    sel, r_sel = select_query(query)
    print(f"query: v_r={len(sel)} words; corpus nnz={data.nnz} "
          f"(density {data.nnz / (VOCAB * DOCS):.4%})")
    sel_d, r_d = (torch.from_numpy(x).to(dev) for x in (sel, r_sel))
    vecs = torch.from_numpy(data.vecs).to(dev)

    # paper Algorithm 1, dense (the faithful baseline)
    c_dense = torch.from_numpy(data.ell.to_dense()).to(dev)
    t0 = time.perf_counter()
    wmd_dense = sinkhorn_wmd_dense(sel_d, r_d, c_dense, vecs, LAMB,
                                   ITERS).cpu().numpy()
    t_dense = time.perf_counter() - t0

    # PASWD: sparse fused SDDMM-SpMM (the paper's contribution)
    cols = torch.from_numpy(data.ell.cols).to(dev)
    vals = torch.from_numpy(data.ell.vals).to(dev)
    sinkhorn_wmd_sparse(sel_d, r_d, cols, vals, vecs, LAMB, ITERS,
                        impl="kernel")
    sync()                                  # warm: build or load the kernels
    t0 = time.perf_counter()
    wmd_sparse = sinkhorn_wmd_sparse(sel_d, r_d, cols, vals, vecs, LAMB,
                                     ITERS, impl="kernel").cpu().numpy()
    t_sparse = time.perf_counter() - t0

    err = np.abs(wmd_dense - wmd_sparse).max() / np.abs(wmd_dense).max()
    print(f"dense  : {t_dense * 1e3:8.1f} ms")
    print(f"sparse : {t_sparse * 1e3:8.1f} ms "
          f"({t_dense / t_sparse:.1f}x)   max rel diff {err:.2e}")
    top = np.argsort(wmd_sparse)[:5]
    print("nearest docs:", top.tolist())
    print("distances   :", np.round(wmd_sparse[top], 4).tolist())
    return {"dense": wmd_dense, "sparse": wmd_sparse, "rel_diff": float(err)}


if __name__ == "__main__":
    main()
