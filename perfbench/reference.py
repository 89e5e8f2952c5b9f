"""The plain reference: Sinkhorn-WMD of queries against an ELL corpus.

Plain PyTorch, float32, written from the algorithm (arXiv:2107.06433,
Algorithm 1), independent of the program under test: it imports nothing
of it and takes nothing it made. From the embeddings, the ELL and each
query's (word ids, weights) it works out the cost rows, K = exp(-lambda M)
and K .* M again itself, then runs the fixed number of Sinkhorn iterations
and the distance, doc block by doc block so that it fits:

    M = cdist(vecs[ids], vecs)               (differences squared: exact 0
                                              on a query word's own column)
    x = 1 / v
    repeat max_iter times:
        u = 1 / x
        v[j, k] = c[j, k] / sum_i K[i, col[j, k]] u[i, j]
        x[i, j] = (1 / r_i) sum_k K[i, col[j, k]] v[j, k]
    u = 1 / x; v as above
    WMD[j] = sum_i u[i, j] sum_k (K .* M)[i, col[j, k]] v[j, k]

``precision="tf32"`` is the control: the same computation with every
operand of a product rounded to TF32's 10-bit mantissa (as a TF32 tensor
core rounds its inputs), accumulated in float32.
"""
from __future__ import annotations

import numpy as np
import torch

TINY = 1e-30          # reciprocal guard: exact for every healthy value


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 explicit mantissa bits), to nearest
    with ties to even."""
    i = x.contiguous().view(torch.int32)
    bias = 0x0FFF + ((i >> 13) & 1)
    return ((i + bias) & ~0x1FFF).view(torch.float32)


def _recip(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.clamp(x, min=TINY)


def cost_rows(a: torch.Tensor, vecs: torch.Tensor, *, vocab_block: int
              ) -> torch.Tensor:
    """(m, V) euclidean distances of the rows ``a`` to every word, from the
    squared differences, ``vocab_block`` words at a time."""
    out = torch.empty((a.shape[0], vecs.shape[0]), dtype=torch.float32,
                      device=a.device)
    for lo in range(0, vecs.shape[0], vocab_block):
        d = a[:, None, :] - vecs[None, lo:lo + vocab_block, :]
        out[:, lo:lo + vocab_block] = torch.sqrt(torch.sum(d * d, dim=-1))
    return out


def wmd(vecs: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
        ids: np.ndarray, weights: np.ndarray, *, lamb: float, max_iter: int,
        precision: str = "float32", doc_block: int = 65_536,
        vocab_block: int = 8_192) -> torch.Tensor:
    """(Q, N) Sinkhorn-WMD of the queries (``ids``, ``weights``: (Q, v)
    each) against the ELL ``cols`` / ``vals`` (N, nnz), pad id == V.

    Everything lives on ``vecs``' device; cols / vals may be moved there a
    block at a time by the caller's choice of device."""
    if precision not in ("float32", "tf32"):
        raise ValueError(f"precision must be float32 or tf32, "
                         f"got {precision!r}")
    rnd = tf32 if precision == "tf32" else (lambda t: t)
    dev = vecs.device
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        q_n, n = ids.shape[0], cols.shape[0]
        out = torch.empty((q_n, n), dtype=torch.float32, device=dev)
        vecs_r = rnd(vecs)
        for q in range(q_n):
            sel = torch.as_tensor(ids[q], dtype=torch.int64, device=dev)
            r = torch.as_tensor(weights[q], dtype=torch.float32, device=dev)
            m = cost_rows(vecs_r[sel], vecs_r, vocab_block=vocab_block)
            k = torch.exp(-lamb * m)
            # vocab-major, with the zero column of the pad id appended
            k_t = torch.nn.functional.pad(k, (0, 1)).T.contiguous()
            km_t = torch.nn.functional.pad(k * m, (0, 1)).T.contiguous()
            k_t, km_t = rnd(k_t), rnd(km_t)
            v_n = sel.numel()
            for lo in range(0, n, doc_block):
                c = cols[lo:lo + doc_block].to(dev, torch.int64)
                val = vals[lo:lo + doc_block].to(dev, torch.float32)
                kg = k_t[c]                        # (B, nnz, v)
                x = torch.full((c.shape[0], v_n), 1.0 / v_n,
                               dtype=torch.float32, device=dev)

                def scale(x):
                    u = rnd(_recip(x))
                    w = torch.bmm(kg, u[:, :, None])[:, :, 0]  # (B, nnz)
                    return u, torch.where(val != 0.0, val / torch.clamp(
                        w, min=TINY), 0.0)

                for _ in range(max_iter):
                    _, v = scale(x)
                    x = torch.bmm(kg.transpose(1, 2),
                                  rnd(v)[:, :, None])[:, :, 0] / r
                u, v = scale(x)
                kmg = km_t[c]
                wm = torch.bmm(kmg.transpose(1, 2), rnd(v)[:, :, None])
                out[q, lo:lo + c.shape[0]] = torch.sum(u * rnd(wm[:, :, 0]),
                                                       dim=1)
                del kg, kmg
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
