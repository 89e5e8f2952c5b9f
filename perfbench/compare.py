"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (`perfbench.reference`) on the same inputs.

Numbers compared (each with a limit of its own, from the cell's file):
  * ``dist_rel_err``: the largest |d - d_ref| / d_ref over the compared
    (query, doc) distances;
  * ``topk_gap`` (top-k cells): over the compared requests and ranks i,
    the largest |d_ref[id_i] - d_ref_(i)| / d_ref_(i), where id_i is the
    program's i-th doc and d_ref_(i) the reference's i-th smallest
    distance: 0 when the program chose the reference's docs in its order,
    small for near ties swapped, large for a wrong doc or another
    request's answer.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import reference


def rel_err(d: np.ndarray, ref: np.ndarray) -> float:
    return float(np.max(np.abs(d.astype(np.float64) - ref)
                        / np.abs(ref.astype(np.float64))))


def topk_gap(ids: np.ndarray, ref_row: np.ndarray) -> float:
    k = ids.shape[0]
    best = np.sort(ref_row)[:k].astype(np.float64)
    return float(np.max(np.abs(ref_row[ids].astype(np.float64) - best)
                        / best))


def ref_rows(corpus, pool, rows, cfg: dict, *, precision: str,
             device) -> torch.Tensor:
    """(len(rows), N) reference distances of the pool's ``rows``."""
    cols = torch.from_numpy(corpus.cols)
    vals = torch.from_numpy(corpus.vals)
    if torch.device(device).type == "cuda":
        cols, vals = cols.to(device), vals.to(device)
    return reference.wmd(corpus.vecs, cols, vals, pool.ids[rows],
                         pool.weights[rows], lamb=cfg["lamb"],
                         max_iter=cfg["max_iter"], precision=precision)


def bulk(kept: dict, corpus, pool, cfg: dict, *, device,
         precision: str = "float32", control: bool = False) -> dict:
    """``dist_rel_err`` of the kept batches' (Q, N) outputs; with
    ``control`` the reference computed at ``precision`` stands in for the
    program's outputs."""
    worst = 0.0
    for idx, out in kept.values():
        ref = ref_rows(corpus, pool, idx, cfg, precision="float32",
                       device=device).cpu().numpy()
        if control:
            out = ref_rows(corpus, pool, idx, cfg, precision=precision,
                           device=device).cpu().numpy()
        worst = max(worst, rel_err(out, ref))
    return {"dist_rel_err": worst}


def top_k(results: dict, pool_rows, corpus, pool, cfg: dict, *, device,
          k: int, precision: str = "float32",
          control: bool = False) -> dict:
    """``dist_rel_err`` of the distances the requests returned and
    ``topk_gap`` of their docs, for the sampled requests ``results``
    (request index -> (ids, distances))."""
    order = sorted(results)
    if not order:
        return {"dist_rel_err": float("inf"), "topk_gap": float("inf")}
    rows = np.asarray([pool_rows[i] for i in order])
    ref = ref_rows(corpus, pool, rows, cfg, precision="float32",
                   device=device).cpu().numpy()
    if control:
        ctl = ref_rows(corpus, pool, rows, cfg, precision=precision,
                       device=device).cpu().numpy()
    worst_d = worst_g = 0.0
    for j, i in enumerate(order):
        if control:
            ids = np.argsort(ctl[j], kind="stable")[:k]
            dist = ctl[j][ids]
        else:
            ids, dist = (np.asarray(x) for x in results[i])
        worst_d = max(worst_d, rel_err(dist, ref[j][ids]))
        worst_g = max(worst_g, topk_gap(ids, ref[j]))
    return {"dist_rel_err": worst_d, "topk_gap": worst_g}
