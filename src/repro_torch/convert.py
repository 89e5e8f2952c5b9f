"""Carry the reference's serving state into the port.

The state worth carrying is the corpus: the (V, w) embeddings and the ELL
document matrix (``cols``, ``vals`` and the vocabulary size), as the JAX
package's `repro.core.formats.EllDocs` holds them in numpy. The K cache
holds nothing worth carrying: both packages start it empty and fill the
same slots from the same query stream.

    state = state_from_numpy(vecs, ell.cols, ell.vals, ell.num_vocab,
                             device="cuda")
    svc = WMDService.from_state(cfg, state, cache_capacity=1024)

A language model's state is its parameter tree: `lm_params_from_numpy`
carries the reference's tree (``jax.tree.map(np.asarray, params)``) into
the port's, which has the same structure, so both packages compute the
same function from the same weights. A training state carries the same
way: `train_state_from_numpy` takes the reference's ``TrainState``
(``jax.tree.map(np.asarray, state)``: the parameters, the AdamW step and
moments, the optional compression residual) to the port's.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.formats import EllDocs


class WMDState(NamedTuple):
    """Embeddings on the device and the port's host-side ELL."""

    vecs: torch.Tensor   # (V, w) float32 on ``device``
    ell: EllDocs         # cols (N, nnz) int32, vals (N, nnz) float32


def state_from_numpy(vecs: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                     num_vocab: int, *,
                     device: str | torch.device = "cuda") -> WMDState:
    """Embeddings and ELL fields (numpy) -> the port's `WMDState`.

    Values are copied bit for bit (float32 / int32), so both packages
    compute on identical inputs. ``device`` defaults to the card; pass
    ``"cpu"`` for the plain versions."""
    vecs = np.asarray(vecs)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    if vecs.ndim != 2 or cols.shape != vals.shape or cols.ndim != 2:
        raise ValueError(f"bad shapes: vecs {vecs.shape}, cols {cols.shape},"
                         f" vals {vals.shape}")
    if vecs.shape[0] != num_vocab:
        raise ValueError(f"vecs has {vecs.shape[0]} rows, vocab is "
                         f"{num_vocab}")
    if cols.size and (cols.min() < 0 or cols.max() > num_vocab):
        raise ValueError(f"cols outside [0, {num_vocab}]")
    ell = EllDocs(cols=np.ascontiguousarray(cols, np.int32),
                  vals=np.ascontiguousarray(vals, np.float32),
                  num_vocab=int(num_vocab))
    vecs_t = torch.as_tensor(np.ascontiguousarray(vecs, np.float32),
                             device=torch.device(device))
    return WMDState(vecs=vecs_t, ell=ell)


def lm_params_from_numpy(tree, *, device: str | torch.device = "cuda"):
    """The reference's language-model parameter tree, as numpy arrays
    (dicts, lists, the stacked ``units``), -> the port's tree on
    ``device``: the same structure, every array copied bit for bit into a
    tensor of its dtype. ``device`` defaults to the card."""
    device = torch.device(device)

    def conv(node, path):
        if isinstance(node, dict):
            return {k: conv(v, f"{path}/{k}") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v, f"{path}/{i}") for i, v in enumerate(node)]
        arr = np.asarray(node)
        if arr.dtype.kind != "f":
            raise ValueError(f"{path or '/'}: a parameter must be a float "
                             f"array, got {arr.dtype}")
        return torch.tensor(np.ascontiguousarray(arr), device=device)

    if not isinstance(tree, dict) or "embedding" not in tree:
        raise ValueError("not a language-model parameter tree (no "
                         "'embedding')")
    return conv(tree, "")


def train_state_from_numpy(tree, *, device: str | torch.device = "cuda"):
    """The reference's training state as numpy (its ``TrainState``: fields
    ``params``, ``opt`` = (``step``, ``mu``, ``nu``), ``comp`` = None or
    (``residual``,)) -> the port's `train.TrainState` on ``device``, every
    array copied bit for bit (the step as an int32 scalar). ``device``
    defaults to the card."""
    from repro_torch.optim import AdamWState
    from repro_torch.optim.compression import CompressionState
    from repro_torch.train.step import TrainState

    device = torch.device(device)
    step = np.asarray(tree.opt.step)
    if step.shape != () or step.dtype.kind not in "iu":
        raise ValueError(f"opt.step must be an int scalar, got "
                         f"{step.dtype}{list(step.shape)}")
    opt = AdamWState(
        step=torch.tensor(int(step), dtype=torch.int32, device=device),
        mu=lm_params_from_numpy(tree.opt.mu, device=device),
        nu=lm_params_from_numpy(tree.opt.nu, device=device))
    comp = None
    if tree.comp is not None:
        comp = CompressionState(residual=lm_params_from_numpy(
            tree.comp.residual, device=device))
    return TrainState(params=lm_params_from_numpy(tree.params, device=device),
                      opt=opt,
                      comp=comp)
