"""Gradient compression for the cross-pod all-reduce (int8 + error feedback).

Port of `repro.optim.compression`: blockwise symmetric int8 quantization
with **error feedback** (the residual is carried to the next step, which
keeps SGD/Adam convergence -- Karimireddy et al. 2019). The train step
wraps the gradient leaves as quantize -> dequantize + residual; on one
device there is no collective between the two, so the pair simulates the
numerics of a compressed all-reduce end to end.

``torch.round`` rounds half to even, as ``jnp.round``: on the same input
the codes and block scales are the reference's, bit for bit (on the CPU;
a CUDA division by a Python scalar multiplies by its reciprocal).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import _tree

BLOCK = 256


class CompressionState(NamedTuple):
    residual: Any   # error-feedback residuals, same tree as grads


def init_state(grads_like: Any) -> CompressionState:
    return CompressionState(residual=_tree.tree_map(
        lambda g: torch.zeros_like(g, dtype=torch.float32), grads_like))


def _quantize_leaf(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8: returns (q int8, scale f32 per block)."""
    flat = g.to(torch.float32).reshape(-1)
    pad = (-flat.numel()) % BLOCK
    flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    q = torch.clip(torch.round(blocks / torch.clamp_min(scale, 1e-12)),
                   -127, 127).to(torch.int8)
    return q, scale


def _dequantize_leaf(q: torch.Tensor, scale: torch.Tensor, shape,
                     size: int) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)[:size]
    return flat.reshape(shape)


def compress_grads(grads: Any, state: CompressionState
                   ) -> tuple[Any, CompressionState]:
    """int8 round-trip with error feedback. Returns (grads', new state)."""
    new_g, new_r = [], []
    for g, r in zip(_tree.leaves(grads), _tree.leaves(state.residual),
                    strict=True):
        gf = g.to(torch.float32) + r
        q, s = _quantize_leaf(gf)
        deq = _dequantize_leaf(q, s, gf.shape, gf.numel())
        new_g.append(deq.to(g.dtype))
        new_r.append(gf - deq)
    return (_tree.unflatten(grads, new_g),
            CompressionState(residual=_tree.unflatten(state.residual,
                                                      new_r)))
