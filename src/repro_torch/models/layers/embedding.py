"""Token embeddings / logits head, learned positions.

Port of `repro.models.layers.embedding`."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers._random import normal
from repro_torch.models.sharding_hints import (fsdp_use, hint_activations,
                                               hint_logits)


def init(key: torch.Generator, cfg: ModelConfig, *, max_positions: int = 0,
         dtype=torch.float32) -> dict:
    p = {"embed": normal(key, (cfg.vocab_size, cfg.d_model),
                         cfg.d_model ** -0.5, dtype)}
    if not cfg.tie_embeddings:
        p["unembed"] = normal(key, (cfg.d_model, cfg.vocab_size),
                              cfg.d_model ** -0.5, dtype)
    if cfg.learned_pos and max_positions:
        p["pos"] = normal(key, (max_positions, cfg.d_model), 0.02, dtype)
    return p


class _TableRows(torch.autograd.Function):
    """``table[idx]``, whose gradient sums the rows read more than once in
    a fixed order: the reads sorted stably by row, then one sequential sum
    a row (`torch.segment_reduce`). Plain indexing's backward is an
    index-add, which on the card adds a row's duplicates with float
    atomics in no fixed order (a Zipf batch reads token 0 hundreds of
    times)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        flat = idx.reshape(-1)
        g = g.reshape(flat.numel(), -1)
        ids, perm = torch.sort(flat, stable=True)
        rows, counts = torch.unique_consecutive(ids, return_counts=True)
        out = g.new_zeros((ctx.table_shape[0], g.shape[1]))
        out[rows] = torch.segment_reduce(g[perm], "sum", lengths=counts,
                                         axis=0)
        return out.reshape(ctx.table_shape), None


def embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
          *, positions: torch.Tensor | None = None,
          dtype=torch.bfloat16) -> torch.Tensor:
    table = params["embed"]
    x = hint_activations(
        _TableRows.apply(table, tokens.to(table.device).long()).to(dtype))
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype)
    if cfg.learned_pos and "pos" in params:
        pos = positions if positions is not None \
            else torch.arange(tokens.shape[-1])
        x = x + params["pos"][pos.to(table.device).long()].to(dtype)
    return x


def logits(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        out = x @ fsdp_use(params["embed"], "embed", x.dtype).T
    else:
        out = x @ fsdp_use(params["unembed"], "unembed", x.dtype)
    out = hint_logits(out)
    if cfg.logit_softcap > 0:
        cap = cfg.logit_softcap
        out = cap * torch.tanh(out.to(torch.float32) / cap)
    return out
