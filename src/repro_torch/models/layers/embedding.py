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
    rows = _TableRows.apply(table, tokens.to(table.device).long())
    return finish_embed(cfg, params, rows, tokens, positions=positions,
                        dtype=dtype)


def shard_rows(table: torch.Tensor, tokens: torch.Tensor, lo: int
               ) -> torch.Tensor:
    """The rows of the tokens that a vocabulary shard (rows [lo, lo + n)
    of the table, ``table`` being those n rows) holds, zeros for the
    others (float32; summed over the shards they give every row once,
    exactly)."""
    n = table.shape[0]
    local = tokens.to(table.device).long() - lo
    own = (local >= 0) & (local < n)
    rows = _TableRows.apply(table, torch.clamp(local, 0, n - 1))
    return rows * own[..., None].to(rows.dtype)


def finish_embed(cfg: ModelConfig, params: dict, rows: torch.Tensor,
                 tokens: torch.Tensor, *,
                 positions: torch.Tensor | None = None,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """The looked-up rows -> the embedded activations: cast, scaled,
    learned positions added."""
    x = hint_activations(rows.to(dtype))
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype)
    if cfg.learned_pos and "pos" in params:
        pos = positions if positions is not None \
            else torch.arange(tokens.shape[-1])
        x = x + params["pos"][pos.to(rows.device).long()].to(dtype)
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


def _vocab_split(cfg: ModelConfig, params: dict) -> bool:
    from repro_torch.distributed import spmd
    if cfg.tie_embeddings:
        return spmd.splits_model(params["embed"], 0)
    return spmd.splits_model(params["unembed"], 1)


def mesh_embed(lay, cfg: ModelConfig, params: dict, tokens: list, *,
               positions: torch.Tensor | None = None,
               dtype=torch.bfloat16) -> list:
    """`embed` of one token tensor a batch group on the mesh of ``lay``.
    Where the table's vocabulary splits over the model axis, each shard
    looks up the rows it holds (`shard_rows`, its block gathered over
    ``data``) and the shards' rows are summed (exact: one is the row, the
    others zeros); else each group's owner looks up the gathered table.
    One (B_g, S, D) tensor a group."""
    from repro_torch.distributed import spmd
    table = params["embed"]
    rest = {k: v for k, v in params.items() if k == "pos"}
    extra = spmd.gather_tree(lay, rest, users=lay.owners())
    if lay.n_model > 1 and spmd.splits_model(table, 0):
        blocks = spmd.gather(lay, table, keep=(0,))
        n = table.shape[0] // lay.n_model
        rows = spmd.model_sum(lay, [
            shard_rows(blocks[i], tokens[i // lay.n_model].to(lay.dev(i)),
                       (i % lay.n_model) * n) for i in lay.positions()])
    else:
        blocks = spmd.gather(lay, table, users=lay.owners())
        rows = [_TableRows.apply(t, tok.to(t.device).long())
                for t, tok in zip(blocks, tokens)]
    return [finish_embed(cfg, extra[g], r, tokens[g], positions=positions,
                         dtype=dtype) for g, r in enumerate(rows)]


def mesh_logits(lay, cfg: ModelConfig, params: dict, h: list):
    """`logits` of one (B_g, S, D) tensor a batch group on the mesh of
    ``lay``: (one (B_g, S, V / M) tensor a position, True) where the
    vocabulary splits over the model axis (each shard's rows of the
    table, gathered over ``data``), else (one (B_g, S, V) a group,
    False)."""
    from repro_torch.distributed import spmd
    name = "embed" if cfg.tie_embeddings else "unembed"
    dtype = h[0].dtype
    if lay.n_model > 1 and _vocab_split(cfg, params):
        w = spmd.gather(lay, params[name], dtype=dtype,
                        keep=(0,) if cfg.tie_embeddings else (1,))
        hs = spmd.replicate(lay, h)
        return [logits(cfg, {name: w[i]}, hs[i])
                for i in lay.positions()], True
    w = spmd.gather(lay, params[name], dtype=dtype, users=lay.owners())
    return [logits(cfg, {name: w[g]}, h[g])
            for g in range(lay.n_groups)], False


def mesh_unshard_logits(lay, parts: list, split: bool) -> torch.Tensor:
    """The logical (B, S, V) logits on the mesh's first device from
    `mesh_logits`' parts (no gradient)."""
    dev = lay.group_dev(0)
    m = lay.n_model if split else 1
    rows = [torch.cat([p.to(dev) for p in parts[g * m:(g + 1) * m]], -1)
            if m > 1 else parts[g].to(dev) for g in range(lay.n_groups)]
    return rows[0] if len(rows) == 1 else torch.cat(rows, 0)
