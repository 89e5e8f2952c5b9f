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


def embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
          *, positions: torch.Tensor | None = None,
          dtype=torch.bfloat16) -> torch.Tensor:
    table = params["embed"]
    x = hint_activations(table[tokens.to(table.device).long()].to(dtype))
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
