"""Synthetic LM token pipeline: deterministic, shardable, restart-safe.

Port of `repro.data.tokens` (numpy, the same batches bit for bit). A real
deployment would stream tokenized shards; the interface below matches
that contract (stateless ``batch_at(step)`` indexed by global step, so a
restarted trainer resumes mid-epoch deterministically) while the payload
is synthetic Zipf tokens.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    cfg: ModelConfig
    batch: int
    seq_len: int
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for a global step (restart-safe)."""
        rng = np.random.default_rng((self.seed, step))
        v = self.cfg.vocab_size
        toks = np.minimum(rng.zipf(1.2, size=(self.batch, self.seq_len + 1)),
                          v) - 1
        toks = toks.astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.family == "vlm":
            p = self.cfg.encoder.num_positions
            out["patches"] = rng.normal(
                size=(self.batch, p, self.cfg.d_model)).astype(np.float32)
            out["tokens"] = out["tokens"][:, : self.seq_len - p]
            out["labels"] = out["labels"][:, : self.seq_len - p]
        if self.cfg.family == "audio":
            f = self.cfg.encoder.num_positions
            out["frames"] = rng.normal(
                size=(self.batch, f, self.cfg.d_model)).astype(np.float32)
        return out


def batch_struct(cfg: ModelConfig, shape: ShapeConfig):
    """The shapes and dtypes of one training batch, as tensors on the
    ``meta`` device (no storage): the reference's ShapeDtypeStructs."""
    b, s = shape.global_batch, shape.seq_len

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    out = {"tokens": meta((b, s), torch.int32),
           "labels": meta((b, s), torch.int32)}
    if cfg.family == "vlm":
        p = cfg.encoder.num_positions
        out["patches"] = meta((b, p, cfg.d_model), torch.float32)
        out["tokens"] = meta((b, s - p), torch.int32)
        out["labels"] = meta((b, s - p), torch.int32)
    if cfg.family == "audio":
        f = cfg.encoder.num_positions
        out["frames"] = meta((b, f, cfg.d_model), torch.float32)
    return out
