"""Feed-forward blocks: SiLU-GLU (llama/olmo/deepseek), GeGLU (gemma),
non-gated GELU (starcoder2/whisper).

Port of `repro.models.layers.mlp`. ``lead`` prepends a stacking shape to
every parameter (the scanned units of `models.lm`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers._random import normal
from repro_torch.models.sharding_hints import fsdp_use


def init(key: torch.Generator, kind: str, d: int, d_ff: int,
         dtype=torch.float32, *, lead: tuple = ()) -> dict:
    scale_in = d ** -0.5
    scale_out = d_ff ** -0.5
    if kind in ("silu_glu", "geglu"):
        return {
            "wi_gate": normal(key, (*lead, d, d_ff), scale_in, dtype),
            "wi_up": normal(key, (*lead, d, d_ff), scale_in, dtype),
            "wo": normal(key, (*lead, d_ff, d), scale_out, dtype),
        }
    if kind == "gelu":
        return {
            "wi": normal(key, (*lead, d, d_ff), scale_in, dtype),
            "bi": torch.zeros((*lead, d_ff), dtype=dtype, device=key.device),
            "wo": normal(key, (*lead, d_ff, d), scale_out, dtype),
            "bo": torch.zeros((*lead, d), dtype=dtype, device=key.device),
        }
    raise ValueError(f"unknown mlp kind {kind!r}")


def apply(kind: str, params: dict, x: torch.Tensor) -> torch.Tensor:
    dtype = x.dtype
    if kind in ("silu_glu", "geglu"):
        gate = x @ fsdp_use(params["wi_gate"], "wi_gate", dtype)
        up = x @ fsdp_use(params["wi_up"], "wi_up", dtype)
        act = F.silu(gate) if kind == "silu_glu" \
            else F.gelu(gate, approximate="tanh")
        return (act * up) @ fsdp_use(params["wo"], "wo", dtype)
    if kind == "gelu":
        h = F.gelu(x @ fsdp_use(params["wi"], "wi", dtype)
                   + params["bi"].to(dtype), approximate="tanh")
        return h @ fsdp_use(params["wo"], "wo", dtype) \
            + params["bo"].to(dtype)
    raise ValueError(f"unknown mlp kind {kind!r}")
