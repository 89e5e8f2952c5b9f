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


_KEEP = {"wi_gate": (1,), "wi_up": (1,), "wi": (1,), "bi": (0,), "wo": (0,)}


def mesh_apply(lay, kind: str, params: dict, xn: list) -> list:
    """`apply` of one (..., D) tensor a batch group on the mesh of ``lay``:
    each model shard computes its share of the hidden units (``wi*``
    column-parallel, ``wo`` row-parallel; ``bo`` added by the first
    shard) and the shards' partials are summed. Where the hidden units do
    not split over the model axis, the block runs whole on each group's
    owner. Returns one output a group."""
    from repro_torch.distributed import spmd
    dtype = xn[0].dtype
    wi = params["wi"] if kind == "gelu" else params["wi_gate"]
    if lay.n_model > 1 and not spmd.splits_model(wi, 1):
        w = spmd.gather_tree(lay, params, dtype=dtype, users=lay.owners())
        return [apply(kind, w[g], xn[g]) for g in range(lay.n_groups)]
    w = spmd.gather_tree(lay, params, dtype=dtype, keep=_KEEP)
    if "bo" in params:
        for i in lay.positions():
            if i % lay.n_model:
                w[i]["bo"] = torch.zeros_like(w[i]["bo"])
    xs = spmd.replicate(lay, xn)
    return spmd.model_sum(lay, [apply(kind, w[i], xs[i])
                                for i in lay.positions()])
