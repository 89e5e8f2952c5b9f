"""Normalization layers: RMSNorm, LayerNorm, and OLMo's non-parametric LN.

Port of `repro.models.layers.norms`. All norms compute in f32 regardless
of activation dtype (standard practice) and cast back to the input dtype.
``lead`` prepends a stacking shape to every parameter (the scanned units
of `models.lm`).
"""
from __future__ import annotations

import torch


def init(kind: str, d: int, dtype=torch.float32, *, lead: tuple = (),
         device=None) -> dict:
    if kind == "rmsnorm":
        return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((*lead, d), dtype=dtype, device=device),
                "bias": torch.zeros((*lead, d), dtype=dtype, device=device)}
    if kind == "nonparam_ln":
        return {}  # OLMo: no learnable parameters
    raise ValueError(f"unknown norm kind {kind!r}")


def apply(kind: str, params: dict, x: torch.Tensor, *, eps: float = 1e-6
          ) -> torch.Tensor:
    dtype = x.dtype
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        y = y * params["scale"].to(torch.float32)
    elif kind in ("layernorm", "nonparam_ln"):
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if kind == "layernorm":
            y = y * params["scale"].to(torch.float32) \
                + params["bias"].to(torch.float32)
    else:
        raise ValueError(f"unknown norm kind {kind!r}")
    return y.to(dtype)
