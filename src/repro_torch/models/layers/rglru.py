"""Griffin recurrent block: conv1d + RG-LRU (recurrentgemma).

Port of `repro.models.layers.rglru`. RG-LRU recurrence (per channel):
    r_t = sigmoid(W_a x_t + b_a)            recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            input gate
    a_t = exp(-c * softplus(L) * r_t)       (L learnable; c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Train / prefill evaluates the linear recurrence h_t = a_t h_{t-1} + b_t
with a log-depth **doubling scan** (Hillis-Steele): at step d every
position t >= d folds in the prefix ending at t - d, so ceil(log2 T)
steps of four element-wise launches each (24 at T = 64), where a loop
over T would cost about six launches a token in each of recurrentgemma's
26 RG-LRU layers. The reference uses ``jax.lax.associative_scan``, whose
order of combination is XLA's; the two orders round differently, so the
port is held to the reference at its own scan-against-decode tolerance
(atol 1e-4). Decode carries (h, conv history) with O(1) work a token.

The precision split is the reference's: prefill's conv runs in the
compute dtype, decode's in float32.

Block structure (Griffin): two branches from x --
  gate branch: gelu(W_gate x); rnn branch: W_in x -> causal depthwise conv1d
  (width 4) -> RG-LRU -> multiply by gate -> W_out.

An `RGLRUState`'s ``pos`` is a Python int (the tokens already seen).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers._random import normal
from repro_torch.models.sharding_hints import fsdp_use

_C = 8.0


class RGLRUState(NamedTuple):
    h: torch.Tensor      # (B, D) recurrent state
    conv: torch.Tensor   # (B, W-1, D) trailing inputs for the causal conv
    pos: int


def init(key: torch.Generator, cfg: ModelConfig, dtype=torch.float32, *,
         lead: tuple = ()) -> dict:
    d = cfg.d_model
    w = cfg.rglru_conv_width
    dev = key.device
    s = d ** -0.5

    def zeros():
        return torch.zeros((*lead, d), dtype=dtype, device=dev)

    return {
        "w_gate": normal(key, (*lead, d, d), s, dtype),
        "w_in": normal(key, (*lead, d, d), s, dtype),
        "conv_w": normal(key, (*lead, w, d), w ** -0.5, dtype),
        "conv_b": zeros(),
        "w_a": normal(key, (*lead, d, d), s, dtype),
        "b_a": zeros(),
        "w_x": normal(key, (*lead, d, d), s, dtype),
        "b_x": zeros(),
        # softplus(lambda) init so a ~ 0.9..0.999 (Griffin's init range)
        "lam": torch.full((*lead, d), 0.7, dtype=dtype, device=dev),
        "w_out": normal(key, (*lead, d, d), s, dtype),
    }


def _rglru_coeffs(params: dict, u: torch.Tensor):
    """u: (..., D) conv output -> (a, b) of h_t = a*h_{t-1} + b. f32."""
    f32 = torch.float32
    uf = u.to(f32)
    r = torch.sigmoid(uf @ fsdp_use(params["w_a"], "w_a", f32)
                      + params["b_a"].to(f32))
    i = torch.sigmoid(uf @ fsdp_use(params["w_x"], "w_x", f32)
                      + params["b_x"].to(f32))
    log_a = -_C * F.softplus(params["lam"].to(f32)) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * uf)
    return a, b


def _causal_conv(params: dict, x: torch.Tensor,
                 history: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv, width W. x (B,T,D); history (B,W-1,D) or zeros."""
    w = params["conv_w"].shape[0]
    b, t, d = x.shape
    if history is None:
        history = torch.zeros((b, w - 1, d), dtype=x.dtype, device=x.device)
    xx = torch.cat([history, x], dim=1)                     # (B, T+W-1, D)
    out = torch.zeros((b, t, d), dtype=x.dtype, device=x.device)
    for tap in range(w):                                    # width is tiny (4)
        out = out + xx[:, tap: tap + t] * params["conv_w"][tap].to(x.dtype)
    return out + params["conv_b"].to(x.dtype)


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h along axis 1 of h_t = a_t h_{t-1} + b_t, h_{-1} = 0: the doubling
    scan (module docstring). a, b (B, T, D) float32."""
    t = a.shape[1]
    d = 1
    while d < t:
        # (a, b)[t] <- (a[t-d] a[t], a[t] b[t-d] + b[t]) for t >= d
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def fwd_full(cfg: ModelConfig, params: dict, x: torch.Tensor,
             h0: Optional[torch.Tensor] = None, *,
             return_state: bool = False):
    """Train/prefill. x (B,T,D) -> (B,T,D) via the doubling scan.

    ``return_state``'s conv history is ``xin[:, T-(W-1):]``, as the
    reference's: for T < W-1 it holds fewer than W-1 rows."""
    b, t, d = x.shape
    dtype = x.dtype
    gate = F.gelu(x @ fsdp_use(params["w_gate"], "w_gate", dtype),
                  approximate="tanh")
    xin = x @ fsdp_use(params["w_in"], "w_in", dtype)
    u = _causal_conv(params, xin)
    a, bb = _rglru_coeffs(params, u)                        # (B,T,D) f32
    if h0 is not None:
        bb = torch.cat([bb[:, :1] + a[:, :1] * h0.to(torch.float32)[:, None],
                        bb[:, 1:]], dim=1)
    h = _linear_scan(a, bb)
    y = (h.to(dtype) * gate) @ fsdp_use(params["w_out"], "w_out", dtype)
    if return_state:
        w = params["conv_w"].shape[0]
        state = RGLRUState(h=h[:, -1], conv=xin[:, t - (w - 1):]
                           .to(torch.float32), pos=t)
        return y, state
    return y


def init_state(cfg: ModelConfig, batch: int, dtype=torch.float32, *,
               lead: tuple = (), device=None) -> RGLRUState:
    d = cfg.d_model
    w = cfg.rglru_conv_width
    return RGLRUState(
        h=torch.zeros((*lead, batch, d), dtype=dtype, device=device),
        conv=torch.zeros((*lead, batch, w - 1, d), dtype=dtype,
                         device=device),
        pos=0)


def fwd_decode(cfg: ModelConfig, params: dict, x: torch.Tensor,
               state: RGLRUState) -> tuple[torch.Tensor, RGLRUState]:
    """One step. x (B,1,D). O(1) per token; ``state`` is left as it was."""
    dtype = x.dtype
    f32 = torch.float32
    gate = F.gelu(x[:, 0] @ params["w_gate"].to(dtype), approximate="tanh")
    xin = x[:, 0] @ params["w_in"].to(dtype)                # (B, D)
    # conv over (history ++ xin), in float32
    xx = torch.cat([state.conv, xin[:, None]], dim=1)       # (B, W, D)
    u = torch.einsum("bwd,wd->bd", xx.to(f32), params["conv_w"].to(f32)) \
        + params["conv_b"].to(f32)
    a, bb = _rglru_coeffs(params, u[:, None])
    h = a[:, 0] * state.h.to(f32) + bb[:, 0]
    y = (h.to(dtype) * gate) @ params["w_out"].to(dtype)
    new_state = RGLRUState(h=h.to(state.h.dtype),
                           conv=xx[:, 1:].to(state.conv.dtype),
                           pos=state.pos + 1)
    return y[:, None], new_state
