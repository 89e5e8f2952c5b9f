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


def _gate_pre(params: dict, u: torch.Tensor):
    """The gates' pre-activations u @ W_a, u @ W_x (float32): on a model
    shard its channels' rows, a partial of every channel's."""
    f32 = torch.float32
    uf = u.to(f32)
    return (uf @ fsdp_use(params["w_a"], "w_a", f32),
            uf @ fsdp_use(params["w_x"], "w_x", f32))


def _coeffs(params: dict, u: torch.Tensor, pre):
    """u (..., D) conv output and its gates' pre-activations -> (a, b) of
    h_t = a*h_{t-1} + b. f32."""
    f32 = torch.float32
    uf = u.to(f32)
    pa, px = pre
    r = torch.sigmoid(pa + params["b_a"].to(f32))
    i = torch.sigmoid(px + params["b_x"].to(f32))
    log_a = -_C * F.softplus(params["lam"].to(f32)) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * uf)
    return a, b


def _branches(params: dict, x: torch.Tensor):
    """(gate, xin): gelu(x W_gate) and x W_in, in x's dtype."""
    dtype = x.dtype
    gate = F.gelu(x @ fsdp_use(params["w_gate"], "w_gate", dtype),
                  approximate="tanh")
    return gate, x @ fsdp_use(params["w_in"], "w_in", dtype)


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
    gate, xin = _branches(params, x)
    u = _causal_conv(params, xin)
    a, bb = _coeffs(params, u, _gate_pre(params, u))        # (B,T,D) f32
    if h0 is not None:
        bb = torch.cat([bb[:, :1] + a[:, :1] * h0.to(torch.float32)[:, None],
                        bb[:, 1:]], dim=1)
    h = _linear_scan(a, bb)
    y = (h.to(x.dtype) * gate) @ fsdp_use(params["w_out"], "w_out", x.dtype)
    if return_state:
        return y, _final_state(params, h, xin)
    return y


def _final_state(params: dict, h: torch.Tensor, xin: torch.Tensor
                 ) -> RGLRUState:
    t = xin.shape[1]
    w = params["conv_w"].shape[0]
    return RGLRUState(h=h[:, -1], conv=xin[:, t - (w - 1):]
                      .to(torch.float32), pos=t)


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
    gate, xx, u = _decode_in(params, x, state)
    h, y = _decode_out(params, x.dtype, gate, u, _gate_pre(params, u), state)
    return y, _decode_state(state, h, xx)


def _decode_in(params: dict, x: torch.Tensor, state: RGLRUState):
    """The decode step's gate (B,D), conv window (history ++ xin,
    (B,W,D)) and conv output (B,1,D), the conv in float32."""
    f32 = torch.float32
    gate, xin = _branches(params, x[:, 0])
    xx = torch.cat([state.conv, xin[:, None]], dim=1)       # (B, W, D)
    u = torch.einsum("bwd,wd->bd", xx.to(f32), params["conv_w"].to(f32)) \
        + params["conv_b"].to(f32)
    return gate, xx, u[:, None]


def _decode_out(params: dict, dtype, gate, u, pre, state: RGLRUState):
    """(the new h (B,D) float32, the output (B,1,D))."""
    a, bb = _coeffs(params, u, pre)
    h = a[:, 0] * state.h.to(torch.float32) + bb[:, 0]
    y = (h.to(dtype) * gate) @ params["w_out"].to(dtype)
    return h, y[:, None]


def _decode_state(state: RGLRUState, h, xx) -> RGLRUState:
    return RGLRUState(h=h.to(state.h.dtype),
                      conv=xx[:, 1:].to(state.conv.dtype),
                      pos=state.pos + 1)


# ---------------------------------------------------------------------------
# On a mesh (`distributed.spmd`): channels over ``model``
# ---------------------------------------------------------------------------

# the model split each weight keeps: W_gate / W_in / conv_w's columns (a
# shard's channels), W_a / W_x / W_out's rows (its channels' inputs)
_KEEP = {"w_gate": (1,), "w_in": (1,), "conv_w": (1,), "w_a": (0,),
         "w_x": (0,), "w_out": (0,)}
_VECTORS = ("conv_b", "b_a", "b_x", "lam")       # replicated (D,) leaves


def splits(lay, params: dict) -> bool:
    """Whether the block runs channel-split on ``lay`` (each model shard
    its D / M channels): one shard, or W_in's columns split over
    ``model``; else it runs whole on each batch group's owner."""
    from repro_torch.distributed import spmd
    return lay.n_model == 1 or spmd.splits_model(params["w_in"], 1)


def _shard_params(lay, params: dict, dtype) -> list:
    """Each position's weights (one dict a position): its channels'
    columns of W_gate / W_in / conv_w and rows of W_a / W_x / W_out, cast
    as the layer uses them and gathered over ``data``, and its slice of
    the replicated vectors."""
    from repro_torch.distributed import spmd

    def part(names, dt):
        return spmd.gather_tree(lay, {k: params[k] for k in names},
                                dtype=dt, keep=_KEEP)

    mats = part(("w_gate", "w_in", "w_out"), dtype)
    gates = part(("w_a", "w_x"), torch.float32)
    rest = part(("conv_w",) + _VECTORS, None)
    out = []
    for i in lay.positions():
        p = {**mats[i], **gates[i], **rest[i]}
        dl = p["w_in"].shape[-1]
        sl = slice((i % lay.n_model) * dl, (i % lay.n_model + 1) * dl)
        out.append(dict(p, **{k: p[k][..., sl] for k in _VECTORS}))
    return out


def _place(lay, states: list) -> RGLRUState:
    """Each position's state of its channels -> the state's blocks per
    `cache_shardings` (h (B, D) and conv (B, W-1, D) split over channels
    as the positions computed them)."""
    from repro_torch.distributed import spmd
    if lay.single:
        return states[0]
    s0, m = states[0], lay.n_model
    d = s0.h.shape[-1] * m
    tmpl = RGLRUState(h=torch.empty((s0.h.shape[0], d), device="meta"),
                      conv=torch.empty((*s0.conv.shape[:2], d),
                                       device="meta"), pos=s0.pos)
    specs = spmd.state_specs(lay, tmpl)
    g = lay.n_groups
    return RGLRUState(
        h=spmd.place_blocks(lay, specs.h, (s0.h.shape[0] * g, d),
                            [s.h for s in states]),
        conv=spmd.place_blocks(lay, specs.conv,
                               (s0.conv.shape[0] * g, s0.conv.shape[1], d),
                               [s.conv for s in states]),
        pos=s0.pos)


def mesh_full(lay, cfg: ModelConfig, params: dict, xn: list, *,
              fill: bool = False):
    """`fwd_full` of one (B_g, T, D) tensor a batch group on the mesh of
    ``lay`` (`splits`): each model shard computes its channels (the
    branches, the depthwise conv, the scan); each gate's pre-activation
    reads every channel of u, so the shards' row-parallel partials are
    folded over ``model`` before the sigmoid (`spmd.model_sum_scatter`),
    and W_out's partials are summed. Returns (one output a group, with
    ``fill`` the final state as blocks per `cache_shardings`, else
    None)."""
    from repro_torch.distributed import spmd
    dtype = xn[0].dtype
    ps = _shard_params(lay, params, dtype)
    xs = spmd.replicate(lay, xn)
    br = [_branches(p, x) for p, x in zip(ps, xs)]
    us = [_causal_conv(p, xin) for p, (_, xin) in zip(ps, br)]
    pre = [_gate_pre(p, u) for p, u in zip(ps, us)]
    pa = spmd.model_sum_scatter(lay, [q[0] for q in pre], -1)
    px = spmd.model_sum_scatter(lay, [q[1] for q in pre], -1)
    ys, states = [], []
    for i, (p, (gate, xin), u) in enumerate(zip(ps, br, us)):
        h = _linear_scan(*_coeffs(p, u, (pa[i], px[i])))
        ys.append((h.to(dtype) * gate)
                  @ fsdp_use(p["w_out"], "w_out", dtype))
        if fill:
            states.append(_final_state(p, h, xin))
    return spmd.model_sum(lay, ys), (_place(lay, states) if fill else None)


def mesh_decode(lay, cfg: ModelConfig, params: dict, xn: list,
                state: RGLRUState):
    """`fwd_decode` on the mesh of ``lay`` (`splits`), each model shard on
    its channels' blocks of ``state``, which it updates in place (the
    gates' partials folded as in `mesh_full`). Returns (one output a
    group, the state)."""
    from repro_torch.distributed import spmd
    dtype = xn[0].dtype
    ps = _shard_params(lay, params, dtype)
    xs = spmd.replicate(lay, xn)
    own = [state if lay.single else RGLRUState(
        h=state.h.blocks[c], conv=state.conv.blocks[c], pos=state.pos)
        for c in lay.coords]
    ins = [_decode_in(p, x, s) for p, x, s in zip(ps, xs, own)]
    pre = [_gate_pre(p, u) for p, (_, _, u) in zip(ps, ins)]
    pa = spmd.model_sum_scatter(lay, [q[0] for q in pre], -1)
    px = spmd.model_sum_scatter(lay, [q[1] for q in pre], -1)
    ys = []
    for i, (p, (gate, xx, u), s) in enumerate(zip(ps, ins, own)):
        h, y = _decode_out(p, dtype, gate, u, (pa[i], px[i]), s)
        new = _decode_state(s, h, xx)
        s.h.copy_(new.h)
        s.conv.copy_(new.conv)
        ys.append(y)
    return spmd.model_sum(lay, ys), state._replace(pos=state.pos + 1)
