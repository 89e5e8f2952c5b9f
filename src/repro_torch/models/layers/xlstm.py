"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

Port of `repro.models.layers.xlstm`. mLSTM is a gated linear-attention
recurrence:
    m_t = max(log_f_t + m_{t-1}, log_i_t)                  (stabilizer)
    f'  = exp(log_f_t + m_{t-1} - m_t);  i' = exp(log_i_t - m_t)
    C_t = f' C_{t-1} + i' k_t v_t^T;     n_t = f' n_{t-1} + i' k_t
    h_t = (q_t C_t) / max(|q_t . n_t|, exp(-m_t))          (q pre-scaled)

Execution paths:
  * ``mlstm_chunkwise`` -- the sequence is split into chunks; within a
    chunk the recurrence is evaluated as a masked (L x L) matmul, between
    chunks a (hd x hd) state is carried by a loop over the chunks. O(T*L)
    memory instead of O(T^2). T must be a multiple of the chunk.
  * ``mlstm_recurrent`` -- step-by-step oracle (tests + decode).

sLSTM has a *non-linear* recurrent dependency (block-diagonal R h_{t-1}
inside the gates), so it is sequential by nature: a loop over time for
train/prefill, O(1) step for decode -- the xLSTM paper's own trade-off.

Block wiring (both kinds): pre-LN -> up-projection x2 -> cell with causal
conv4 + silu on the q/k path -> per-head GroupNorm -> gated by silu branch
-> down-projection. d_ff = 0 in the config: blocks own their projections.

Two starting values of the stabilizer m, as in the reference: a prefill
from no state starts it at -inf (exp(-inf) = 0 keeps the empty state
out), a fresh decode state at -1e30. A state's ``pos`` is a Python int.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import norms
from repro_torch.models.layers._random import normal
from repro_torch.models.sharding_hints import fsdp_use

EPS = 1e-6


# ---------------------------------------------------------------------------
# mLSTM cell
# ---------------------------------------------------------------------------

class MLSTMState(NamedTuple):
    c: torch.Tensor     # (B, H, hd, hd)
    n: torch.Tensor     # (B, H, hd)
    m: torch.Tensor     # (B, H)
    conv: torch.Tensor  # (B, W-1, D) conv history
    pos: int


def _empty_state(q: torch.Tensor):
    """(C, n, m) of no history: zeros and m = -inf."""
    b, h, _, hd = q.shape
    f32 = torch.float32
    return (torch.zeros((b, h, hd, hd), dtype=f32, device=q.device),
            torch.zeros((b, h, hd), dtype=f32, device=q.device),
            torch.full((b, h), -torch.inf, dtype=f32, device=q.device))


def mlstm_recurrent(q, k, v, log_i, log_f, state=None):
    """Oracle: q,k,v (B,H,T,hd) (q pre-scaled by hd^-0.5), gates (B,H,T).
    Returns h (B,H,T,hd) and final (C, n, m)."""
    c, n, m = _empty_state(q) if state is None else state
    hs = []
    for t in range(q.shape[2]):
        qt, kt, vt = q[:, :, t], k[:, :, t], v[:, :, t]
        li, lf = log_i[:, :, t], log_f[:, :, t]
        m_new = torch.maximum(lf + m, li)
        fp = torch.exp(lf + m - m_new)
        ip = torch.exp(li - m_new)
        c = fp[..., None, None] * c \
            + ip[..., None, None] * (kt[..., :, None] * vt[..., None, :])
        n = fp[..., None] * n + ip[..., None] * kt
        num = torch.einsum("bhd,bhde->bhe", qt, c)
        den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qt, n)),
                            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=2), (c, n, m)


def mlstm_chunkwise(q, k, v, log_i, log_f, *, chunk: int = 256, state=None):
    """Chunk-parallel mLSTM. Same contract as mlstm_recurrent."""
    b, h, t, hd = q.shape
    chunk = min(chunk, t)
    if t % chunk:
        raise ValueError(f"T={t} not divisible by chunk={chunk}")
    nc = t // chunk
    c_prev, n_prev, m_prev = _empty_state(q) if state is None else state

    def rs(x):                                           # (B, H, nc, L, ...)
        return x.reshape(b, h, nc, chunk, *x.shape[3:])

    qs, ks_, vs, lis, lfs = rs(q), rs(k), rs(v), rs(log_i), rs(log_f)
    l_idx = torch.arange(chunk, device=q.device)
    tri = l_idx[:, None] >= l_idx[None, :]               # s <= l
    hs = []
    for j in range(nc):
        qc, kc, vc = qs[:, :, j], ks_[:, :, j], vs[:, :, j]   # (B,H,L,hd)
        li, lf = lis[:, :, j], lfs[:, :, j]                   # (B,H,L)
        bcum = torch.cumsum(lf, dim=-1)
        # log intra scores: li[s] + b[l] - b[s], s <= l
        logw = li[..., None, :] + bcum[..., :, None] - bcum[..., None, :]
        logw = torch.where(tri, logw, -torch.inf)
        m_intra = torch.amax(logw, dim=-1)               # (B,H,L)
        m_state = m_prev[..., None] + bcum
        m_new = torch.maximum(m_state, m_intra)
        d = torch.exp(logw - m_new[..., None])           # (B,H,L,L) masked
        inter = torch.exp(m_state - m_new)               # (B,H,L)
        s_intra = torch.einsum("bhld,bhsd->bhls", qc, kc) * d
        num = torch.einsum("bhls,bhse->bhle", s_intra, vc) \
            + inter[..., None] * torch.einsum("bhld,bhde->bhle", qc, c_prev)
        nvec = torch.einsum("bhls,bhsd->bhld", d, kc) \
            + inter[..., None] * n_prev[..., None, :]
        den = torch.maximum(
            torch.abs(torch.einsum("bhld,bhld->bhl", qc, nvec)),
            torch.exp(-m_new))
        hs.append(num / den[..., None])
        # carry to the next chunk (the state at this chunk's last step)
        m_out = m_new[..., -1]                           # (B,H)
        w_end = torch.exp(li + bcum[..., -1:] - bcum - m_out[..., None])
        decay = torch.exp(m_prev + bcum[..., -1] - m_out)
        c_prev = decay[..., None, None] * c_prev \
            + torch.einsum("bhs,bhsd,bhse->bhde", w_end, kc, vc)
        n_prev = decay[..., None] * n_prev \
            + torch.einsum("bhs,bhsd->bhd", w_end, kc)
        m_prev = m_out
    return torch.stack(hs, dim=2).reshape(b, h, t, hd), (c_prev, n_prev,
                                                         m_prev)


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------

def init_mlstm(key: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
               *, lead: tuple = ()) -> dict:
    d = cfg.d_model
    h, hd = cfg.num_heads, cfg.head_dim
    dev = key.device
    s = d ** -0.5
    return {
        "ln": norms.init("layernorm", d, dtype, lead=lead, device=dev),
        "w_up": normal(key, (*lead, d, d), s, dtype),
        "w_gate": normal(key, (*lead, d, d), s, dtype),
        "conv_w": normal(key, (*lead, 4, d), 0.5, dtype),
        "conv_b": torch.zeros((*lead, d), dtype=dtype, device=dev),
        "wq": normal(key, (*lead, d, h * hd), s, dtype),
        "wk": normal(key, (*lead, d, h * hd), s, dtype),
        "wv": normal(key, (*lead, d, h * hd), s, dtype),
        "w_if": normal(key, (*lead, d, 2 * h), s, dtype),
        "b_if": torch.cat([torch.zeros((*lead, h), dtype=dtype, device=dev),
                           torch.full((*lead, h), 3.0, dtype=dtype,
                                      device=dev)], dim=-1),  # f-bias high
        "gn": {"scale": torch.ones((*lead, h * hd), dtype=dtype,
                                   device=dev)},
        "w_down": normal(key, (*lead, d, d), s, dtype),
    }


def _conv_silu(params, x, history=None):
    w = params["conv_w"].shape[0]
    b, t, d = x.shape
    if history is None:
        history = torch.zeros((b, w - 1, d), dtype=x.dtype, device=x.device)
    xx = torch.cat([history, x], dim=1)
    out = torch.zeros((b, t, d), dtype=x.dtype, device=x.device)
    for tap in range(w):
        out = out + xx[:, tap: tap + t] * params["conv_w"][tap].to(x.dtype)
    return F.silu(out + params["conv_b"].to(x.dtype)), xx[:, t:]


def _mlstm_in(params, xn, conv_hist=None):
    """(up, gate, the conv output cx, the new conv history) of the
    channels whose columns ``params`` holds."""
    dtype = xn.dtype
    up = xn @ fsdp_use(params["w_up"], "w_up", dtype)
    gate = xn @ fsdp_use(params["w_gate"], "w_gate", dtype)
    cx, new_hist = _conv_silu(params, up, conv_hist)
    return up, gate, cx, new_hist


def _mlstm_qkvg(cfg, params, cx, up, lo: int = 0):
    """q (pre-scaled), k, v (B,H,T,hd) f32 of the ``cfg.num_heads`` heads
    whose columns ``params`` holds (heads ``lo`` on of the ``w_if``'s)
    from the full-width cx and up, and their log gates (B,H,T)."""
    b, t, _ = cx.shape
    h, hd = cfg.num_heads, cfg.head_dim
    h_all = params["w_if"].shape[-1] // 2
    dtype = cx.dtype
    f32 = torch.float32
    q = (cx @ fsdp_use(params["wq"], "wq", dtype)).reshape(b, t, h, hd)
    k = (cx @ fsdp_use(params["wk"], "wk", dtype)).reshape(b, t, h, hd)
    v = (up @ fsdp_use(params["wv"], "wv", dtype)).reshape(b, t, h, hd)
    # in the compute dtype, then float32 (the reference's order); every
    # head's gates, then this shard's
    gif = (cx @ params["w_if"].to(dtype) + params["b_if"].to(dtype)).to(f32)
    log_i = gif[..., :h_all][..., lo:lo + h]
    log_f = F.logsigmoid(gif[..., h_all:])[..., lo:lo + h]

    def tb(x):                                           # (B,H,T,hd) f32
        return x.transpose(1, 2).to(f32)

    return (tb(q) * hd ** -0.5, tb(k), tb(v),
            log_i.transpose(1, 2), log_f.transpose(1, 2))


def mlstm_block(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
                chunk: int = 256, return_state: bool = False):
    """Full-sequence mLSTM block (train/prefill). Residual added by caller."""
    b, t, d = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    dtype = x.dtype
    xn = norms.apply("layernorm", params["ln"], x)
    up, gate, cx, hist = _mlstm_in(params, xn)
    q, k, v, li, lf = _mlstm_qkvg(cfg, params, cx, up)
    hs, (c, n, m) = mlstm_chunkwise(q, k, v, li, lf, chunk=min(chunk, t))
    hs = hs.transpose(1, 2).reshape(b, t, h * hd).to(dtype)
    hs = norms.apply("rmsnorm", params["gn"], hs)          # per-channel GN
    out = (hs * F.silu(gate)) @ fsdp_use(params["w_down"], "w_down", dtype)
    if return_state:
        state = MLSTMState(c=c, n=n, m=m, conv=hist.to(torch.float32), pos=t)
        return out, state
    return out


def init_mlstm_state(cfg: ModelConfig, batch: int, *, lead: tuple = (),
                     device=None) -> MLSTMState:
    h, hd, d = cfg.num_heads, cfg.head_dim, cfg.d_model
    f32 = torch.float32
    return MLSTMState(
        c=torch.zeros((*lead, batch, h, hd, hd), dtype=f32, device=device),
        n=torch.zeros((*lead, batch, h, hd), dtype=f32, device=device),
        m=torch.full((*lead, batch, h), -1e30, dtype=f32, device=device),
        conv=torch.zeros((*lead, batch, 3, d), dtype=f32, device=device),
        pos=0,
    )


def mlstm_block_decode(cfg: ModelConfig, params: dict, x: torch.Tensor,
                       state: MLSTMState
                       ) -> tuple[torch.Tensor, MLSTMState]:
    """One step; ``state`` is left as it was."""
    b, _, d = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    dtype = x.dtype
    xn = norms.apply("layernorm", params["ln"], x)
    up, gate, cx, hist = _mlstm_in(params, xn, state.conv.to(dtype))
    q, k, v, li, lf = _mlstm_qkvg(cfg, params, cx, up)
    hs, (c, n, m) = mlstm_recurrent(q, k, v, li, lf,
                                    state=(state.c, state.n, state.m))
    hs = hs.transpose(1, 2).reshape(b, 1, h * hd).to(dtype)
    hs = norms.apply("rmsnorm", params["gn"], hs)
    out = (hs * F.silu(gate)) @ fsdp_use(params["w_down"], "w_down", dtype)
    return out, MLSTMState(c=c, n=n, m=m, conv=hist.to(state.conv.dtype),
                           pos=state.pos + 1)


# ---------------------------------------------------------------------------
# mLSTM on a mesh (`distributed.spmd`): whole heads a model shard
# ---------------------------------------------------------------------------

# the model split each weight keeps: the up / gate / conv channels and
# the q / k / v heads (columns), the down projection's rows
_KEEP = {"w_up": (1,), "w_gate": (1,), "conv_w": (1,), "wq": (1,),
         "wk": (1,), "wv": (1,), "w_down": (0,)}
_CAST = ("w_up", "w_gate", "conv_w", "wq", "wk", "wv", "w_if", "w_down")


def mlstm_splits(lay, cfg: ModelConfig, params: dict) -> bool:
    """Whether the mLSTM block runs head-split on ``lay``: one shard, or
    whole heads a model shard (H divisible by M, ``w_up``'s and ``wq``'s
    columns split over ``model``); else (xlstm-125m's smoke config has 2
    heads) it runs whole on each batch group's owner, its matrix state's
    head_dim rows split over ``model`` as `cache_shardings` says."""
    from repro_torch.distributed import spmd
    return lay.n_model == 1 or (
        cfg.num_heads % lay.n_model == 0
        and spmd.splits_model(params["w_up"], 1)
        and spmd.splits_model(params["wq"], 1))


def _mlstm_shard(lay, cfg: ModelConfig, params: dict, dtype):
    """(the shard's config, the group owners' layer norms, each
    position's weights: its channels and heads, ``w_if`` gathered whole,
    its slices of the replicated ``conv_b`` and ``gn`` scale)."""
    import dataclasses

    from repro_torch.distributed import spmd
    m = lay.n_model
    lcfg = dataclasses.replace(cfg, num_heads=cfg.num_heads // m)
    ln = spmd.gather_tree(lay, params["ln"], users=lay.owners())
    a = spmd.gather_tree(lay, {k: params[k] for k in _CAST}, dtype=dtype,
                         keep=_KEEP)
    b = spmd.gather_tree(lay, {k: params[k] for k in ("conv_b", "b_if",
                                                      "gn")}, keep=_KEEP)
    w = []
    for i in lay.positions():
        p = {**a[i], **b[i]}
        dl = p["w_up"].shape[-1]
        sl = slice((i % m) * dl, (i % m + 1) * dl)
        w.append(dict(p, conv_b=p["conv_b"][..., sl],
                      gn={"scale": p["gn"]["scale"][..., sl]}))
    return lcfg, ln, w


def _split_rms(lay, w: list, parts: list, eps: float = 1e-6) -> list:
    """``gn`` (an RMS norm over all H * hd channels) of one channel-split
    share a position: the shares' sums of squares folded over ``model``
    into the one statistic, each share scaled by its channels' scale."""
    from repro_torch.distributed import spmd
    if lay.n_model == 1:
        return [norms.apply("rmsnorm", p["gn"], x, eps=eps)
                for p, x in zip(w, parts)]
    f32 = torch.float32
    width = parts[0].shape[-1] * lay.n_model
    tot = spmd.model_allsum(lay, [torch.sum(torch.square(x.to(f32)), -1,
                                            keepdim=True) for x in parts])
    return [(x.to(f32) * torch.rsqrt(s / width + eps)
             * p["gn"]["scale"].to(f32)).to(x.dtype)
            for p, x, s in zip(w, parts, tot)]


def _mlstm_mesh(lay, cfg, params, xg, cell, hist=None):
    """The mLSTM block on the mesh: the layer norm on each group's owner,
    each shard's channels of up / gate / conv, cx and up gathered over
    ``model`` (q / k read every channel), the shard's heads through
    ``cell(i, q, k, v, log_i, log_f)`` -> (h (B,H/M,T,hd), state), the
    ``gn`` statistic folded over ``model``, the ``w_down`` partials
    summed. Returns (one output a group, each position's cell state, each
    position's new conv history)."""
    from repro_torch.distributed import spmd
    dtype = xg[0].dtype
    lcfg, ln, w = _mlstm_shard(lay, cfg, params, dtype)
    xn = [norms.apply("layernorm", ln[g], x) for g, x in enumerate(xg)]
    xs = spmd.replicate(lay, xn)
    ins = [_mlstm_in(w[i], xs[i], None if hist is None else hist[i])
           for i in lay.positions()]
    cx = spmd.model_gather(lay, [x[2] for x in ins], -1)
    up = spmd.model_gather(lay, [x[0] for x in ins], -1)
    hs, states = [], []
    for i in lay.positions():
        qkvg = _mlstm_qkvg(lcfg, w[i], cx[i], up[i],
                           lo=(i % lay.n_model) * lcfg.num_heads)
        h, st = cell(i, *qkvg)
        b, _, t, hd = h.shape
        hs.append(h.transpose(1, 2).reshape(b, t, -1).to(dtype))
        states.append(st)
    hs = _split_rms(lay, w, hs)
    out = spmd.model_sum(lay, [
        (h * F.silu(x[1])) @ fsdp_use(p["w_down"], "w_down", dtype)
        for h, x, p in zip(hs, ins, w)])
    return out, states, [x[3] for x in ins]


def _group_cat(lay, parts: list, g: int, dim: int) -> torch.Tensor:
    """Group ``g``'s positions' shares concatenated along ``dim`` on its
    owner (no autograd: a cache's replicated leaf)."""
    m = lay.n_model
    dev = lay.group_dev(g)
    return torch.cat([p.to(dev) for p in parts[g * m:(g + 1) * m]], dim)


def mesh_mlstm_full(lay, cfg: ModelConfig, params: dict, xg: list, *,
                    chunk: int = 256, fill: bool = False):
    """`mlstm_block` of one (B_g, T, D) tensor a batch group on the mesh
    of ``lay`` (`mlstm_splits`; `_mlstm_mesh`). Returns (one output a
    group, with ``fill`` the final state as blocks per `cache_shardings`:
    C and n each shard's heads, m and the conv history whole on each
    position; else None)."""
    t = xg[0].shape[1]

    def cell(i, q, k, v, li, lf):
        return mlstm_chunkwise(q, k, v, li, lf, chunk=min(chunk, t))

    out, states, hists = _mlstm_mesh(lay, cfg, params, xg, cell)
    if not fill:
        return out, None
    f32 = torch.float32
    if lay.single:
        (c, n, m), = states
        return out, MLSTMState(c=c, n=n, m=m, conv=hists[0].to(f32), pos=t)
    from repro_torch.distributed import spmd
    c0, n0, _ = states[0]
    groups = range(lay.n_groups)
    m_rows = [_group_cat(lay, [s[2] for s in states], g, -1) for g in groups]
    conv_rows = [_group_cat(lay, hists, g, -1).to(f32) for g in groups]
    tmpl = MLSTMState(
        c=torch.empty((c0.shape[0], cfg.num_heads, *c0.shape[2:]),
                      device="meta"),
        n=torch.empty((n0.shape[0], cfg.num_heads, n0.shape[2]),
                      device="meta"), m=m_rows[0], conv=conv_rows[0], pos=t)
    specs = spmd.state_specs(lay, tmpl)
    g_rows = c0.shape[0] * lay.n_groups
    return out, MLSTMState(
        c=spmd.place_blocks(lay, specs.c, (g_rows, *tmpl.c.shape[1:]),
                            [s[0] for s in states]),
        n=spmd.place_blocks(lay, specs.n, (g_rows, *tmpl.n.shape[1:]),
                            [s[1] for s in states]),
        m=spmd.place_rows(lay, specs.m, m_rows),
        conv=spmd.place_rows(lay, specs.conv, conv_rows), pos=t)


def mesh_mlstm_decode(lay, cfg: ModelConfig, params: dict, xg: list,
                      state: MLSTMState):
    """`mlstm_block_decode` on the mesh of ``lay`` (`mlstm_splits`): each
    shard steps its heads' C and n blocks in place; m and the conv
    history, whole on every position, are written back from the shards'
    shares. Returns (one output a group, the state)."""
    from repro_torch.distributed import spmd
    m = lay.n_model
    hl = cfg.num_heads // m
    dtype = xg[0].dtype

    def block(leaf, i):
        return leaf if lay.single else leaf.blocks[lay.coords[i]]

    conv = [block(state.conv, i) for i in lay.positions()]
    dl = conv[0].shape[-1] // m
    hist = [conv[i][..., (i % m) * dl:(i % m + 1) * dl].to(dtype)
            for i in lay.positions()]

    def cell(i, q, k, v, li, lf):
        j = i % m
        return mlstm_recurrent(q, k, v, li, lf, state=(
            block(state.c, i), block(state.n, i),
            block(state.m, i)[:, j * hl:(j + 1) * hl]))

    out, states, hists = _mlstm_mesh(lay, cfg, params, xg, cell, hist)
    for i, (c, n, _) in enumerate(states):
        block(state.c, i).copy_(c)
        block(state.n, i).copy_(n)
    for g in range(lay.n_groups):
        spmd.write_rows(lay, state.m, g,
                        _group_cat(lay, [s[2] for s in states], g, -1))
        spmd.write_rows(lay, state.conv, g, _group_cat(lay, hists, g, -1)
                        .to(state.conv.dtype))
    return out, state._replace(pos=state.pos + 1)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTMState(NamedTuple):
    h: torch.Tensor   # (B, D)
    c: torch.Tensor   # (B, D)
    n: torch.Tensor   # (B, D)
    m: torch.Tensor   # (B, D)
    pos: int


def init_slstm(key: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
               *, lead: tuple = ()) -> dict:
    d = cfg.d_model
    h = cfg.num_heads
    hd = d // h
    dev = key.device
    s = d ** -0.5

    def const(n, value):
        return torch.full((*lead, n), value, dtype=dtype, device=dev)

    return {
        "ln": norms.init("layernorm", d, dtype, lead=lead, device=dev),
        # input weights for 4 gates (i, f, z, o)
        "w": normal(key, (*lead, d, 4 * d), s, dtype),
        # block-diagonal recurrent weights: (H, hd, 4*hd) per head
        "r": normal(key, (*lead, h, hd, 4 * hd), hd ** -0.5, dtype),
        "b": torch.cat([const(d, 0.0), const(d, 3.0),      # f bias high
                        const(2 * d, 0.0)], dim=-1),
        "gn": {"scale": const(d, 1.0)},
        "w_down": normal(key, (*lead, d, d), s, dtype),
        "w_gate": normal(key, (*lead, d, d), s, dtype),
    }


def _slstm_step(cfg, params, xt, state):
    """One sLSTM step. xt: (B, 4D) pre-projected input contribution."""
    b = xt.shape[0]
    d = cfg.d_model
    h = cfg.num_heads
    hd = d // h
    f32 = torch.float32
    hh = state.h.to(f32).reshape(b, h, hd)
    rec = torch.einsum("bhd,hde->bhe", hh,
                       params["r"].to(f32)).reshape(b, 4 * d)
    g = xt.to(f32) + rec + params["b"].to(f32)
    gi, gf, gz, go = torch.split(g, d, dim=-1)
    log_i = gi
    log_f = F.logsigmoid(gf)
    m_new = torch.maximum(log_f + state.m, log_i)
    ip = torch.exp(log_i - m_new)
    fp = torch.exp(log_f + state.m - m_new)
    z = torch.tanh(gz)
    o = torch.sigmoid(go)
    c = fp * state.c + ip * z
    n = fp * state.n + ip
    h_new = o * c / torch.clamp_min(n, EPS)
    return SLSTMState(h=h_new, c=c, n=n, m=m_new, pos=state.pos + 1), h_new


def init_slstm_state(cfg: ModelConfig, batch: int, *, lead: tuple = (),
                     device=None) -> SLSTMState:
    d = cfg.d_model

    def full(value):
        return torch.full((*lead, batch, d), value, dtype=torch.float32,
                          device=device)

    return SLSTMState(h=full(0.0), c=full(0.0), n=full(0.0), m=full(-1e30),
                      pos=0)


def slstm_block(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
                return_state: bool = False):
    """Sequential sLSTM block over (B, T, D): a loop over T."""
    b, t, d = x.shape
    dtype = x.dtype
    xn = norms.apply("layernorm", params["ln"], x)
    gate = xn @ fsdp_use(params["w_gate"], "w_gate", dtype)
    xg = xn @ fsdp_use(params["w"], "w", dtype)            # (B, T, 4D)
    state = init_slstm_state(cfg, b, device=x.device)
    hs = []
    for i in range(t):
        state, h = _slstm_step(cfg, params, xg[:, i], state)
        hs.append(h)
    hs = torch.stack(hs, dim=1).to(dtype)                  # (B, T, D)
    hs = norms.apply("rmsnorm", params["gn"], hs)
    out = (hs * F.silu(gate)) @ fsdp_use(params["w_down"], "w_down", dtype)
    if return_state:
        return out, state
    return out


def slstm_block_decode(cfg: ModelConfig, params: dict, x: torch.Tensor,
                       state: SLSTMState
                       ) -> tuple[torch.Tensor, SLSTMState]:
    """One step; ``state`` is left as it was."""
    dtype = x.dtype
    xn = norms.apply("layernorm", params["ln"], x)
    gate = xn[:, 0] @ params["w_gate"].to(dtype)
    xg = xn[:, 0] @ params["w"].to(dtype)
    state, h = _slstm_step(cfg, params, xg, state)
    h = norms.apply("rmsnorm", params["gn"], h.to(dtype))
    out = (h * F.silu(gate)) @ fsdp_use(params["w_down"], "w_down", dtype)
    return out[:, None], state
