"""Mixture-of-Experts with sort-based dispatch + optional Sinkhorn router.

Port of `repro.models.layers.moe`. Dispatch is **sort-based** (argsort
tokens by expert, gather into (E, C, D) groups, batched expert matmul,
gather back): gathers cost bytes, not FLOPs. Tokens beyond per-expert
capacity C are dropped (standard).

Routers:
  * ``topk``     -- softmax gate, faithful to mixtral/deepseek.
  * ``sinkhorn`` -- the paper's technique as a first-class framework feature:
    token->expert assignment is an entropy-regularized OT problem (uniform
    expert marginal = perfect balance), solved with the same Sinkhorn-Knopp
    core (`repro_torch.core.ot`). The transport plan replaces the softmax
    probabilities before top-k.

The combine has a fixed order. The reference scatter-adds each kept
contribution into its token (``.at[sorted_tok].add``); on the card an
index-add uses float atomics, whose order is not fixed. The port puts
each kept contribution back at its (token, choice) place through the
inverse of the sort and sums a token's ``top_k`` choices left to right,
so two runs give the same bits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core.ot import sinkhorn_plan
from repro_torch.models.layers import mlp
from repro_torch.models.layers._random import normal
from repro_torch.models.sharding_hints import (fsdp_use, hint_moe_hidden,
                                               hint_moe_tokens)


def init(key: torch.Generator, cfg: ModelConfig, dtype=torch.float32, *,
         lead: tuple = ()) -> dict:
    e = cfg.moe
    d = cfg.d_model
    s_in, s_out = d ** -0.5, e.d_ff_expert ** -0.5
    params = {
        "router": normal(key, (*lead, d, e.num_experts), s_in, dtype),
        "wi_gate": normal(key, (*lead, e.num_experts, d, e.d_ff_expert),
                          s_in, dtype),
        "wi_up": normal(key, (*lead, e.num_experts, d, e.d_ff_expert),
                        s_in, dtype),
        "wo": normal(key, (*lead, e.num_experts, e.d_ff_expert, d),
                     s_out, dtype),
    }
    if e.num_shared > 0:
        params["shared"] = mlp.init(
            key, "silu_glu", d, e.num_shared * e.d_ff_expert, dtype,
            lead=lead)
    return params


def _top_k(scores: torch.Tensor, k: int):
    """The ``k`` largest of each row, in descending order, equal values in
    index order (as ``jax.lax.top_k``). `torch.topk` leaves the order of
    equal values open, and it can differ between launches of other shapes:
    bfloat16 router logits tie often, and a tie broken one way in the
    prefill and the other in the decode step routes a token to another
    expert."""
    values, ids = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], ids[..., :k]


def _sinkhorn_scores(e: MoEConfig, cost: torch.Tensor) -> torch.Tensor:
    """The transport plan times T (rows ~ sum to 1) of the (T, E) costs:
    the reference's float32 Sinkhorn, uniform token mass onto a uniform
    expert marginal, in the cost's dtype."""
    t = cost.shape[0]
    a = torch.full((t,), 1.0 / t, dtype=cost.dtype, device=cost.device)
    b = torch.full((e.num_experts,), 1.0 / e.num_experts, dtype=cost.dtype,
                   device=cost.device)
    plan = sinkhorn_plan(cost, a, b, lamb=e.sinkhorn_lamb,
                         max_iter=e.sinkhorn_iters).plan
    return plan * t


class _SinkhornScores(torch.autograd.Function):
    """`_sinkhorn_scores`: the forward is the reference's float32 loop, bit
    for bit; its gradient is taken through the same loop in float64. The
    float32 backward overflows (the derivative of ``b / (K^T u)`` is
    ``-b / (K^T u)^2``: inf, then inf * 0 in the exponential's backward)
    once an expert's column of K fades -- in the reference too
    (`tests/test_torch_train.py`), and in deepseek-moe-16b at full width
    after one AdamW step (chip_smoke.py phase 14)."""

    @staticmethod
    def forward(ctx, cost, e):
        ctx.save_for_backward(cost)
        ctx.e = e
        return _sinkhorn_scores(e, cost)

    @staticmethod
    def backward(ctx, g):
        (cost,) = ctx.saved_tensors
        with torch.enable_grad():
            c64 = cost.detach().to(torch.float64).requires_grad_(True)
            (grad,) = torch.autograd.grad(_sinkhorn_scores(ctx.e, c64), c64,
                                          g.to(torch.float64))
        return grad.to(cost.dtype), None


def _gates(e: MoEConfig, logits: torch.Tensor):
    """(T, E) routing logits -> (T, k) expert ids + normalized weights + aux."""
    lf = logits.to(torch.float32)
    probs = torch.softmax(lf, dim=-1)
    if e.router == "sinkhorn":
        # OT: uniform token mass -> uniform expert marginal (balanced).
        scores = _SinkhornScores.apply(-torch.log_softmax(lf, dim=-1), e)
    elif e.router == "topk":
        scores = probs
    else:
        raise ValueError(f"unknown router {e.router!r}")
    weights, ids = _top_k(scores, e.top_k)                 # (T, k)
    weights = weights / torch.clamp_min(
        torch.sum(weights, dim=-1, keepdim=True), 1e-9)
    # switch-style load-balance aux: E * sum_e f_e * p_e
    assign = F.one_hot(ids[:, 0], e.num_experts).to(torch.float32)
    f_e = torch.mean(assign, dim=0)
    p_e = torch.mean(probs, dim=0)
    aux = e.num_experts * torch.sum(f_e * p_e)
    return ids, weights, aux


def _dispatch_group(e: MoEConfig, xg: torch.Tensor, ids: torch.Tensor,
                    weights: torch.Tensor, cap: int):
    """Group-local sort-based dispatch, over a leading batch of groups.
    xg (B, Tg, D); ids/weights (B, Tg, k). Returns grouped (B, E, C, D) and
    the combine metadata; every index op stays inside its group."""
    b, tg, d = xg.shape
    k = e.top_k
    dev = xg.device
    flat_exp = ids.reshape(b, tg * k)         # (token, choice) row-major
    flat_w = weights.reshape(b, tg * k)
    order = torch.argsort(flat_exp, dim=-1, stable=True)
    sorted_exp = torch.gather(flat_exp, 1, order)
    sorted_w = torch.gather(flat_w, 1, order)
    counts = torch.zeros((b, e.num_experts), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, sorted_exp, torch.ones_like(sorted_exp))
    starts = torch.cumsum(counts, dim=1) - counts
    pos_in_exp = torch.arange(tg * k, device=dev) \
        - torch.gather(starts, 1, sorted_exp)
    keep = pos_in_exp < cap
    slot = torch.where(keep, sorted_exp * cap + pos_in_exp,
                       e.num_experts * cap)
    rows = torch.arange(b, device=dev)[:, None]
    # overflow writes land in the extra slot E*cap, which is cut off
    buf = torch.zeros((b, e.num_experts * cap + 1, d), dtype=xg.dtype,
                      device=dev)
    # each token read once a choice, from its k-fold expand: the gradient
    # is written once a (token, choice) and summed over the choices by the
    # expand's backward, with no index-add (whose float atomics on the card
    # add duplicates in no fixed order)
    xk = xg[:, :, None, :].expand(b, tg, k, d)
    buf[rows, slot] = xk[rows, order // k, order % k]
    grouped = buf[:, :-1].reshape(b, e.num_experts, cap, d)
    return grouped, (keep, slot, order, sorted_w)


def _combine_group(meta, y: torch.Tensor, tg: int, d: int):
    """y (B, E, C, D) -> (B, Tg, D): each kept contribution at its (token,
    choice) place, the choices summed left to right."""
    keep, slot, order, sorted_w = meta
    b = y.shape[0]
    k = keep.shape[1] // tg
    yf = y.reshape(b, -1, d)                                # (B, E*C, D)
    rows = torch.arange(b, device=y.device)[:, None]
    contrib = yf[rows, torch.clamp_max(slot, yf.shape[1] - 1)] \
        * sorted_w[..., None].to(y.dtype)
    contrib = torch.where(keep[..., None], contrib,
                          torch.zeros((), dtype=y.dtype, device=y.device))
    placed = torch.empty_like(contrib)
    placed[rows, order] = contrib          # the inverse of the sort
    placed = placed.reshape(b, tg, k, d)
    out = placed[:, :, 0]
    for j in range(1, k):
        out = out + placed[:, :, j]
    return out


def apply(cfg: ModelConfig, params: dict, x: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B,S,D), aux_loss scalar).

    Grouped sort-based dispatch: each batch row is a dispatch group
    (GShard's group-local capacity); the reference ``vmap``s the pipeline
    over the batch axis, the port runs it batched over that axis.

    Capacity C = max(int(S * top_k * cf / E + 1), top_k) per group;
    overflow drops are group-local (standard GShard semantics).
    """
    e = cfg.moe
    b, s, d = x.shape
    logits = x.reshape(b * s, d) @ params["router"].to(x.dtype)  # (T, E)
    ids, weights, aux = _gates(e, logits)                   # (T, k)
    out = experts(cfg, params, x, ids, weights)
    return out, aux.to(torch.float32)


def capacity(e: MoEConfig, s: int) -> int:
    """Slots an expert a dispatch group (one sequence of ``s`` tokens)."""
    return max(int(s * e.top_k * e.capacity_factor / e.num_experts + 1),
               e.top_k)


def dispatch(cfg: ModelConfig, x: torch.Tensor, ids: torch.Tensor,
             weights: torch.Tensor):
    """x (B,S,D), ids / weights (B*S, k) -> the experts' input (E, B*C, D)
    and the combine metadata."""
    e = cfg.moe
    b, s, d = x.shape
    cap = capacity(e, s)
    grouped, meta = _dispatch_group(e, x, ids.reshape(b, s, e.top_k),
                                    weights.reshape(b, s, e.top_k), cap)
    rep_dec = (b * cap) < (3 * e.d_ff_expert) // 8
    grouped = hint_moe_tokens(grouped, rep_dec)             # (B,E,C,D)
    # "becd,edf->becf" as one batched matmul an expert: (E, B*C, D)
    xe = grouped.permute(1, 0, 2, 3).reshape(e.num_experts, b * cap, d)
    return xe, meta


def combine(cfg: ModelConfig, meta, y: torch.Tensor, b: int, s: int
            ) -> torch.Tensor:
    """The experts' output (E, B*C, D) -> (B, S, D)."""
    e = cfg.moe
    d = y.shape[-1]
    cap = capacity(e, s)
    rep_dec = (b * cap) < (3 * e.d_ff_expert) // 8
    y = y.reshape(e.num_experts, b, cap, d).permute(1, 0, 2, 3)
    y = hint_moe_tokens(y, rep_dec)
    return _combine_group(meta, y, s, d)


def experts(cfg: ModelConfig, params: dict, x: torch.Tensor,
            ids: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The routed experts (dispatch, the three batched matmuls, combine)
    and the shared experts of x (B, S, D) routed by ids / weights (B*S,
    k): (B, S, D). On a mesh, a model shard's share of every expert's
    hidden units (a partial sum over the shards)."""
    e = cfg.moe
    b, s, d = x.shape
    dtype = x.dtype
    xe, meta = dispatch(cfg, x, ids, weights)
    rep_dec = xe.shape[1] < (3 * e.d_ff_expert) // 8
    gate = torch.bmm(xe, fsdp_use(params["wi_gate"], "wi_gate", dtype))
    up = torch.bmm(xe, fsdp_use(params["wi_up"], "wi_up", dtype))
    h = hint_moe_hidden(F.silu(gate) * up, rep_dec)         # (E,B*C,F)
    y = torch.bmm(h, fsdp_use(params["wo"], "wo", dtype))   # (E,B*C,D)
    out = combine(cfg, meta, y, b, s)
    if e.num_shared > 0:
        out = out + mlp.apply("silu_glu", params["shared"],
                              x.reshape(b * s, d)).reshape(b, s, d)
    return out.reshape(b, s, d)


_KEEP = {"wi_gate": (2,), "wi_up": (2,), "wo": (1,)}


def mesh_apply(lay, cfg: ModelConfig, params: dict, xn: list, *,
               decode: bool = False) -> tuple[list, torch.Tensor]:
    """`apply` of one (B_g, S, D) tensor a batch group on the mesh of
    ``lay``: (one output a group, the aux loss).

    The router stays global: the groups' float32 logits are gathered
    (`spmd.gather_rows`), each group runs `_gates` on all T tokens of the
    call (the reference's Sinkhorn balances them, uniform marginals 1/T
    and 1/E) and keeps its own rows; the aux loss is group 0's. Dispatch
    groups are sequences, so a group's dispatch and drops are the global
    ones. Each model shard computes its share of every expert's hidden
    units (and the shared experts'), and the partials are summed. At
    ``decode`` the 3-D expert weights stay where they are (the reference's
    decode rule): tokens are gathered to them over ``data``
    (`_experts_in_place`)."""
    from repro_torch.distributed import spmd
    e = cfg.moe
    dtype = xn[0].dtype
    d = xn[0].shape[-1]
    router = spmd.gather(lay, params["router"], dtype=dtype,
                         users=lay.owners())
    logits = [x.reshape(-1, d) @ r.to(dtype) for x, r in zip(xn, router)]
    if lay.n_groups == 1:
        ids, weights, aux = _gates(e, logits[0])
        ids, weights = [ids], [weights]
    else:
        full = spmd.gather_rows(lay, [lg.to(torch.float32) for lg in logits])
        ids, weights, auxes, lo = [], [], [], 0
        for g, lg in enumerate(logits):
            i_g, w_g, a_g = _gates(e, full[g])
            n = lg.shape[0]
            ids.append(i_g[lo:lo + n])
            weights.append(w_g[lo:lo + n])
            auxes.append(a_g)
            lo += n
        aux = auxes[0]
    if lay.n_model > 1 and not spmd.splits_model(params["wi_gate"], 2):
        w = spmd.gather_tree(lay, params, dtype=dtype, users=lay.owners())
        out = [experts(cfg, w[g], xn[g], ids[g], weights[g])
               for g in range(lay.n_groups)]
        return out, aux.to(torch.float32)
    m = lay.n_model
    xs = spmd.replicate(lay, xn)
    if decode and lay.n_data > 1:
        parts = _experts_in_place(lay, cfg, params, xn, ids, weights)
        if e.num_shared > 0:
            sh = spmd.gather_tree(lay, params["shared"], dtype=dtype,
                                  keep=mlp._KEEP)
            for i in lay.positions():
                b, s, _ = xs[i].shape
                parts[i] = parts[i] + mlp.apply(
                    "silu_glu", sh[i], xs[i].reshape(b * s, d)
                ).reshape(b, s, d)
    else:
        w = spmd.gather_tree(lay, {k: params[k] for k in _KEEP},
                             dtype=dtype, keep=_KEEP)
        if e.num_shared > 0:
            sh = spmd.gather_tree(lay, params["shared"], dtype=dtype,
                                  keep=mlp._KEEP)
            for i in lay.positions():
                w[i]["shared"] = sh[i]
        ws = spmd.replicate(lay, weights)
        parts = [experts(cfg, w[i], xs[i], ids[i // m].to(lay.dev(i)), ws[i])
                 for i in lay.positions()]
    return spmd.model_sum(lay, parts), aux.to(torch.float32)


def _experts_in_place(lay, cfg: ModelConfig, params: dict, xn: list,
                      ids: list, weights: list) -> list:
    """The routed experts at decode with the 3-D weights where they lie
    (no gradient): each position multiplies its own blocks. Its pod's
    dispatched tokens are gathered to it over ``data``; the partial
    products over the ``data``-split contraction (D for ``wi_*``) are
    folded in data-shard order; each position's ``wo`` block gives its
    D-slice of the output, and a group's rows of every slice, gathered
    back, are its model shard's partial. One partial a position."""
    from repro_torch.distributed import spmd
    from repro_torch.distributed.partitioning import block_slices
    e = cfg.moe
    m, nd = lay.n_model, lay.n_data
    dtype = xn[0].dtype
    b, s, d = xn[0].shape
    disp = [dispatch(cfg, xn[g], ids[g], weights[g])
            for g in range(lay.n_groups)]               # (E, B_g*C, D)
    nrow = disp[0][0].shape[1]
    pl = {k: params[k] for k in ("wi_gate", "wi_up", "wo")}

    def cut(k, i):                # position i's block of leaf k, its slices
        c = lay.coords[i]
        return pl[k].blocks[c], block_slices(lay.mesh, pl[k].spec,
                                             pl[k].shape, c)

    out = {}
    for p in range(lay.n_groups // nd):
        gs = range(p * nd, (p + 1) * nd)                # the pod's groups
        for j in range(m):
            pos = [lay.pos(g, j) for g in gs]
            x_all = {i: torch.cat([disp[h][0].to(lay.dev(i)) for h in gs], 1)
                     for i in pos}                      # (E, N, D)
            acc = {}
            for k in ("wi_gate", "wi_up"):
                parts = []
                for i in pos:
                    blk, r = cut(k, i)
                    parts.append(torch.bmm(x_all[i][:, :, r[1]],
                                           blk.to(dtype)))
                    if pl[k].spec[1] is None:
                        break                           # D not split
                acc[k] = spmd.fold(parts, lay.dev(pos[0]), dtype)
            hid = F.silu(acc["wi_gate"]) * acc["wi_up"]       # (E, N, F/M)
            ys = {}                        # each position's D-slice, all rows
            for i in pos:
                blk, r = cut("wo", i)
                ys[i] = (torch.bmm(hid.to(lay.dev(i)), blk.to(dtype)), r[2])
            for dd, (g, i) in enumerate(zip(gs, pos)):
                dev = lay.dev(i)
                y = torch.empty((e.num_experts, nrow, d), dtype=dtype,
                                device=dev)
                for part, cols in ys.values():
                    y[:, :, cols] = part[:, dd * nrow:(dd + 1) * nrow].to(dev)
                meta = tuple(t.to(dev) for t in disp[g][1])
                out[i] = combine(cfg, meta, y, b, s)
    return [out[i] for i in lay.positions()]
