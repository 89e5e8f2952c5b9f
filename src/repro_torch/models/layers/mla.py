"""Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style).

Port of `repro.models.layers.mla`. Queries go through a low-rank
bottleneck (q_lora); keys/values are generated from a shared compressed
latent c_kv (kv_lora) plus one rope-carrying key channel shared across
heads. The decode cache stores ONLY (c_kv, k_rope) -- the latent
compression that is MLA's point: cache bytes per token are
(kv_lora + rope_dim) instead of 2*H*hd.

Two decode variants:
  * ``fwd_decode``           -- naive: re-expands K/V from the latent for all
                                cached positions each step
                                (O(S * kv_lora * H * (nope+v)) FLOPs/step).
  * ``fwd_decode_absorbed``  -- folds W_uk into the query and W_uv into the
                                output projection (in float32), attending
                                directly in latent space
                                (O(S * (kv_lora+rope)) per head). The
                                config's default (``mla_absorbed``).

Both decodes take ``donate`` as `attention.fwd_decode` does: write the new
token's latent into ``cache``'s buffers in place (they are the returned
cache's), or leave ``cache`` as it was. An `MLACache`'s ``pos`` is a
Python int.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import norms
from repro_torch.models.layers._random import normal
from repro_torch.models.layers.attention import blockwise_attention
from repro_torch.models.layers.rope import apply_rope
from repro_torch.models.sharding_hints import fsdp_use

NEG_INF = -1e30


class MLACache(NamedTuple):
    c_kv: torch.Tensor    # (B, S, kv_lora)        compressed latent
    k_rope: torch.Tensor  # (B, S, rope_dim)       shared rope key channel
    pos: int              # number of tokens already written


def init(key: torch.Generator, cfg: ModelConfig, dtype=torch.float32, *,
         lead: tuple = ()) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    dev = key.device
    s = d ** -0.5
    return {
        "wq_down": normal(key, (*lead, d, m.q_lora_rank), s, dtype),
        "q_norm": norms.init("rmsnorm", m.q_lora_rank, dtype, lead=lead,
                             device=dev),
        "wq_up": normal(key, (*lead, m.q_lora_rank, h * qk),
                        m.q_lora_rank ** -0.5, dtype),
        "wkv_down": normal(key, (*lead, d, m.kv_lora_rank
                                 + m.qk_rope_head_dim), s, dtype),
        "kv_norm": norms.init("rmsnorm", m.kv_lora_rank, dtype, lead=lead,
                              device=dev),
        "wkv_up": normal(key, (*lead, m.kv_lora_rank,
                               h * (m.qk_nope_head_dim + m.v_head_dim)),
                         m.kv_lora_rank ** -0.5, dtype),
        "wo": normal(key, (*lead, h * m.v_head_dim, d),
                     (h * m.v_head_dim) ** -0.5, dtype),
    }


def _project_q(cfg: ModelConfig, params: dict, x: torch.Tensor,
               positions: torch.Tensor):
    """-> q_nope (B,T,H,nope), q_rope (B,T,H,rope) with rope applied."""
    m = cfg.mla
    h = cfg.num_heads
    b, t, _ = x.shape
    dtype = x.dtype
    ql = x @ fsdp_use(params["wq_down"], "wq_down", dtype)
    ql = norms.apply("rmsnorm", params["q_norm"], ql)
    q = (ql @ fsdp_use(params["wq_up"], "wq_up", dtype)).reshape(
        b, t, h, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        theta=cfg.rope_theta)
    return q_nope, q_rope


def _project_kv_latent(cfg: ModelConfig, params: dict, x: torch.Tensor,
                       positions: torch.Tensor):
    """-> c_kv (B,T,kv_lora) normalized, k_rope (B,T,rope) with rope."""
    m = cfg.mla
    dtype = x.dtype
    kvd = x @ fsdp_use(params["wkv_down"], "wkv_down", dtype)
    c_kv = norms.apply("rmsnorm", params["kv_norm"],
                       kvd[..., :m.kv_lora_rank])
    k_rope = apply_rope(kvd[..., m.kv_lora_rank:][:, :, None, :],
                        positions, theta=cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def _expand_kv(cfg: ModelConfig, params: dict, c_kv: torch.Tensor):
    """latent -> k_nope (B,S,H,nope), v (B,S,H,v)."""
    m = cfg.mla
    h = cfg.num_heads
    b, s, _ = c_kv.shape
    kv = (c_kv @ fsdp_use(params["wkv_up"], "wkv_up", c_kv.dtype)).reshape(
        b, s, h, m.qk_nope_head_dim + m.v_head_dim)
    return kv[..., :m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]


def fwd_full(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
             positions=None, q_block: int = 512,
             kv_block: int = 1024, return_latent: bool = False):
    """Train / prefill MLA, blockwise. Returns (B, T, D) (+ latents)."""
    m = cfg.mla
    b, t, _ = x.shape
    h = cfg.num_heads
    dtype = x.dtype
    pos = positions if positions is not None \
        else torch.arange(t, device=x.device)
    q_nope, q_rope = _project_q(cfg, params, x, pos)
    c_kv, k_rope = _project_kv_latent(cfg, params, x, pos)
    k_nope, v = _expand_kv(cfg, params, c_kv)
    # assemble full-rank q/k with the shared rope channel appended
    q = torch.cat([q_nope, q_rope], dim=-1)                # (B,T,H,qk)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, t, h, m.qk_rope_head_dim)], dim=-1)
    # v padded to qk width so the shared blockwise attention applies (a
    # group axis of 1); sliced back
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    v_pad = F.pad(v, (0, qk - m.v_head_dim))
    out = blockwise_attention(q[:, :, :, None, :], k, v_pad,
                              causal=True, q_block=q_block,
                              kv_block=kv_block)
    out = out[:, :, :, 0, : m.v_head_dim].reshape(b, t, h * m.v_head_dim)
    out = out @ fsdp_use(params["wo"], "wo", dtype)
    if return_latent:
        return out, (c_kv, k_rope)
    return out


def fill_cache(cfg: ModelConfig, c_kv: torch.Tensor, k_rope: torch.Tensor,
               max_len: int, dtype=torch.bfloat16) -> MLACache:
    b, t, _ = c_kv.shape
    cache = init_cache(cfg, b, max_len, dtype, device=c_kv.device)
    cache.c_kv[:, :t] = c_kv.to(dtype)
    cache.k_rope[:, :t] = k_rope.to(dtype)
    return cache._replace(pos=t)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, lead: tuple = (),
               device=None) -> MLACache:
    m = cfg.mla
    return MLACache(
        c_kv=torch.zeros((*lead, batch, max_len, m.kv_lora_rank),
                         dtype=dtype, device=device),
        k_rope=torch.zeros((*lead, batch, max_len, m.qk_rope_head_dim),
                           dtype=dtype, device=device),
        pos=0,
    )


def _decode_common(cfg, params, x, cache, donate):
    pos = int(cache.pos)
    q_nope, q_rope = _decode_q(cfg, params, x, pos)
    c_new, kr_new = _decode_latent(cfg, params, x, pos)
    c_kv = cache.c_kv if donate else cache.c_kv.clone()
    k_rope = cache.k_rope if donate else cache.k_rope.clone()
    c_kv[:, pos] = c_new.to(c_kv.dtype)
    k_rope[:, pos] = kr_new.to(k_rope.dtype)
    return q_nope, q_rope, MLACache(c_kv=c_kv, k_rope=k_rope, pos=pos + 1)


def _decode_q(cfg, params, x, pos: int):
    """The decode token's q_nope (B,H,nope), q_rope (B,H,rope)."""
    p_now = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _project_q(cfg, params, x, p_now)
    return q_nope[:, 0], q_rope[:, 0]


def _decode_latent(cfg, params, x, pos: int):
    """The decode token's latent (B,kv_lora) and rope key (B,rope)."""
    p_now = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    c_new, kr_new = _project_kv_latent(cfg, params, x, p_now)
    return c_new[:, 0], kr_new[:, 0]


def fwd_decode(cfg: ModelConfig, params: dict, x: torch.Tensor,
               cache: MLACache, *, donate: bool = False
               ) -> tuple[torch.Tensor, MLACache]:
    """Naive decode: expand K/V from latent for every cached position."""
    qn, qr, cache = _decode_common(cfg, params, x, cache, donate)
    return _attend(cfg, params, qn, qr, cache.c_kv, cache.k_rope,
                   cache.pos - 1, x.dtype, absorbed=False), cache


def fwd_decode_absorbed(cfg: ModelConfig, params: dict, x: torch.Tensor,
                        cache: MLACache, *, donate: bool = False
                        ) -> tuple[torch.Tensor, MLACache]:
    """Absorbed decode: attend in latent space; W_uk folds into q, W_uv into
    the output head, in float32. FLOPs per step drop from O(S*r*H*(nope+v))
    to O(S*H*(r+rope))."""
    qn, qr, cache = _decode_common(cfg, params, x, cache, donate)
    return _attend(cfg, params, qn, qr, cache.c_kv, cache.k_rope,
                   cache.pos - 1, x.dtype, absorbed=True), cache


def _attend(cfg: ModelConfig, params: dict, qn, qr, c_kv, k_rope,
            pos: int, dtype, *, absorbed: bool) -> torch.Tensor:
    """The decode token's heads (``cfg.num_heads``, the weights' columns)
    against the latent cache that holds positions 0..``pos``, through
    ``wo``: (B, 1, D)."""
    m = cfg.mla
    h = cfg.num_heads
    b = qn.shape[0]
    f32 = torch.float32
    s_mask = torch.arange(c_kv.shape[1], device=qn.device) <= pos
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    if absorbed:
        wkv_up = params["wkv_up"].to(f32).reshape(
            m.kv_lora_rank, h, m.qk_nope_head_dim + m.v_head_dim)
        w_uk = wkv_up[..., :m.qk_nope_head_dim]            # (r, H, nope)
        w_uv = wkv_up[..., m.qk_nope_head_dim:]            # (r, H, v)
        # fold: q_lat[b,h,r] = sum_e q_nope[b,h,e] * w_uk[r,h,e]
        q_lat = torch.einsum("bhe,rhe->bhr", qn.to(f32), w_uk)
        c = c_kv.to(f32)
        s = (torch.einsum("bhr,bsr->bhs", q_lat, c)
             + torch.einsum("bhr,bsr->bhs", qr.to(f32),
                            k_rope.to(f32))) * scale
        s = torch.where(s_mask[None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhs,bsr->bhr", p, c)         # latent output
        o = torch.einsum("bhr,rhv->bhv", o_lat, w_uv)      # absorbed W_uv
    else:
        k_nope, v = _expand_kv(cfg, params, c_kv.to(dtype))
        s = (torch.einsum("bhe,bshe->bhs", qn.to(f32), k_nope.to(f32))
             + torch.einsum("bhr,bsr->bhs", qr.to(f32),
                            k_rope.to(f32))) * scale
        s = torch.where(s_mask[None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhs,bshv->bhv", p, v.to(f32))
    out = o.reshape(b, 1, h * m.v_head_dim).to(dtype)
    return out @ params["wo"].to(dtype)


# ---------------------------------------------------------------------------
# On a mesh (`distributed.spmd`): whole query heads a model shard
# ---------------------------------------------------------------------------

_KEEP = {"wq_up": (1,), "wkv_up": (1,), "wo": (0,)}


def splits(lay, cfg: ModelConfig, params: dict) -> bool:
    """Whether the block runs head-split on ``lay``: one shard, or whole
    query heads a model shard (H divisible by M, ``wq_up``'s columns
    split over ``model``); else it runs whole on each batch group's
    owner."""
    from repro_torch.distributed import spmd
    return lay.n_model == 1 or (cfg.num_heads % lay.n_model == 0
                                and spmd.splits_model(params["wq_up"], 1))


def _shard(lay, cfg: ModelConfig, params: dict, dtype, *,
           absorbed: bool = False):
    """(the shard's config, each position's weights): ``wq_up`` /
    ``wkv_up``'s columns and ``wo``'s rows of the shard's heads, the
    down projections and norms gathered whole. The matrices are cast to
    ``dtype`` before the gather, as the layer casts them at use; the
    norms' scales stay float32, and ``wkv_up`` too for the absorbed
    decode, which reads it in float32."""
    import dataclasses

    from repro_torch.distributed import spmd
    lcfg = dataclasses.replace(cfg, num_heads=cfg.num_heads // lay.n_model)
    cast = ("wq_down", "wq_up", "wkv_down", "wo") \
        + (() if absorbed else ("wkv_up",))
    a = spmd.gather_tree(lay, {k: params[k] for k in cast}, dtype=dtype,
                         keep=_KEEP)
    b = spmd.gather_tree(lay, {k: v for k, v in params.items()
                               if k not in cast}, keep=_KEEP)
    return lcfg, [{**x, **y} for x, y in zip(a, b)]


def mesh_full(lay, cfg: ModelConfig, params: dict, xn: list, *,
              q_block: int = 512, kv_block: int = 1024,
              fill: tuple | None = None):
    """`fwd_full` of one (B_g, T, D) tensor a batch group on the mesh of
    ``lay`` (`splits`): each model shard computes its H / M heads (the
    shared latent on every shard) and the shards' ``wo`` partials are
    summed. Returns (one output a group, with ``fill`` = (max_len, cache
    dtype) the latent cache as blocks per `cache_shardings`: batch over
    the groups, the sequence over ``model`` where it divides; else
    None)."""
    from repro_torch.distributed import spmd
    lcfg, w = _shard(lay, cfg, params, xn[0].dtype)
    xs = spmd.replicate(lay, xn)
    outs = [fwd_full(lcfg, w[i], xs[i], q_block=q_block, kv_block=kv_block,
                     return_latent=fill is not None)
            for i in lay.positions()]
    if fill is None:
        return spmd.model_sum(lay, outs), None
    h = spmd.model_sum(lay, [o[0] for o in outs])
    caches = [fill_cache(cfg, *outs[i][1], fill[0], fill[1])
              for i in lay.owners()]
    return h, spmd.place_state(lay, caches)


def mesh_decode(lay, cfg: ModelConfig, params: dict, xn: list,
                cache: MLACache):
    """One decode step (`fwd_decode_absorbed` where ``cfg.mla_absorbed``,
    else `fwd_decode`) on the mesh of ``lay`` (`splits`): each group's
    owner writes the token's latent into the block that holds its
    position, each shard attends with its heads over its group's cache
    (gathered from the blocks) and the ``wo`` partials are summed.
    Returns (one output a group, the cache)."""
    from repro_torch.distributed import spmd
    dtype = xn[0].dtype
    pos = int(cache.pos)
    absorbed = cfg.mla_absorbed
    lcfg, w = _shard(lay, cfg, params, dtype, absorbed=absorbed)
    xs = spmd.replicate(lay, xn)
    q = [_decode_q(lcfg, w[i], xs[i], pos) for i in lay.positions()]
    for g, i in enumerate(lay.owners()):
        c_new, kr_new = _decode_latent(lcfg, w[i], xs[i], pos)
        spmd.write_rows(lay, cache.c_kv, g, c_new.to(cache.c_kv.dtype),
                        dim=1, index=pos)
        spmd.write_rows(lay, cache.k_rope, g,
                        kr_new.to(cache.k_rope.dtype), dim=1, index=pos)
    parts = []
    for i in lay.positions():
        g, dev = i // lay.n_model, lay.dev(i)
        parts.append(_attend(lcfg, w[i], *q[i],
                             spmd.group_rows(lay, cache.c_kv, g, dev),
                             spmd.group_rows(lay, cache.k_rope, g, dev),
                             pos, dtype, absorbed=absorbed))
    return spmd.model_sum(lay, parts), cache._replace(pos=pos + 1)
