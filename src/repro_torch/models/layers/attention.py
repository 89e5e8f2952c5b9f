"""Attention: GQA/MQA, sliding-window / local, prefix-LM, cross-attention.

Port of `repro.models.layers.attention`, with its two execution paths:

* ``fwd_full`` (train / prefill): **blockwise online-softmax attention**
  (flash-style, plain PyTorch). Scores never materialize beyond one
  (q_block x kv_block) tile a query block. The inner loop is the
  reference's *banded* visit: for query block i, only kv blocks in the
  causal band [i - band + 1, i] are visited. The reference scans the query
  blocks one after another; their visits are independent, so the port
  runs all query blocks of a band offset in one batched step, with each
  block's online max / sum / rescale in the reference's order.

* ``fwd_decode`` (serving): one query token against a KV cache.
  Windowed layers use a **ring-buffer cache** of exactly ``window`` slots.
  RoPE is applied at absolute positions before caching, so the ring
  wraparound is transparent.

GQA folds the group axis into queries: q (B,T,KV,G,hd) against k (B,S,KV,hd).
Softmax is computed in f32. No library attention kernel is used: a fused
kernel is later speed work, measured against this one.

A `KVCache`'s ``pos`` is a Python int (the tokens already written): the
host picks the ring slot without reading the device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers._random import normal
from repro_torch.models.layers.rope import apply_rope
from repro_torch.models.sharding_hints import fsdp_use

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, buf_len, KV, hd) -- buf_len = window (ring) or max
    v: torch.Tensor
    pos: int         # number of tokens already written


def init(key: torch.Generator, cfg: ModelConfig, dtype=torch.float32, *,
         lead: tuple = ()) -> dict:
    d = cfg.d_model
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = d ** -0.5
    return {
        "wq": normal(key, (*lead, d, h * hd), s, dtype),
        "wk": normal(key, (*lead, d, kv * hd), s, dtype),
        "wv": normal(key, (*lead, d, kv * hd), s, dtype),
        "wo": normal(key, (*lead, h * hd, d), (h * hd) ** -0.5, dtype),
    }


# ---------------------------------------------------------------------------
# Blockwise (flash-style) attention for train / prefill
# ---------------------------------------------------------------------------

def _fit_block(t: int, want: int) -> int:
    """Largest divisor of t that is <= want (handles e.g. whisper's 1500
    encoder frames against the default 512 block)."""
    b = min(want, t)
    while t % b:
        b -= 1
    return b


def _block_mask(q_idx: torch.Tensor, k_idx: torch.Tensor, *, causal: bool,
                window: int, prefix_len: int) -> torch.Tensor:
    """Elementwise visibility for absolute indices q_idx (..., Tq, 1) and
    k_idx (..., 1, Tk)."""
    if not causal:
        return torch.ones(torch.broadcast_shapes(q_idx.shape, k_idx.shape),
                          dtype=torch.bool, device=q_idx.device)
    m = k_idx <= q_idx
    if window > 0:
        m &= k_idx > (q_idx - window)
    if prefix_len > 0:
        # prefix-LM: inside the prefix everything sees everything
        m |= (k_idx < prefix_len) & (q_idx < prefix_len)
    return m


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, window: int = 0,
                        prefix_len: int = 0, q_block: int = 512,
                        kv_block: int = 1024,
                        q_offset: int = 0) -> torch.Tensor:
    """q (B,Tq,KV,G,hd), k/v (B,Tk,KV,hd) -> (B,Tq,KV,G,hd). f32 softmax.

    ``q_offset``: absolute position of q[,0] (prefill continuation support).
    """
    b, tq, kvh, g, hd = q.shape
    tk = k.shape[1]
    dev = q.device
    q_block = _fit_block(tq, q_block)
    kv_block = _fit_block(tk, kv_block)
    if prefix_len > kv_block:
        raise ValueError("prefix_len must fit within one kv block")
    n_q, n_k = tq // q_block, tk // kv_block
    scale = hd ** -0.5

    if causal:
        # banded kv visit: blocks [i_k - band + 1, i_k] in kv-block units,
        # where i_k is the kv block containing this q block's diagonal.
        if window > 0:
            # worst-case kv-block span of [q_lo - window + 1, q_hi]: the key
            # span has length q_block + window - 1 and may straddle an extra
            # block boundary on each side
            band = (window + q_block) // kv_block + 2
        else:
            band = n_k
        band = min(band, n_k)
    else:
        band = n_k

    # (B, n_q, qb, KV, G, hd); k / v as (B, n_k, kvb, KV, hd)
    qf = (q.to(torch.float32) * scale).reshape(b, n_q, q_block, kvh, g, hd)
    kf = k.to(torch.float32).reshape(b, n_k, kv_block, kvh, hd)
    vf = v.to(torch.float32).reshape(b, n_k, kv_block, kvh, hd)

    qi = torch.arange(n_q, device=dev)
    q_abs = q_offset + qi[:, None] * q_block \
        + torch.arange(q_block, device=dev)                 # (n_q, qb)
    diag_k = (q_offset + (qi + 1) * q_block - 1) // kv_block  # (n_q,)

    m_run = torch.full((b, n_q, kvh, g, q_block), NEG_INF,
                       dtype=torch.float32, device=dev)
    l_run = torch.zeros((b, n_q, kvh, g, q_block), dtype=torch.float32,
                        device=dev)
    acc = torch.zeros((b, n_q, kvh, g, q_block, hd), dtype=torch.float32,
                      device=dev)
    for o in range(band):
        if causal:
            kj = torch.clamp_min(diag_k - band + 1 + o, 0)  # clamped band
            in_band = (diag_k - band + 1 + o) >= 0
        else:
            kj = torch.full((n_q,), o, device=dev)          # every block
            in_band = torch.ones((n_q,), dtype=torch.bool, device=dev)
        k_blk = kf[:, kj]                                   # (B,n_q,kvb,KV,hd)
        v_blk = vf[:, kj]
        k_abs = kj[:, None] * kv_block \
            + torch.arange(kv_block, device=dev)            # (n_q, kvb)
        mask = _block_mask(q_abs[:, :, None], k_abs[:, None, :],
                           causal=causal, window=window,
                           prefix_len=prefix_len)
        mask &= in_band[:, None, None]                      # (n_q, qb, kvb)
        s = torch.einsum("bnqkgh,bnskh->bnkgqs", qf, k_blk)
        s = torch.where(mask[None, :, None, None], s, NEG_INF)
        m_new = torch.maximum(m_run, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] \
            + torch.einsum("bnkgqs,bnskh->bnkgqh", p, v_blk)
        m_run = m_new

    out = acc / torch.clamp_min(l_run, 1e-30)[..., None]    # (B,n_q,KV,G,qb,hd)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(b, tq, kvh, g, hd)
    return out.to(q.dtype)


def fwd_full(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
             causal: bool = True, prefix_len: int = 0,
             kv_src: Optional[torch.Tensor] = None,
             positions: Optional[torch.Tensor] = None,
             q_block: int = 512, kv_block: int = 1024,
             return_kv: bool = False, kv_range: Optional[tuple] = None):
    """Full-sequence attention (train / prefill). kv_src enables cross-attn.
    With return_kv, also returns the post-rope (k, v) for cache filling.

    ``kv_range`` (lo, hi): the queries (a model shard's heads) attend to
    kv heads [lo, hi) of the ``cfg.num_kv_heads`` that the weights make
    (a mesh shard whose heads share gathered kv heads); (k, v) returned
    are all of them."""
    b, t, d = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lo, hi = kv_range if kv_range is not None else (0, kv)
    g = h // (hi - lo)
    dtype = x.dtype
    src = x if kv_src is None else kv_src
    tk = src.shape[1]
    q = (x @ fsdp_use(params["wq"], "wq", dtype)).reshape(b, t, h, hd)
    k = (src @ fsdp_use(params["wk"], "wk", dtype)).reshape(b, tk, kv, hd)
    v = (src @ fsdp_use(params["wv"], "wv", dtype)).reshape(b, tk, kv, hd)
    if cfg.use_rope and kv_src is None:
        pos = positions if positions is not None \
            else torch.arange(t, device=x.device)
        q = apply_rope(q, pos, theta=cfg.rope_theta)
        k = apply_rope(k, pos, theta=cfg.rope_theta)
    q = q.reshape(b, t, hi - lo, g, hd)
    window = cfg.window if cfg.attn_kind in ("swa", "local") else 0
    ku, vu = (k, v) if kv_range is None else (k[:, :, lo:hi], v[:, :, lo:hi])
    out = blockwise_attention(q, ku, vu, causal=causal and kv_src is None,
                              window=window, prefix_len=prefix_len,
                              q_block=q_block, kv_block=kv_block)
    out = out.reshape(b, t, h * hd)
    out = out @ fsdp_use(params["wo"], "wo", dtype)
    if return_kv:
        return out, (k, v)
    return out


def fill_cache(cfg: ModelConfig, k_all: torch.Tensor, v_all: torch.Tensor,
               max_len: int, dtype=torch.bfloat16) -> KVCache:
    """Build a decode cache from prefill K/V (ring layout for windowed)."""
    b, t, kv, hd = k_all.shape
    buf = cache_len(cfg, max_len)
    lastn = min(buf, t)
    slots = torch.arange(t - lastn, t, device=k_all.device) % buf
    k_buf = torch.zeros((b, buf, kv, hd), dtype=dtype, device=k_all.device)
    v_buf = torch.zeros((b, buf, kv, hd), dtype=dtype, device=k_all.device)
    k_buf[:, slots] = k_all[:, t - lastn:].to(dtype)
    v_buf[:, slots] = v_all[:, t - lastn:].to(dtype)
    return KVCache(k=k_buf, v=v_buf, pos=t)


# ---------------------------------------------------------------------------
# Decode path (single token, KV cache; ring buffer for windowed layers)
# ---------------------------------------------------------------------------

def cache_len(cfg: ModelConfig, max_len: int) -> int:
    if cfg.attn_kind in ("swa", "local") and cfg.window > 0:
        return min(cfg.window, max_len)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, lead: tuple = (),
               device=None) -> KVCache:
    buf = cache_len(cfg, max_len)
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return KVCache(
        k=torch.zeros((*lead, batch, buf, kv, hd), dtype=dtype,
                      device=device),
        v=torch.zeros((*lead, batch, buf, kv, hd), dtype=dtype,
                      device=device),
        pos=0,
    )


def fwd_decode(cfg: ModelConfig, params: dict, x: torch.Tensor,
               cache: KVCache, *,
               cross_kv: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
               donate: bool = False) -> tuple[torch.Tensor, KVCache]:
    """One decode step. x: (B, 1, D). Returns (out (B,1,D), new cache).

    cross_kv: precomputed (k, v) from the encoder (whisper decode) -- no
    cache update, bidirectional over the encoder length.
    donate: write the new token into ``cache``'s buffers in place (they
    are the returned cache's); otherwise ``cache`` is left as it was.
    """
    b, _, d = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // kv
    dtype = x.dtype

    if cross_kv is not None:
        q = (x @ params["wq"].to(dtype)).reshape(b, 1, h, hd)
        k_all, v_all = cross_kv
        qg = q.reshape(b, kv, g, hd).to(torch.float32) * hd ** -0.5
        s = torch.einsum("bkgh,bskh->bkgs", qg, k_all.to(torch.float32))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgs,bskh->bkgh", p, v_all.to(torch.float32))
        out = o.reshape(b, 1, h * hd).to(dtype)
        return out @ params["wo"].to(dtype), cache

    pos = int(cache.pos)                                   # tokens so far
    q, k_new, v_new = decode_qkv(cfg, params, x, pos)
    buf = cache.k.shape[1]
    slot = pos % buf                                       # ring slot
    k_buf = cache.k if donate else cache.k.clone()
    v_buf = cache.v if donate else cache.v.clone()
    k_buf[:, slot] = k_new[:, 0].to(k_buf.dtype)
    v_buf[:, slot] = v_new[:, 0].to(v_buf.dtype)
    out = decode_attend(cfg, params, q, k_buf, v_buf, pos)
    return out, KVCache(k=k_buf, v=v_buf, pos=pos + 1)


def decode_qkv(cfg: ModelConfig, params: dict, x: torch.Tensor, pos: int):
    """The decode step's rotated q (B,1,H,hd) and new k / v (B,1,KV,hd)
    at position ``pos``."""
    b = x.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dtype = x.dtype
    q = (x @ params["wq"].to(dtype)).reshape(b, 1, h, hd)
    k_new = (x @ params["wk"].to(dtype)).reshape(b, 1, kv, hd)
    v_new = (x @ params["wv"].to(dtype)).reshape(b, 1, kv, hd)
    if cfg.use_rope:
        p_now = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, p_now, theta=cfg.rope_theta)
        k_new = apply_rope(k_new, p_now, theta=cfg.rope_theta)
    return q, k_new, v_new


def decode_attend(cfg: ModelConfig, params: dict, q: torch.Tensor,
                  k_buf: torch.Tensor, v_buf: torch.Tensor, pos: int
                  ) -> torch.Tensor:
    """q (B,1,H,hd) against the cache buffers (B,buf,KVu,hd) that hold
    the token at ``pos`` (the ring's absolute positions), through ``wo``:
    (B,1,D). ``KVu`` may be a shard's share of the kv heads."""
    b, _, h, hd = q.shape
    kvu = k_buf.shape[2]
    dtype = q.dtype
    buf = k_buf.shape[1]
    # absolute position held by each slot after this write
    s_idx = torch.arange(buf, device=q.device)
    abs_pos = pos - torch.remainder(pos - s_idx, buf)      # <= pos
    valid = abs_pos >= 0

    qg = q.reshape(b, kvu, h // kvu, hd).to(torch.float32) * hd ** -0.5
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_buf.to(torch.float32))
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v_buf.to(torch.float32))
    out = o.reshape(b, 1, h * hd).to(dtype)
    return out @ params["wo"].to(dtype)


# ---------------------------------------------------------------------------
# On a mesh (`distributed.spmd`): whole heads a model shard, cache blocks
# ---------------------------------------------------------------------------

def mesh_plan(cfg: ModelConfig, n_model: int):
    """How the heads split over ``n_model`` shards: (the shard's config,
    leaf name -> dims whose model split stays, each shard's kv-head range
    or None where its kv heads are its own split), or None where the heads
    do not split into whole units (the attention then runs whole on each
    batch group's owner). A shard takes H / M whole query heads; the kv
    heads split with them when M divides them, else a shard whose heads
    all read one kv head takes that head of the gathered wk / wv (MQA)."""
    h, kv = cfg.num_heads, cfg.num_kv_heads
    if n_model == 1:
        return cfg, {}, [None]
    if h % n_model:
        return None
    hl = h // n_model
    if kv % n_model == 0:
        return (dataclasses.replace(cfg, num_heads=hl,
                                    num_kv_heads=kv // n_model),
                {"wq": (1,), "wk": (1,), "wv": (1,), "wo": (0,)},
                [None] * n_model)
    grp = h // kv
    if grp % hl == 0:
        return (dataclasses.replace(cfg, num_heads=hl),
                {"wq": (1,), "wo": (0,)},
                [((m * hl) // grp, (m * hl) // grp + 1)
                 for m in range(n_model)])
    return None


def _cache_spec(lay, cfg: ModelConfig, shape):
    from repro_torch.distributed.partitioning import cache_shardings
    meta = torch.empty(shape, device="meta")
    return cache_shardings(lay.mesh, KVCache(k=meta, v=meta, pos=0)).k.spec


def _cache_blocks(lay, cfg: ModelConfig, local: list, t: int, max_len: int,
                  dtype) -> KVCache:
    """The prefill's decode cache as blocks per `cache_shardings`:
    ``local[i]`` = (k, v, first kv head) that position i computed for its
    batch group (B_g, T, KVi, hd), or None where its group's owner's
    holds the heads."""
    import numpy as np

    from repro_torch.distributed.partitioning import Placed, block_slices
    m = lay.n_model
    k0 = next(x for x in local if x is not None)[0]
    b_g, hd = k0.shape[0], k0.shape[3]
    shape = (b_g * lay.n_groups, cache_len(cfg, max_len), cfg.num_kv_heads,
             hd)
    spec = _cache_spec(lay, cfg, shape)
    filled = {}
    kb = np.empty(lay.mesh.devices.shape, dtype=object)
    vb = np.empty(lay.mesh.devices.shape, dtype=object)
    for i, c in enumerate(lay.coords):
        g = i // m
        src = i if local[i] is not None else g * m
        k, v, off = local[src]
        if src not in filled:
            filled[src] = fill_cache(cfg, k, v, max_len, dtype)
        f = filled[src]
        r = block_slices(lay.mesh, spec, shape, c)
        rel = (slice(r[0].start - g * b_g, r[0].stop - g * b_g), r[1],
               slice(r[2].start - off, r[2].stop - off), r[3])
        dev = lay.dev(i)
        whole = src == i and tuple(f.k[rel].shape) == tuple(f.k.shape)
        kb[c] = f.k if whole else f.k[rel].to(
            dev, copy=True, memory_format=torch.contiguous_format)
        vb[c] = f.v if whole else f.v[rel].to(
            dev, copy=True, memory_format=torch.contiguous_format)
    return KVCache(k=Placed(lay.mesh, spec, shape, kb),
                   v=Placed(lay.mesh, spec, shape, vb), pos=t)


def mesh_full(lay, cfg: ModelConfig, params: dict, xn: list, *,
              causal: bool = True, prefix_len: int = 0,
              kv_src: Optional[list] = None, q_block: int = 512,
              kv_block: int = 1024, fill: Optional[tuple] = None):
    """`fwd_full` of one (B_g, T, D) tensor a batch group on the mesh of
    ``lay``: each model shard computes its whole heads (`mesh_plan`) from
    its gathered weights and the shards' ``wo`` partials are summed;
    ``kv_src`` (cross-attention): one (B_g, Tk, D) source a group.
    Returns (one output a group, the decode cache or None); ``fill`` =
    (max_len, cache dtype) asks for the cache, as blocks per
    `cache_shardings` on a mesh (`fill_cache`'s on one position)."""
    h, local = _mesh_full(lay, cfg, params, xn, causal=causal,
                          prefix_len=prefix_len, kv_src=kv_src,
                          q_block=q_block, kv_block=kv_block,
                          want_kv=fill is not None)
    if fill is None:
        return h, None
    max_len, cache_dtype = fill
    if lay.single:
        return h, fill_cache(cfg, local[0][0], local[0][1], max_len,
                             cache_dtype)
    return h, _cache_blocks(lay, cfg, local, xn[0].shape[1], max_len,
                            cache_dtype)


def _mesh_full(lay, cfg: ModelConfig, params: dict, xn: list, *,
               causal: bool, prefix_len: int, kv_src: Optional[list],
               q_block: int, kv_block: int, want_kv: bool):
    """`mesh_full`'s outputs and, with ``want_kv``, each position's
    (k, v, first kv head) of its group (None where its group's owner's
    hold the heads)."""
    from repro_torch.distributed import spmd
    dtype = xn[0].dtype
    kw = dict(causal=causal, prefix_len=prefix_len, q_block=q_block,
              kv_block=kv_block, return_kv=want_kv)
    plan = mesh_plan(cfg, lay.n_model)
    if plan is None:
        w = spmd.gather_tree(lay, params, dtype=dtype, users=lay.owners())
        outs = [fwd_full(cfg, w[g], xn[g], kv_src=None if kv_src is None
                         else kv_src[g], **kw)
                for g in range(lay.n_groups)]
        h = [o[0] if want_kv else o for o in outs]
        local = [(outs[i // lay.n_model][1] + (0,))
                 if i % lay.n_model == 0 else None
                 for i in lay.positions()] if want_kv else None
    else:
        lcfg, keep, ranges = plan
        w = spmd.gather_tree(lay, params, dtype=dtype, keep=keep)
        xs = spmd.replicate(lay, xn)
        srcs = None if kv_src is None else spmd.replicate(lay, kv_src)
        outs = [fwd_full(lcfg, w[i], xs[i], kv_range=ranges[i % lay.n_model],
                         kv_src=None if srcs is None else srcs[i], **kw)
                for i in lay.positions()]
        h = spmd.model_sum(lay, [o[0] if want_kv else o for o in outs])
        split = ranges[0] is None
        local = [o[1] + ((i % lay.n_model) * lcfg.num_kv_heads
                         if split else 0,)
                 for i, o in enumerate(outs)] if want_kv else None
    return h, local


def mesh_cross_kv(lay, cfg: ModelConfig, params: dict, xn: list,
                  src: list, *, q_block: int = 512, kv_block: int = 1024,
                  dtype=torch.bfloat16):
    """Cross-attention of one (B_g, T, D) tensor a batch group against
    its (B_g, Tk, D) ``src`` on the mesh of ``lay`` (`mesh_full`), and
    the source's K / V in ``dtype``: on one position (B, Tk, KV, hd)
    tensors, on a mesh blocks per `cache_shardings`' cross K / V rule
    (batch over the groups, the kv heads over ``model`` where they
    divide it). Returns (one output a group, (k, v))."""
    from repro_torch.distributed import spmd
    from repro_torch.distributed.partitioning import (block_slices,
                                                      cache_shardings)
    h, local = _mesh_full(lay, cfg, params, xn, causal=False, prefix_len=0,
                          kv_src=src, q_block=q_block, kv_block=kv_block,
                          want_kv=True)
    if lay.single:
        k, v, _ = local[0]
        return h, (k.to(dtype), v.to(dtype))
    k0 = next(x for x in local if x is not None)[0]
    shape = (k0.shape[0] * lay.n_groups, k0.shape[1], cfg.num_kv_heads,
             k0.shape[3])
    spec = cache_shardings(lay.mesh, {"cross_k": torch.empty(
        shape, device="meta")})["cross_k"].spec
    kv = []
    for which in (0, 1):
        blocks = []
        for i, c in enumerate(lay.coords):
            g = i // lay.n_model
            src_i = i if local[i] is not None else g * lay.n_model
            x, off = local[src_i][which], local[src_i][2]
            r = block_slices(lay.mesh, spec, shape, c)
            rel = (slice(None), slice(None),
                   slice(r[2].start - off, r[2].stop - off), slice(None))
            blocks.append(x[rel].to(lay.dev(i), dtype, copy=True,
                                    memory_format=torch.contiguous_format))
        kv.append(spmd.place_blocks(lay, spec, shape, blocks))
    return h, tuple(kv)


def mesh_decode(lay, cfg: ModelConfig, params: dict, xn: list,
                cache: KVCache):
    """`fwd_decode` of one (B_g, 1, D) tensor a batch group on the mesh of
    ``lay``, writing the new token into ``cache`` (blocks per
    `cache_shardings`, or one position's tensors) in place. Where a
    shard's kv heads are its block's, the shard runs `fwd_decode` on its
    block; otherwise the token is written into the block that holds its
    slot and each shard reads its group's cache gathered from the blocks.
    Returns (one output a group, the cache)."""
    from repro_torch.distributed import spmd
    dtype = xn[0].dtype
    pos = int(cache.pos)
    m = lay.n_model
    plan = mesh_plan(cfg, m)
    if plan is not None and plan[2][0] is None:
        lcfg, keep, _ = plan
        w = spmd.gather_tree(lay, params, dtype=dtype, keep=keep)
        xs = spmd.replicate(lay, xn)
        parts = []
        for i, c in enumerate(lay.coords):
            blk = cache if lay.single else KVCache(
                k=cache.k.blocks[c], v=cache.v.blocks[c], pos=pos)
            parts.append(fwd_decode(lcfg, w[i], xs[i], blk, donate=True)[0])
        return spmd.model_sum(lay, parts), cache._replace(pos=pos + 1)

    if plan is None:
        users = lay.owners()
        w = spmd.gather_tree(lay, params, dtype=dtype, users=users)
        qkv = [decode_qkv(cfg, w[g], xn[g], pos)
               for g in range(lay.n_groups)]
        src = [g for g in range(lay.n_groups) for _ in range(m)]
    else:
        lcfg, keep, ranges = plan
        w = spmd.gather_tree(lay, params, dtype=dtype, keep=keep)
        xs = spmd.replicate(lay, xn)
        qkv = [decode_qkv(lcfg, w[i], xs[i], pos) for i in lay.positions()]
        src = lay.positions()
    slot = pos % cache.k.shape[1]
    for g in range(lay.n_groups):
        _, k_new, v_new = qkv[src[g * m]]
        spmd.write_rows(lay, cache.k, g, k_new[:, 0], dim=1, index=slot)
        spmd.write_rows(lay, cache.v, g, v_new[:, 0], dim=1, index=slot)
    if plan is None:
        h = []
        for g in range(lay.n_groups):
            dev = lay.group_dev(g)
            h.append(decode_attend(cfg, w[g], qkv[g][0],
                                   spmd.group_rows(lay, cache.k, g, dev),
                                   spmd.group_rows(lay, cache.v, g, dev),
                                   pos))
    else:
        parts = []
        for i in lay.positions():
            lo, hi = ranges[i % m]
            dev = lay.dev(i)
            k_all = spmd.group_rows(lay, cache.k, i // m, dev)
            v_all = spmd.group_rows(lay, cache.v, i // m, dev)
            parts.append(decode_attend(lcfg, w[i], qkv[i][0],
                                       k_all[:, :, lo:hi],
                                       v_all[:, :, lo:hi], pos))
        h = spmd.model_sum(lay, parts)
    return h, cache._replace(pos=pos + 1)


def mesh_cross_decode(lay, cfg: ModelConfig, params: dict, xn: list,
                      k, v) -> list:
    """`fwd_decode`'s cross-attention step of one (B_g, 1, D) tensor a
    batch group on the mesh of ``lay``, against the cross K / V (blocks
    per `mesh_cross_kv`, or one position's tensors): each model shard
    attends with its heads over its kv heads' block (or its kv head of
    the group's K / V gathered from the blocks) and the ``wo`` partials
    are summed. One output a group."""
    from repro_torch.distributed import spmd
    dtype = xn[0].dtype
    plan = mesh_plan(cfg, lay.n_model)
    if plan is None:
        w = spmd.gather_tree(lay, params, dtype=dtype, users=lay.owners())
        return [fwd_decode(cfg, w[g], xn[g], None, cross_kv=(
            spmd.group_rows(lay, k, g), spmd.group_rows(lay, v, g)))[0]
            for g in range(lay.n_groups)]
    lcfg, keep, ranges = plan
    w = spmd.gather_tree(lay, params, dtype=dtype, keep=keep)
    xs = spmd.replicate(lay, xn)
    parts = []
    for i, c in enumerate(lay.coords):
        rng = ranges[i % lay.n_model]
        if rng is None:
            kv = (k, v) if lay.single else (k.blocks[c], v.blocks[c])
            cfg_i = lcfg
        else:
            g, dev = i // lay.n_model, lay.dev(i)
            kv = tuple(spmd.group_rows(lay, x, g, dev)[:, :, rng[0]:rng[1]]
                       for x in (k, v))
            cfg_i = dataclasses.replace(lcfg, num_kv_heads=rng[1] - rng[0])
        parts.append(fwd_decode(cfg_i, w[i], xs[i], None, cross_kv=kv)[0])
    return spmd.model_sum(lay, parts)
