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
             return_kv: bool = False):
    """Full-sequence attention (train / prefill). kv_src enables cross-attn.
    With return_kv, also returns the post-rope (k, v) for cache filling."""
    b, t, d = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // kv
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
    q = q.reshape(b, t, kv, g, hd)
    window = cfg.window if cfg.attn_kind in ("swa", "local") else 0
    out = blockwise_attention(q, k, v, causal=causal and kv_src is None,
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
    q = (x @ params["wq"].to(dtype)).reshape(b, 1, h, hd)

    if cross_kv is not None:
        k_all, v_all = cross_kv
        qg = q.reshape(b, kv, g, hd).to(torch.float32) * hd ** -0.5
        s = torch.einsum("bkgh,bskh->bkgs", qg, k_all.to(torch.float32))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgs,bskh->bkgh", p, v_all.to(torch.float32))
        out = o.reshape(b, 1, h * hd).to(dtype)
        return out @ params["wo"].to(dtype), cache

    pos = int(cache.pos)                                   # tokens so far
    k_new = (x @ params["wk"].to(dtype)).reshape(b, 1, kv, hd)
    v_new = (x @ params["wv"].to(dtype)).reshape(b, 1, kv, hd)
    if cfg.use_rope:
        p_now = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, p_now, theta=cfg.rope_theta)
        k_new = apply_rope(k_new, p_now, theta=cfg.rope_theta)

    buf = cache.k.shape[1]
    slot = pos % buf                                       # ring slot
    k_buf = cache.k if donate else cache.k.clone()
    v_buf = cache.v if donate else cache.v.clone()
    k_buf[:, slot] = k_new[:, 0].to(k_buf.dtype)
    v_buf[:, slot] = v_new[:, 0].to(v_buf.dtype)

    # absolute position held by each slot after this write
    s_idx = torch.arange(buf, device=x.device)
    abs_pos = pos - torch.remainder(pos - s_idx, buf)      # <= pos
    valid = abs_pos >= 0

    qg = q.reshape(b, kv, g, hd).to(torch.float32) * hd ** -0.5
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_buf.to(torch.float32))
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p, v_buf.to(torch.float32))
    out = o.reshape(b, 1, h * hd).to(dtype)
    out = out @ params["wo"].to(dtype)
    return out, KVCache(k=k_buf, v=v_buf, pos=pos + 1)
