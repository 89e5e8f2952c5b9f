"""Encoder-decoder assembly (whisper-small).

Port of `repro.models.encdec`. The conv/mel frontend is a STUB per the
assignment: the model consumes precomputed frame embeddings (B, frames,
d_model) through a linear adapter. Encoder: bidirectional self-attention
layers. Decoder: causal self-attention + cross-attention + MLP. The
layers' parameters are stacked on a leading layer axis (the reference's
scanned stacks, so weights convert 1:1); the port loops over that axis.
The decode cache holds the per-layer self-attention KV cache plus the
cross K/V, computed once at prefill as (L, B, frames, kv, hd) in the
cache dtype.

Two things are the reference's and kept: `prefill` encodes with
`encode`'s default blocks of 512, whatever the caller's ``q_block``; and
`decode_full` / `prefill` embed the decoder's tokens at `embedding.embed`'s
default dtype (bfloat16), while the model's decode step embeds at the
compute dtype.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import attention, embedding, mlp, norms
from repro_torch.models.layers._random import normal
from repro_torch.models.lm import _unbind_units, _unit, remat_call

Params = Any
Cache = Any


def _enc_layer_init(key, cfg, dtype, lead):
    dev = key.device
    return {
        "attn_norm": norms.init(cfg.norm_kind, cfg.d_model, dtype,
                                lead=lead, device=dev),
        "attn": attention.init(key, cfg, dtype, lead=lead),
        "mlp_norm": norms.init(cfg.norm_kind, cfg.d_model, dtype,
                               lead=lead, device=dev),
        "mlp": mlp.init(key, cfg.mlp_kind, cfg.d_model, cfg.d_ff, dtype,
                        lead=lead),
    }


def _dec_layer_init(key, cfg, dtype, lead):
    dev = key.device

    def norm():
        return norms.init(cfg.norm_kind, cfg.d_model, dtype, lead=lead,
                          device=dev)

    return {
        "self_norm": norm(),
        "self_attn": attention.init(key, cfg, dtype, lead=lead),
        "cross_norm": norm(),
        "cross_attn": attention.init(key, cfg, dtype, lead=lead),
        "mlp_norm": norm(),
        "mlp": mlp.init(key, cfg.mlp_kind, cfg.d_model, cfg.d_ff, dtype,
                        lead=lead),
    }


def init_params(key: torch.Generator, cfg: ModelConfig, *,
                max_positions: int, dtype=torch.float32) -> Params:
    """Random parameters on ``key``'s device, drawn tensor by tensor; the
    layer stacks straight into their (L, ...) tensors."""
    enc = cfg.encoder
    return {
        "embedding": embedding.init(key, cfg, max_positions=max_positions,
                                    dtype=dtype),
        "frame_adapter": normal(key, (cfg.d_model, cfg.d_model),
                                cfg.d_model ** -0.5, dtype),
        "enc_pos": normal(key, (enc.num_positions, cfg.d_model), 0.02,
                          dtype),
        "encoder": _enc_layer_init(key, cfg, dtype, (enc.num_layers,)),
        "enc_norm": norms.init(cfg.norm_kind, cfg.d_model, dtype,
                               device=key.device),
        "decoder": _dec_layer_init(key, cfg, dtype, (cfg.num_layers,)),
        "final_norm": norms.init(cfg.norm_kind, cfg.d_model, dtype,
                                 device=key.device),
    }


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor, *,
           q_block: int = 512, kv_block: int = 512,
           remat: bool = True) -> torch.Tensor:
    """frames (B, Tenc, D) stub embeddings -> encoder output (B, Tenc, D).
    ``remat``: each layer runs under `lm.remat_call` (recomputed in the
    backward pass when gradients are recorded, the reference's
    ``jax.checkpoint(layer)``)."""
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32
    x = frames.to(dtype) @ params["frame_adapter"].to(dtype)
    x = x + params["enc_pos"].to(dtype)

    def layer(x, p):
        xn = norms.apply(cfg.norm_kind, p["attn_norm"], x)
        x = x + attention.fwd_full(cfg, p["attn"], xn, causal=False,
                                   q_block=q_block, kv_block=kv_block)
        xn = norms.apply(cfg.norm_kind, p["mlp_norm"], x)
        return x + mlp.apply(cfg.mlp_kind, p["mlp"], xn)

    for p in _unbind_units(params["encoder"], cfg.encoder.num_layers):
        x = remat_call(remat, layer, x, p)
    return norms.apply(cfg.norm_kind, params["enc_norm"], x)


def decode_full(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                enc_out: torch.Tensor, *, q_block: int = 512,
                kv_block: int = 1024, remat: bool = True) -> torch.Tensor:
    """Teacher-forced decoder pass -> hidden states (B, T, D). ``remat``:
    each layer under `lm.remat_call`, as in `encode`."""
    x = embedding.embed(cfg, params["embedding"], tokens)

    def layer(x, p, enc_out):
        xn = norms.apply(cfg.norm_kind, p["self_norm"], x)
        x = x + attention.fwd_full(cfg, p["self_attn"], xn, causal=True,
                                   q_block=q_block, kv_block=kv_block)
        xn = norms.apply(cfg.norm_kind, p["cross_norm"], x)
        x = x + attention.fwd_full(cfg, p["cross_attn"], xn,
                                   kv_src=enc_out.to(x.dtype),
                                   q_block=q_block, kv_block=kv_block)
        xn = norms.apply(cfg.norm_kind, p["mlp_norm"], x)
        return x + mlp.apply(cfg.mlp_kind, p["mlp"], xn)

    for p in _unbind_units(params["decoder"], cfg.num_layers):
        x = remat_call(remat, layer, x, p, enc_out)
    return norms.apply(cfg.norm_kind, params["final_norm"], x)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device=None) -> Cache:
    enc = cfg.encoder
    l = cfg.num_layers
    kv, hd = cfg.num_kv_heads, cfg.head_dim

    def cross():
        return torch.zeros((l, batch, enc.num_positions, kv, hd),
                           dtype=dtype, device=device)

    return {
        "self": attention.init_cache(cfg, batch, max_len, dtype, lead=(l,),
                                     device=device),
        "cross_k": cross(),
        "cross_v": cross(),
        "pos": 0,
    }


def prefill(cfg: ModelConfig, params: Params, frames: torch.Tensor,
            tokens: torch.Tensor, *, max_len: int, q_block: int = 512,
            kv_block: int = 1024, cache_dtype=torch.bfloat16
            ) -> tuple[torch.Tensor, Cache]:
    """Encode + teacher-forced decoder prefill -> (hidden, cache)."""
    enc_out = encode(cfg, params, frames)
    x = embedding.embed(cfg, params["embedding"], tokens)
    b, t = tokens.shape
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    cache = init_cache(cfg, b, max_len, cache_dtype, device=x.device)
    for i in range(cfg.num_layers):
        p = _unit(params["decoder"], i)
        xn = norms.apply(cfg.norm_kind, p["self_norm"], x)
        h, (k_all, v_all) = attention.fwd_full(
            cfg, p["self_attn"], xn, causal=True, q_block=q_block,
            kv_block=kv_block, return_kv=True)
        x = x + h
        self_c = attention.fill_cache(cfg, k_all, v_all, max_len,
                                      cache_dtype)
        cache["self"].k[i].copy_(self_c.k)
        cache["self"].v[i].copy_(self_c.v)
        xn = norms.apply(cfg.norm_kind, p["cross_norm"], x)
        dtype = x.dtype
        src = enc_out.to(dtype)
        cache["cross_k"][i] = (src @ p["cross_attn"]["wk"].to(dtype)) \
            .reshape(b, -1, kv, hd).to(cache_dtype)
        cache["cross_v"][i] = (src @ p["cross_attn"]["wv"].to(dtype)) \
            .reshape(b, -1, kv, hd).to(cache_dtype)
        x = x + attention.fwd_full(cfg, p["cross_attn"], xn, kv_src=src,
                                   q_block=q_block, kv_block=kv_block)
        xn = norms.apply(cfg.norm_kind, p["mlp_norm"], x)
        x = x + mlp.apply(cfg.mlp_kind, p["mlp"], xn)
    x = norms.apply(cfg.norm_kind, params["final_norm"], x)
    cache = dict(cache, self=cache["self"]._replace(pos=t), pos=t)
    return x, cache


def decode_step(cfg: ModelConfig, params: Params, cache: Cache,
                x: torch.Tensor, *, donate: bool = False
                ) -> tuple[torch.Tensor, Cache]:
    """One decoder token step on embedded x (B, 1, D).

    ``donate``: write the new token into ``cache``'s self-attention
    buffers in place (they become the returned cache's); otherwise
    ``cache`` is left as it was. The cross K/V are only read, and shared
    by both caches."""
    self_c = cache["self"] if donate else attention.KVCache(
        k=cache["self"].k.clone(), v=cache["self"].v.clone(),
        pos=cache["self"].pos)
    for i in range(cfg.num_layers):
        p = _unit(params["decoder"], i)
        layer_c = _unit(self_c, i)          # views into the stacked buffers
        xn = norms.apply(cfg.norm_kind, p["self_norm"], x)
        h, _ = attention.fwd_decode(cfg, p["self_attn"], xn, layer_c,
                                    donate=True)
        x = x + h
        xn = norms.apply(cfg.norm_kind, p["cross_norm"], x)
        h, _ = attention.fwd_decode(
            cfg, p["cross_attn"], xn, layer_c,
            cross_kv=(cache["cross_k"][i], cache["cross_v"][i]))
        x = x + h
        xn = norms.apply(cfg.norm_kind, p["mlp_norm"], x)
        x = x + mlp.apply(cfg.mlp_kind, p["mlp"], xn)
    x = norms.apply(cfg.norm_kind, params["final_norm"], x)
    new_cache = dict(cache, self=self_c._replace(pos=self_c.pos + 1),
                     pos=cache["pos"] + 1)
    return x, new_cache
