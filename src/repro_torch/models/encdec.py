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

One program body runs every layout, as `models.lm`'s: the functions take
and return one tensor a batch group on a mesh (a tensor on one device);
the frame adapter and the encoder's positions are gathered whole on each
group's owner, the norms run there, the self-, cross-attention and MLP
over the model shards (`attention.mesh_full`, `mesh_cross_kv`,
`mesh_decode`, `mesh_cross_decode`, `mlp.mesh_apply`). On a mesh the
cache's tensors are blocks per `partitioning.cache_shardings`: the
self-attention KV cache as `lm`'s, the cross K / V by batch group and kv
heads.

Two things are the reference's and kept: `prefill` encodes with
`encode`'s default blocks of 512, whatever the caller's ``q_block``; and
`decode_full` / `prefill` embed the decoder's tokens at
`embedding.mesh_embed`'s default dtype (bfloat16, the reference's
`embedding.embed` default), while the model's decode step embeds at the
compute dtype.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import attention, embedding, mlp, norms
from repro_torch.models.layers._random import normal
from repro_torch.distributed import spmd
from repro_torch.models import lm
from repro_torch.models.lm import (_groups, _unbind_units, _unit,
                                   remat_call)

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


def encode(cfg: ModelConfig, params: Params, frames, *,
           q_block: int = 512, kv_block: int = 512,
           remat: bool = True):
    """frames (B, Tenc, D) stub embeddings -> encoder output (B, Tenc, D);
    on a mesh one (B_g, Tenc, D) tensor a batch group in and out. The
    adapter and positions on each group's owner (gathered whole), the
    layers as `lm`'s blocks (norms on the owners, attention and MLP over
    the model shards). ``remat``: each layer runs under `lm.remat_call`
    (recomputed in the backward pass when gradients are recorded, the
    reference's ``jax.checkpoint(layer)``)."""
    lay = lm.program_layout(cfg, params)
    fg, one = _groups(frames)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32
    w = spmd.gather_tree(lay, {k: params[k] for k in ("frame_adapter",
                                                      "enc_pos")},
                         dtype=dtype, users=lay.owners())
    xg = [(f.to(dtype) @ w[g]["frame_adapter"].to(dtype))
          + w[g]["enc_pos"].to(dtype) for g, f in enumerate(fg)]

    def layer(xg, p):
        xn = lm._norm(lay, cfg, p["attn_norm"], xg)
        h, _ = attention.mesh_full(lay, cfg, p["attn"], xn, causal=False,
                                   q_block=q_block, kv_block=kv_block)
        xg = [x + hh for x, hh in zip(xg, h)]
        xn = lm._norm(lay, cfg, p["mlp_norm"], xg)
        return [x + hh for x, hh in zip(xg, mlp.mesh_apply(
            lay, cfg.mlp_kind, p["mlp"], xn))]

    for p in _unbind_units(params["encoder"], cfg.encoder.num_layers):
        xg = remat_call(remat, layer, xg, p)
    xg = lm._norm(lay, cfg, params["enc_norm"], xg)
    return xg[0] if one else xg


def _embed(cfg, params, lay, tokens: list, **kw) -> list:
    return embedding.mesh_embed(lay, cfg, params["embedding"],
                                [t.to(lay.group_dev(g))
                                 for g, t in enumerate(tokens)], **kw)


def decode_full(cfg: ModelConfig, params: Params, tokens, enc_out, *,
                q_block: int = 512, kv_block: int = 1024,
                remat: bool = True):
    """Teacher-forced decoder pass -> hidden states (B, T, D) (on a mesh
    one tensor a batch group of tokens, encoder outputs and hidden
    states). ``remat``: each layer under `lm.remat_call`, as in
    `encode`."""
    lay = lm.program_layout(cfg, params)
    tg, one = _groups(tokens)
    eg, _ = _groups(enc_out)
    xg = _embed(cfg, params, lay, tg)

    def layer(xg, p, eg):
        xn = lm._norm(lay, cfg, p["self_norm"], xg)
        h, _ = attention.mesh_full(lay, cfg, p["self_attn"], xn,
                                   causal=True, q_block=q_block,
                                   kv_block=kv_block)
        xg = [x + hh for x, hh in zip(xg, h)]
        xn = lm._norm(lay, cfg, p["cross_norm"], xg)
        h, _ = attention.mesh_full(lay, cfg, p["cross_attn"], xn,
                                   kv_src=[e.to(x.dtype) for e, x
                                           in zip(eg, xg)],
                                   q_block=q_block, kv_block=kv_block)
        xg = [x + hh for x, hh in zip(xg, h)]
        xn = lm._norm(lay, cfg, p["mlp_norm"], xg)
        return [x + hh for x, hh in zip(xg, mlp.mesh_apply(
            lay, cfg.mlp_kind, p["mlp"], xn))]

    for p in _unbind_units(params["decoder"], cfg.num_layers):
        xg = remat_call(remat, layer, xg, p, eg)
    xg = lm._norm(lay, cfg, params["final_norm"], xg)
    return xg[0] if one else xg


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


def prefill(cfg: ModelConfig, params: Params, frames, tokens, *,
            max_len: int, q_block: int = 512, kv_block: int = 1024,
            cache_dtype=torch.bfloat16) -> tuple[torch.Tensor, Cache]:
    """Encode + teacher-forced decoder prefill -> (hidden, cache); on a
    mesh one tensor a batch group of frames, tokens and hidden states,
    and the cache's tensors blocks per `partitioning.cache_shardings`
    (the self-attention KV cache as `lm`'s, the cross K / V by batch
    group and kv heads)."""
    lay = lm.program_layout(cfg, params)
    eg, _ = _groups(encode(cfg, params, frames))
    tg, one = _groups(tokens)
    xg = _embed(cfg, params, lay, tg)
    t = tg[0].shape[1]
    selfs, cks, cvs = [], [], []
    for i in range(cfg.num_layers):
        p = _unit(params["decoder"], i)
        xn = lm._norm(lay, cfg, p["self_norm"], xg)
        h, c = attention.mesh_full(lay, cfg, p["self_attn"], xn,
                                   causal=True, q_block=q_block,
                                   kv_block=kv_block,
                                   fill=(max_len, cache_dtype))
        selfs.append(c)
        xg = [x + hh for x, hh in zip(xg, h)]
        xn = lm._norm(lay, cfg, p["cross_norm"], xg)
        h, (ck, cv) = attention.mesh_cross_kv(
            lay, cfg, p["cross_attn"], xn,
            [e.to(x.dtype) for e, x in zip(eg, xg)], q_block=q_block,
            kv_block=kv_block, dtype=cache_dtype)
        cks.append(ck)
        cvs.append(cv)
        xg = [x + hh for x, hh in zip(xg, h)]
        xn = lm._norm(lay, cfg, p["mlp_norm"], xg)
        xg = [x + hh for x, hh in zip(xg, mlp.mesh_apply(
            lay, cfg.mlp_kind, p["mlp"], xn))]
    xg = lm._norm(lay, cfg, params["final_norm"], xg)
    cache = {"self": lm._stack(selfs)._replace(pos=t),
             "cross_k": lm._stack(cks), "cross_v": lm._stack(cvs), "pos": t}
    return (xg[0] if one else xg), cache


def decode_step(cfg: ModelConfig, params: Params, cache: Cache, x, *,
                donate: bool = False):
    """One decoder token step on embedded x (B, 1, D), or one (B_g, 1, D)
    tensor a batch group on a mesh.

    ``donate``: write the new token into ``cache``'s self-attention
    buffers in place (they become the returned cache's); otherwise
    ``cache`` is left as it was. The cross K/V are only read, and shared
    by both caches."""
    lay = lm.program_layout(cfg, params)
    xg, one = _groups(x)
    self_c = cache["self"] if donate else lm._tree_map(torch.clone,
                                                       cache["self"])
    for i in range(cfg.num_layers):
        p = _unit(params["decoder"], i)
        layer_c = _unit(self_c, i)          # views into the stacked buffers
        xn = lm._norm(lay, cfg, p["self_norm"], xg)
        h, _ = attention.mesh_decode(lay, cfg, p["self_attn"], xn, layer_c)
        xg = [x + hh for x, hh in zip(xg, h)]
        xn = lm._norm(lay, cfg, p["cross_norm"], xg)
        h = attention.mesh_cross_decode(
            lay, cfg, p["cross_attn"], xn, lm._select(cache["cross_k"], i),
            lm._select(cache["cross_v"], i))
        xg = [x + hh for x, hh in zip(xg, h)]
        xn = lm._norm(lay, cfg, p["mlp_norm"], xg)
        xg = [x + hh for x, hh in zip(xg, mlp.mesh_apply(
            lay, cfg.mlp_kind, p["mlp"], xn))]
    xg = lm._norm(lay, cfg, params["final_norm"], xg)
    new_cache = dict(cache, self=self_c._replace(pos=self_c.pos + 1),
                     pos=cache["pos"] + 1)
    return (xg[0] if one else xg), new_cache
