"""Decoder-only LM assembly: pattern-stacked blocks, train/prefill/decode.

Port of `repro.models.lm`. The parameter tree is the reference's: the
repeating *pattern units* of the config have their parameters stacked
along a leading unit axis (``units``: one dict a block of the pattern,
each leaf (n_units, ...)), and non-conforming layers (deepseek's
dense-FFN first layer, pattern tails) are unrolled as ``prefix`` /
``tail`` lists. So weights convert 1:1 (`repro_torch.convert.
lm_params_from_numpy`). Where the reference runs the units under
``jax.lax.scan``, the port loops over the leading axis, on views of the
stacked parameters.

Caches mirror the same prefix/units/tail structure, the units' caches
stacked on the leading axis. A cache's positions are Python ints.

Block kinds: ``attn`` (GQA/MQA attention, `layers/attention.py`, or
multi-head latent attention when ``cfg.mla`` is set, `layers/mla.py`),
``rglru`` (`layers/rglru.py`), ``mlstm`` and ``slstm``
(`layers/xlstm.py`). A recurrent block's cache entry is its state (a
NamedTuple of tensors and a Python-int ``pos``); a donated decode step
writes the new state into the given state's buffers.

The VLM (paligemma) path consumes precomputed patch embeddings as a
full-attention prefix (prefix-LM masking); the frontend is a stub per the
assignment.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (attention, embedding, mla, mlp, moe,
                                       norms)
from repro_torch.models.layers import rglru as rglru_mod
from repro_torch.models.layers import xlstm

Params = Any
Cache = Any


def _tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of dicts, lists and (named)
    tuples; other leaves (a cache's int positions) pass unchanged."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    if isinstance(tree, tuple):
        vals = [_tree_map(fn, v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else tuple(vals)
    return tree


def _unit(tree, u: int):
    """The ``u``-th unit of a stacked tree: views, no copy."""
    return _tree_map(lambda t: t[u], tree)


def _unbind_units(tree, n: int) -> list:
    """All ``n`` units of a stacked tree (views, no copy), from one
    ``unbind`` a leaf: under autograd each stacked leaf's gradient is then
    written once, where ``n`` selects would each make a zero-filled
    gradient the size of the whole stack and sum them."""
    split = [t.unbind(0) for t in _leaves(tree)]
    units = []
    for u in range(n):
        it = iter([s[u] for s in split])
        units.append(_tree_map(lambda _: next(it), tree))
    return units


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``, rematerialised under its gradient when ``remat`` and
    gradients are being recorded (the reference's ``jax.checkpoint``): its
    activations are recomputed in the backward pass instead of kept. The
    forward computes the same ops either way."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _leaves(tree) -> list:
    """The tensor leaves of a tree, in `_tree_map`'s order."""
    out = []
    _tree_map(out.append, tree)
    return out


def _copy_into(dst, src) -> None:
    """Write every tensor leaf of ``src`` into ``dst``'s (same structure)."""
    for d, s in zip(_leaves(dst), _leaves(src), strict=True):
        d.copy_(s)


# ---------------------------------------------------------------------------
# per-block init / apply
# ---------------------------------------------------------------------------

def _is_moe_layer(cfg: ModelConfig, layer_idx: int) -> bool:
    return (cfg.moe is not None
            and layer_idx >= cfg.moe.first_dense_layers)


def init_block(key: torch.Generator, cfg: ModelConfig, kind: str,
               layer_idx: int, dtype=torch.float32, *,
               lead: tuple = ()) -> dict:
    """One block's parameters on ``key``'s device; ``lead`` stacks them
    (the scanned units)."""
    dev = key.device
    p: dict = {}
    if kind == "attn":
        p["mix_norm"] = norms.init(cfg.norm_kind, cfg.d_model, dtype,
                                   lead=lead, device=dev)
        p["mix"] = (mla.init(key, cfg, dtype, lead=lead)
                    if cfg.mla is not None
                    else attention.init(key, cfg, dtype, lead=lead))
    elif kind == "rglru":
        p["mix_norm"] = norms.init(cfg.norm_kind, cfg.d_model, dtype,
                                   lead=lead, device=dev)
        p["mix"] = rglru_mod.init(key, cfg, dtype, lead=lead)
    elif kind == "mlstm":
        p["mix"] = xlstm.init_mlstm(key, cfg, dtype, lead=lead)  # owns its LN
    elif kind == "slstm":
        p["mix"] = xlstm.init_slstm(key, cfg, dtype, lead=lead)
    else:
        raise ValueError(f"unknown block kind {kind!r}")

    if _is_moe_layer(cfg, layer_idx):
        p["mlp_norm"] = norms.init(cfg.norm_kind, cfg.d_model, dtype,
                                   lead=lead, device=dev)
        p["mlp"] = moe.init(key, cfg, dtype, lead=lead)
    elif cfg.moe is not None and layer_idx < cfg.moe.first_dense_layers:
        p["mlp_norm"] = norms.init(cfg.norm_kind, cfg.d_model, dtype,
                                   lead=lead, device=dev)
        p["mlp"] = mlp.init(key, "silu_glu", cfg.d_model,
                            cfg.moe.d_ff_dense_first, dtype, lead=lead)
    elif cfg.d_ff > 0:
        p["mlp_norm"] = norms.init(cfg.norm_kind, cfg.d_model, dtype,
                                   lead=lead, device=dev)
        p["mlp"] = mlp.init(key, cfg.mlp_kind, cfg.d_model, cfg.d_ff, dtype,
                            lead=lead)
    return p


def _mlp(cfg: ModelConfig, params: dict, x: torch.Tensor, layer_idx: int):
    """The block's feed-forward half: (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if "mlp" in params:
        xn = norms.apply(cfg.norm_kind, params["mlp_norm"], x)
        if _is_moe_layer(cfg, layer_idx):
            h, aux = moe.apply(cfg, params["mlp"], xn)
        elif cfg.moe is not None:
            h = mlp.apply("silu_glu", params["mlp"], xn)
        else:
            h = mlp.apply(cfg.mlp_kind, params["mlp"], xn)
        x = x + h
    return x, aux


def apply_block_full(cfg: ModelConfig, kind: str, params: dict,
                     x: torch.Tensor, *, layer_idx: int, prefix_len: int = 0,
                     q_block: int, kv_block: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence block. Returns (x, aux_loss)."""
    if kind == "attn":
        xn = norms.apply(cfg.norm_kind, params["mix_norm"], x)
        if cfg.mla is not None:
            h = mla.fwd_full(cfg, params["mix"], xn, q_block=q_block,
                             kv_block=kv_block)
        else:
            h = attention.fwd_full(cfg, params["mix"], xn,
                                   prefix_len=prefix_len, q_block=q_block,
                                   kv_block=kv_block)
    elif kind == "rglru":
        xn = norms.apply(cfg.norm_kind, params["mix_norm"], x)
        h = rglru_mod.fwd_full(cfg, params["mix"], xn)
    elif kind == "mlstm":
        h = xlstm.mlstm_block(cfg, params["mix"], x)
    elif kind == "slstm":
        h = xlstm.slstm_block(cfg, params["mix"], x)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    return _mlp(cfg, params, x + h, layer_idx)


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype=torch.bfloat16, *, lead: tuple = (),
                     device=None):
    """A block's empty decode cache: a KV or latent cache in ``dtype``
    (attention), or a float32 recurrent state."""
    if kind == "attn":
        mod = mla if cfg.mla is not None else attention
        return mod.init_cache(cfg, batch, max_len, dtype, lead=lead,
                              device=device)
    if kind == "rglru":
        return rglru_mod.init_state(cfg, batch, lead=lead, device=device)
    if kind == "mlstm":
        return xlstm.init_mlstm_state(cfg, batch, lead=lead, device=device)
    if kind == "slstm":
        return xlstm.init_slstm_state(cfg, batch, lead=lead, device=device)
    raise ValueError(f"unknown block kind {kind!r}")


def apply_block_decode(cfg: ModelConfig, kind: str, params: dict,
                       x: torch.Tensor, cache, *, layer_idx: int,
                       donate: bool = False):
    """One decode step of a block; ``donate`` writes into ``cache``."""
    if kind == "attn":
        xn = norms.apply(cfg.norm_kind, params["mix_norm"], x)
        if cfg.mla is not None:
            decode_fn = mla.fwd_decode_absorbed if cfg.mla_absorbed \
                else mla.fwd_decode
        else:
            decode_fn = attention.fwd_decode
        h, cache = decode_fn(cfg, params["mix"], xn, cache, donate=donate)
    else:
        if kind == "rglru":
            h, new = rglru_mod.fwd_decode(
                cfg, params["mix"],
                norms.apply(cfg.norm_kind, params["mix_norm"], x), cache)
        elif kind == "mlstm":
            h, new = xlstm.mlstm_block_decode(cfg, params["mix"], x, cache)
        elif kind == "slstm":
            h, new = xlstm.slstm_block_decode(cfg, params["mix"], x, cache)
        else:
            raise ValueError(f"unknown block kind {kind!r}")
        if donate:                    # the new state into the given buffers
            _copy_into(cache, new)
            new = cache._replace(pos=new.pos)
        cache = new
    x, _ = _mlp(cfg, params, x + h, layer_idx)
    return x, cache


# ---------------------------------------------------------------------------
# stack structure: prefix (unrolled) + units (stacked) + tail (unrolled)
# ---------------------------------------------------------------------------

class StackPlan(NamedTuple):
    prefix: tuple[str, ...]          # unrolled leading layer kinds
    unit: tuple[str, ...]            # repeating pattern
    n_units: int
    tail: tuple[str, ...]            # unrolled trailing kinds


def stack_plan(cfg: ModelConfig) -> StackPlan:
    kinds = cfg.layer_kinds()
    n_prefix = cfg.moe.first_dense_layers if cfg.moe is not None else 0
    body = kinds[n_prefix:]
    unit = cfg.block_pattern
    n_units = len(body) // len(unit)
    tail = body[n_units * len(unit):]
    return StackPlan(prefix=kinds[:n_prefix], unit=unit,
                     n_units=n_units, tail=tail)


def init_params(key: torch.Generator, cfg: ModelConfig, *,
                max_positions: int = 0, dtype=torch.float32) -> Params:
    """Random parameters on ``key``'s device, drawn tensor by tensor from
    ``key``; the units' parameters are drawn straight into their stacked
    tensors (no per-unit temporary)."""
    plan = stack_plan(cfg)
    n_prefix = len(plan.prefix)
    params: dict = {
        "embedding": embedding.init(key, cfg, max_positions=max_positions,
                                    dtype=dtype),
        "final_norm": norms.init(cfg.norm_kind, cfg.d_model, dtype,
                                 device=key.device),
    }
    params["prefix"] = [init_block(key, cfg, kind, i, dtype)
                        for i, kind in enumerate(plan.prefix)]
    if plan.n_units > 0:
        params["units"] = [
            init_block(key, cfg, kind, n_prefix + p, dtype,
                       lead=(plan.n_units,))
            for p, kind in enumerate(plan.unit)]
    else:
        params["units"] = []
    base_tail = n_prefix + plan.n_units * len(plan.unit)
    params["tail"] = [init_block(key, cfg, kind, base_tail + i, dtype)
                      for i, kind in enumerate(plan.tail)]
    return params


def forward(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
            prefix_len: int = 0, q_block: int = 512, kv_block: int = 1024,
            remat: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the block stack on embedded activations x (B, T, D).
    Returns (hidden (B,T,D), total aux loss). ``remat``: each stacked
    unit runs under `remat_call` (recomputed in the backward pass when
    gradients are recorded, as the reference's ``jax.checkpoint(unit_fn)``
    in its scan); the dense prefix and the tail are not rematerialised."""
    plan = stack_plan(cfg)
    n_prefix = len(plan.prefix)
    kw = dict(prefix_len=prefix_len, q_block=q_block, kv_block=kv_block)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    for i, kind in enumerate(plan.prefix):
        x, aux = apply_block_full(cfg, kind, params["prefix"][i], x,
                                  layer_idx=i, **kw)
        aux_total = aux_total + aux

    def unit_fn(x, unit_params):
        aux_u = torch.zeros((), dtype=torch.float32, device=x.device)
        for p, kind in enumerate(plan.unit):
            # layer_idx only matters for the moe-vs-dense split, which is
            # uniform inside stacked units
            x, aux = apply_block_full(cfg, kind, unit_params[p], x,
                                      layer_idx=n_prefix + p, **kw)
            aux_u = aux_u + aux
        return x, aux_u

    if plan.n_units > 0:
        aux_units = []
        for unit_params in _unbind_units(params["units"], plan.n_units):
            x, aux_u = remat_call(remat, unit_fn, x, unit_params)
            aux_units.append(aux_u)
        aux_total = aux_total + torch.sum(torch.stack(aux_units))

    base_tail = n_prefix + plan.n_units * len(plan.unit)
    for i, kind in enumerate(plan.tail):
        x, aux = apply_block_full(cfg, kind, params["tail"][i], x,
                                  layer_idx=base_tail + i, **kw)
        aux_total = aux_total + aux

    x = norms.apply(cfg.norm_kind, params["final_norm"], x)
    return x, aux_total


# ---------------------------------------------------------------------------
# caches: same prefix/units/tail structure
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, device=None) -> Cache:
    plan = stack_plan(cfg)
    cache = {
        "prefix": [init_block_cache(cfg, k, batch, max_len, dtype,
                                    device=device) for k in plan.prefix],
        "tail": [init_block_cache(cfg, k, batch, max_len, dtype,
                                  device=device) for k in plan.tail],
        "pos": 0,
    }
    cache["units"] = [
        init_block_cache(cfg, k, batch, max_len, dtype,
                         lead=(plan.n_units,), device=device)
        for k in plan.unit] if plan.n_units > 0 else []
    return cache


def apply_block_prefill(cfg: ModelConfig, kind: str, params: dict,
                        x: torch.Tensor, *, layer_idx: int, max_len: int,
                        prefix_len: int = 0, q_block: int, kv_block: int,
                        cache_dtype=torch.bfloat16):
    """Full-sequence block that also emits its decode-cache entry."""
    if kind == "attn":
        xn = norms.apply(cfg.norm_kind, params["mix_norm"], x)
        if cfg.mla is not None:
            h, (c_kv, k_rope) = mla.fwd_full(cfg, params["mix"], xn,
                                             q_block=q_block,
                                             kv_block=kv_block,
                                             return_latent=True)
            cache = mla.fill_cache(cfg, c_kv, k_rope, max_len, cache_dtype)
        else:
            h, (k_all, v_all) = attention.fwd_full(cfg, params["mix"], xn,
                                                   prefix_len=prefix_len,
                                                   q_block=q_block,
                                                   kv_block=kv_block,
                                                   return_kv=True)
            cache = attention.fill_cache(cfg, k_all, v_all, max_len,
                                         cache_dtype)
    elif kind == "rglru":
        xn = norms.apply(cfg.norm_kind, params["mix_norm"], x)
        h, cache = rglru_mod.fwd_full(cfg, params["mix"], xn,
                                      return_state=True)
    elif kind == "mlstm":
        h, cache = xlstm.mlstm_block(cfg, params["mix"], x, return_state=True)
    elif kind == "slstm":
        h, cache = xlstm.slstm_block(cfg, params["mix"], x, return_state=True)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    x, aux = _mlp(cfg, params, x + h, layer_idx)
    return x, aux, cache


def prefill(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
            max_len: int, prefix_len: int = 0, q_block: int = 512,
            kv_block: int = 1024, cache_dtype=torch.bfloat16
            ) -> tuple[torch.Tensor, Cache]:
    """Prefill on embedded activations x (B, T, D). Returns (hidden, cache)."""
    plan = stack_plan(cfg)
    n_prefix = len(plan.prefix)
    t = x.shape[1]
    kw = dict(max_len=max_len, prefix_len=prefix_len, q_block=q_block,
              kv_block=kv_block, cache_dtype=cache_dtype)

    new_prefix = []
    for i, kind in enumerate(plan.prefix):
        x, _, c = apply_block_prefill(cfg, kind, params["prefix"][i], x,
                                      layer_idx=i, **kw)
        new_prefix.append(c)

    # the units' entries stacked on a leading axis, each buffer made from
    # unit 0's entry (its shapes, its ``pos``) and filled unit by unit
    new_units = [None] * len(plan.unit) if plan.n_units > 0 else []
    for u in range(plan.n_units):
        unit_params = _unit(params["units"], u)
        for p, kind in enumerate(plan.unit):
            x, _, c = apply_block_prefill(cfg, kind, unit_params[p], x,
                                          layer_idx=n_prefix + p, **kw)
            if u == 0:
                new_units[p] = _tree_map(
                    lambda a: a.new_empty((plan.n_units, *a.shape)), c)
            _copy_into(_unit(new_units[p], u), c)

    base_tail = n_prefix + plan.n_units * len(plan.unit)
    new_tail = []
    for i, kind in enumerate(plan.tail):
        x, _, c = apply_block_prefill(cfg, kind, params["tail"][i], x,
                                      layer_idx=base_tail + i, **kw)
        new_tail.append(c)

    x = norms.apply(cfg.norm_kind, params["final_norm"], x)
    cache = {"prefix": new_prefix, "units": new_units, "tail": new_tail,
             "pos": t}
    return x, cache


def decode_step(cfg: ModelConfig, params: Params, cache: Cache,
                x: torch.Tensor, *, donate: bool = False
                ) -> tuple[torch.Tensor, Cache]:
    """One token step on embedded activations x (B, 1, D).

    ``donate``: update ``cache``'s buffers in place (they become the
    returned cache's); otherwise ``cache`` is left as it was."""
    if not donate:
        cache = _tree_map(torch.clone, cache)
    plan = stack_plan(cfg)
    n_prefix = len(plan.prefix)
    new_prefix = []
    for i, kind in enumerate(plan.prefix):
        x, c = apply_block_decode(cfg, kind, params["prefix"][i], x,
                                  cache["prefix"][i], layer_idx=i,
                                  donate=True)
        new_prefix.append(c)

    new_units = cache["units"]
    if plan.n_units > 0:
        for u in range(plan.n_units):
            unit_params = _unit(params["units"], u)
            for p, kind in enumerate(plan.unit):
                # the unit's cache entry is a view into the stacked buffer
                x, _ = apply_block_decode(cfg, kind, unit_params[p], x,
                                          _unit(cache["units"][p], u),
                                          layer_idx=n_prefix + p,
                                          donate=True)
        new_units = [c._replace(pos=c.pos + 1) for c in cache["units"]]

    base_tail = n_prefix + plan.n_units * len(plan.unit)
    new_tail = []
    for i, kind in enumerate(plan.tail):
        x, c = apply_block_decode(cfg, kind, params["tail"][i], x,
                                  cache["tail"][i], layer_idx=base_tail + i,
                                  donate=True)
        new_tail.append(c)

    x = norms.apply(cfg.norm_kind, params["final_norm"], x)
    new_cache = {"prefix": new_prefix, "units": new_units, "tail": new_tail,
                 "pos": cache["pos"] + 1}
    return x, new_cache
