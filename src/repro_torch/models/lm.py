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

One program body runs every layout (`program_layout`): parameters placed
on a `launch.mesh.Mesh` (`distributed.partitioning.Placed` leaves) run
on that mesh, plain tensors on the (1, 1) mesh of their device, where
every collective of `distributed.spmd` is the identity and the program
is the one-device program op for op. Activations travel as one tensor a
batch group (`forward`, `prefill` and `decode_step` take and return such
a list on a mesh, a tensor on one device); norms run on each group's
owner, the mixers, the MLP and the MoE experts on every model shard with
the shards' partial outputs summed: attention and MLA by whole heads
(`attention.mesh_full` / `mesh_decode`, `mla.mesh_full` /
`mesh_decode`), the RG-LRU by channels (`rglru.mesh_full` /
`mesh_decode`), the mLSTM by whole heads (`xlstm.mesh_mlstm_full` /
`mesh_mlstm_decode`), `mlp.mesh_apply`, `moe.mesh_apply`. A mixer whose
heads or channels do not split over the model axis, and the sLSTM (each
channel's gates read other heads' state), runs whole on each group's
owner from its gathered weights (`_owner_full` / `_owner_decode`). Every
config runs on any mesh; the decode caches are blocks per
`partitioning.cache_shardings`.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import spmd
from repro_torch.distributed.partitioning import P, Placed
from repro_torch.launch.mesh import one_device_mesh
from repro_torch.models import sharding_hints
from repro_torch.models.layers import (attention, embedding, mla, mlp, moe,
                                       norms)
from repro_torch.models.layers import rglru as rglru_mod
from repro_torch.models.layers import xlstm

Params = Any
Cache = Any


def _groups(x) -> tuple:
    """(one tensor a batch group, whether ``x`` was one tensor): a mesh
    program's activations, or one device's tensor as its one group."""
    one = isinstance(x, torch.Tensor)
    return ([x] if one else list(x)), one


def _tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of dicts, lists and (named)
    tuples, and to every block of a `Placed` leaf (a shape-preserving
    ``fn``); other leaves (a cache's int positions) pass unchanged."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, Placed):
        return tree.map(fn)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    if isinstance(tree, tuple):
        vals = [_tree_map(fn, v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else tuple(vals)
    return tree


def _stacked_map(fn, tree):
    """``fn`` on every tensor leaf, and on each `Placed` leaf (whose
    leading, stacked axis ``fn`` may take or add)."""
    if isinstance(tree, (torch.Tensor, Placed)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _stacked_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_stacked_map(fn, v) for v in tree]
    if isinstance(tree, tuple):
        vals = [_stacked_map(fn, v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else tuple(vals)
    return tree


def _select(t, u: int):
    """Index ``u`` of a leaf's leading axis: a view (of each block)."""
    if isinstance(t, Placed):
        out = t.map(lambda b: b[u])
        return Placed(t.mesh, P(*t.spec[1:]), t.shape[1:], out.blocks)
    return t[u]


def _unit(tree, u: int):
    """The ``u``-th unit of a stacked tree: views, no copy."""
    return _stacked_map(lambda t: _select(t, u), tree)


def _unbind_units(tree, n: int) -> list:
    """All ``n`` units of a stacked tree (views, no copy), from one
    ``unbind`` a leaf: under autograd each stacked leaf's gradient is then
    written once, where ``n`` selects would each make a zero-filled
    gradient the size of the whole stack and sum them."""
    split = []
    _stacked_map(lambda t: split.append(
        t.unbind0() if isinstance(t, Placed) else t.unbind(0)), tree)
    units = []
    for u in range(n):
        it = iter([s[u] for s in split])
        units.append(_stacked_map(lambda _: next(it), tree))
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
    """The tensor leaves of a tree (a `Placed` leaf's blocks), in
    `_tree_map`'s order."""
    out = []
    _tree_map(out.append, tree)
    return out


def _stack_empty(t, n: int):
    """An empty stack of ``n`` leaves like ``t`` (each block's, placed)."""
    if isinstance(t, Placed):
        out = t.map(lambda b: b.new_empty((n, *b.shape)))
        return Placed(t.mesh, P(None, *t.spec), (n, *t.shape), out.blocks)
    return t.new_empty((n, *t.shape))


def _stack(entries: list):
    """Cache entries of one structure (tensors or `Placed` leaves) stacked
    on a new leading axis, the ``pos`` of the first."""
    out = _stacked_map(lambda a: _stack_empty(a, len(entries)), entries[0])
    for u, c in enumerate(entries):
        _copy_into(_unit(out, u), c)
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


def forward(cfg: ModelConfig, params: Params, x, *,
            prefix_len: int = 0, q_block: int = 512, kv_block: int = 1024,
            remat: bool = True):
    """Run the block stack on embedded activations x (B, T, D) -- on a
    mesh, a list of one (B_g, T, D) tensor a batch group (the output is
    then a list too). Returns (hidden (B,T,D), total aux loss). ``remat``:
    each stacked unit runs under `remat_call` (recomputed in the backward
    pass when gradients are recorded, as the reference's
    ``jax.checkpoint(unit_fn)`` in its scan); the dense prefix and the tail
    are not rematerialised."""
    lay = program_layout(cfg, params)
    xg, one = _groups(x)
    plan = stack_plan(cfg)
    n_prefix = len(plan.prefix)
    kw = dict(prefix_len=prefix_len, q_block=q_block, kv_block=kv_block)
    aux_total = torch.zeros((), dtype=torch.float32, device=xg[0].device)

    for i, kind in enumerate(plan.prefix):
        xg, aux = _block_full(lay, cfg, kind, params["prefix"][i], xg,
                              layer_idx=i, **kw)
        aux_total = aux_total + aux

    def unit_fn(xg, unit_params):
        aux_u = torch.zeros((), dtype=torch.float32, device=xg[0].device)
        for p, kind in enumerate(plan.unit):
            # layer_idx only matters for the moe-vs-dense split, which is
            # uniform inside stacked units
            xg, aux = _block_full(lay, cfg, kind, unit_params[p], xg,
                                  layer_idx=n_prefix + p, **kw)
            aux_u = aux_u + aux
        return xg, aux_u

    if plan.n_units > 0:
        aux_units = []
        for unit_params in _unbind_units(params["units"], plan.n_units):
            xg, aux_u = remat_call(remat, unit_fn, xg, unit_params)
            aux_units.append(aux_u)
        aux_total = aux_total + torch.sum(torch.stack(aux_units))

    base_tail = n_prefix + plan.n_units * len(plan.unit)
    for i, kind in enumerate(plan.tail):
        xg, aux = _block_full(lay, cfg, kind, params["tail"][i], xg,
                              layer_idx=base_tail + i, **kw)
        aux_total = aux_total + aux

    xg = _norm(lay, cfg, params["final_norm"], xg)
    return (xg[0] if one else xg), aux_total


# ---------------------------------------------------------------------------
# the program on a mesh (`distributed.spmd`)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _one_device_layout(dev: torch.device) -> spmd.Layout:
    return spmd.layout(one_device_mesh(dev))


def program_layout(cfg: ModelConfig, params: Params) -> spmd.Layout:
    """The layout the program runs on: the mesh that the parameters are
    placed on (`partitioning.Placed`), else the one-position mesh of their
    device. Inside `sharding_hints.activation_sharding` the parameters
    must lie on its mesh."""
    leaf = params["embedding"]["embed"]
    if isinstance(leaf, Placed):
        lay = spmd.layout(leaf.mesh)
    else:
        lay = _one_device_layout(leaf.device)
    ctx = sharding_hints.current()
    if ctx is not None and not lay.single and ctx[0] is not lay.mesh:
        raise ValueError(f"parameters placed on {lay.mesh} inside the "
                         f"sharding context of {ctx[0]}")
    return lay


def _norm(lay, cfg: ModelConfig, params: dict, xg: list) -> list:
    """A norm on each batch group's owner (its weights replicated)."""
    w = spmd.gather_tree(lay, params, users=lay.owners())
    return [norms.apply(cfg.norm_kind, w[g], x) for g, x in enumerate(xg)]


def _mlp(lay, cfg: ModelConfig, params: dict, xg: list, layer_idx: int,
         decode: bool = False):
    """The block's feed-forward half: (xg, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=xg[0].device)
    if "mlp" in params:
        xn = _norm(lay, cfg, params["mlp_norm"], xg)
        if _is_moe_layer(cfg, layer_idx):
            h, aux = moe.mesh_apply(lay, cfg, params["mlp"], xn,
                                    decode=decode)
        elif cfg.moe is not None:
            h = mlp.mesh_apply(lay, "silu_glu", params["mlp"], xn)
        else:
            h = mlp.mesh_apply(lay, cfg.mlp_kind, params["mlp"], xn)
        xg = [x + hh for x, hh in zip(xg, h)]
    return xg, aux


def _mixer_full(cfg: ModelConfig, kind: str, params: dict, x: torch.Tensor,
                *, q_block: int, kv_block: int, fill: tuple | None):
    """The mixing half of a block on one batch group's owner, from its
    gathered weights: (h, the block's decode-cache entry with ``fill``,
    else None)."""
    cache = None
    if kind == "attn":
        xn = norms.apply(cfg.norm_kind, params["mix_norm"], x)
        if fill is None:
            h = mla.fwd_full(cfg, params["mix"], xn, q_block=q_block,
                             kv_block=kv_block)
        else:
            h, (c_kv, k_rope) = mla.fwd_full(cfg, params["mix"], xn,
                                             q_block=q_block,
                                             kv_block=kv_block,
                                             return_latent=True)
            cache = mla.fill_cache(cfg, c_kv, k_rope, fill[0], fill[1])
        return h, cache
    state = fill is not None
    if kind == "rglru":
        xn = norms.apply(cfg.norm_kind, params["mix_norm"], x)
        out = rglru_mod.fwd_full(cfg, params["mix"], xn, return_state=state)
    elif kind == "mlstm":
        out = xlstm.mlstm_block(cfg, params["mix"], x, return_state=state)
    elif kind == "slstm":
        out = xlstm.slstm_block(cfg, params["mix"], x, return_state=state)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    return out if state else (out, None)


def _mixer_decode(cfg: ModelConfig, kind: str, params: dict,
                  x: torch.Tensor, cache):
    """One decode step of a mixer on one batch group's owner: (h, the
    new entry; an MLA cache is written in place and returned)."""
    if kind == "attn":
        xn = norms.apply(cfg.norm_kind, params["mix_norm"], x)
        decode_fn = mla.fwd_decode_absorbed if cfg.mla_absorbed \
            else mla.fwd_decode
        return decode_fn(cfg, params["mix"], xn, cache, donate=True)
    if kind == "rglru":
        return rglru_mod.fwd_decode(
            cfg, params["mix"],
            norms.apply(cfg.norm_kind, params["mix_norm"], x), cache)
    if kind == "mlstm":
        return xlstm.mlstm_block_decode(cfg, params["mix"], x, cache)
    if kind == "slstm":
        return xlstm.slstm_block_decode(cfg, params["mix"], x, cache)
    raise ValueError(f"unknown block kind {kind!r}")


def _split_mixer(lay, cfg: ModelConfig, kind: str, params: dict) -> bool:
    """Whether a mixer runs split over the model shards (its mesh form)
    rather than whole on each batch group's owner: MLA by whole heads,
    the RG-LRU by channels, the mLSTM by whole heads (`*.splits`); the
    sLSTM never (each channel's gates read other heads' state)."""
    if kind == "attn":
        return mla.splits(lay, cfg, params["mix"])
    if kind == "rglru":
        return rglru_mod.splits(lay, params["mix"])
    if kind == "mlstm":
        return xlstm.mlstm_splits(lay, cfg, params["mix"])
    return False


def _mixing(params: dict) -> dict:
    """A block's mixing half's parameters (its norm and mixer)."""
    return {k: v for k, v in params.items() if k in ("mix_norm", "mix")}


def _owner_full(lay, cfg: ModelConfig, kind: str, params: dict, xg: list,
                *, q_block: int, kv_block: int, fill: tuple | None):
    """A mixer whole on each batch group's owner (its weights gathered
    there): (one output a group, the decode-cache entry placed per
    `cache_shardings` with ``fill``)."""
    w = spmd.gather_tree(lay, _mixing(params), users=lay.owners())
    outs = [_mixer_full(cfg, kind, w[g], x, q_block=q_block,
                        kv_block=kv_block, fill=fill)
            for g, x in enumerate(xg)]
    cache = spmd.place_state(lay, [c for _, c in outs]) \
        if fill is not None else None
    return [h for h, _ in outs], cache


def _owner_decode(lay, cfg: ModelConfig, kind: str, params: dict,
                  xg: list, cache):
    """`_mixer_decode` on each batch group's owner, on its rows of
    ``cache`` (assembled from the blocks), the new entry written back
    into the blocks."""
    w = spmd.gather_tree(lay, _mixing(params), users=lay.owners())
    h = []
    for g, x in enumerate(xg):
        rows = type(cache)(*[spmd.group_rows(lay, v, g)
                             if isinstance(v, (torch.Tensor, Placed)) else v
                             for v in cache])
        out, new = _mixer_decode(cfg, kind, w[g], x, rows)
        for v, nv in zip(cache, new):
            if isinstance(v, (torch.Tensor, Placed)):
                spmd.write_rows(lay, v, g, nv)
        h.append(out)
    return h, cache._replace(pos=cache.pos + 1)


def _mix_full(lay, cfg: ModelConfig, kind: str, params: dict, xg: list,
              *, prefix_len: int, q_block: int, kv_block: int,
              fill: tuple | None):
    """The mixing half of a full-sequence block: (one output a group, the
    decode-cache entry or None)."""
    if kind == "attn" and cfg.mla is None:
        xn = _norm(lay, cfg, params["mix_norm"], xg)
        return attention.mesh_full(lay, cfg, params["mix"], xn,
                                   prefix_len=prefix_len, q_block=q_block,
                                   kv_block=kv_block, fill=fill)
    if not _split_mixer(lay, cfg, kind, params):
        return _owner_full(lay, cfg, kind, params, xg, q_block=q_block,
                           kv_block=kv_block, fill=fill)
    if kind == "attn":
        xn = _norm(lay, cfg, params["mix_norm"], xg)
        return mla.mesh_full(lay, cfg, params["mix"], xn, q_block=q_block,
                             kv_block=kv_block, fill=fill)
    if kind == "rglru":
        xn = _norm(lay, cfg, params["mix_norm"], xg)
        return rglru_mod.mesh_full(lay, cfg, params["mix"], xn,
                                   fill=fill is not None)
    return xlstm.mesh_mlstm_full(lay, cfg, params["mix"], xg,
                                 fill=fill is not None)


def _mix_decode(lay, cfg: ModelConfig, kind: str, params: dict, xg: list,
                cache):
    """One decode step of a block's mixing half, writing into ``cache``:
    (one output a group, the cache)."""
    if kind == "attn" and cfg.mla is None:
        xn = _norm(lay, cfg, params["mix_norm"], xg)
        return attention.mesh_decode(lay, cfg, params["mix"], xn, cache)
    if not _split_mixer(lay, cfg, kind, params):
        return _owner_decode(lay, cfg, kind, params, xg, cache)
    if kind == "mlstm":
        return xlstm.mesh_mlstm_decode(lay, cfg, params["mix"], xg, cache)
    xn = _norm(lay, cfg, params["mix_norm"], xg)
    if kind == "attn":
        return mla.mesh_decode(lay, cfg, params["mix"], xn, cache)
    return rglru_mod.mesh_decode(lay, cfg, params["mix"], xn, cache)


def _block_full(lay, cfg: ModelConfig, kind: str, params: dict, xg: list,
                *, layer_idx: int, prefix_len: int, q_block: int,
                kv_block: int, fill: tuple | None = None):
    """A full-sequence block: (xg, aux), and the block's decode cache with
    ``fill`` = (max_len, cache dtype)."""
    h, cache = _mix_full(lay, cfg, kind, params, xg, prefix_len=prefix_len,
                         q_block=q_block, kv_block=kv_block, fill=fill)
    xg, aux = _mlp(lay, cfg, params, [x + hh for x, hh in zip(xg, h)],
                   layer_idx)
    return (xg, aux) if fill is None else (xg, aux, cache)


def _block_decode(lay, cfg: ModelConfig, kind: str, params: dict,
                  xg: list, cache, *, layer_idx: int):
    """One decode step of a block, writing into ``cache``."""
    h, cache = _mix_decode(lay, cfg, kind, params, xg, cache)
    xg, _ = _mlp(lay, cfg, params, [x + hh for x, hh in zip(xg, h)],
                 layer_idx, decode=True)
    return xg, cache


def apply_block_full(cfg: ModelConfig, kind: str, params: dict,
                     x: torch.Tensor, *, layer_idx: int, prefix_len: int = 0,
                     q_block: int, kv_block: int):
    """Full-sequence block on one device. Returns (x, aux_loss)."""
    xg, aux = _block_full(_one_device_layout(x.device), cfg, kind, params,
                          [x], layer_idx=layer_idx, prefix_len=prefix_len,
                          q_block=q_block, kv_block=kv_block)
    return xg[0], aux


def apply_block_decode(cfg: ModelConfig, kind: str, params: dict,
                       x: torch.Tensor, cache, *, layer_idx: int):
    """One decode step of a block on one device, writing into ``cache``.
    Returns (x, cache)."""
    xg, cache = _block_decode(_one_device_layout(x.device), cfg, kind,
                              params, [x], cache, layer_idx=layer_idx)
    return xg[0], cache


def apply_block_prefill(cfg: ModelConfig, kind: str, params: dict,
                        x: torch.Tensor, *, layer_idx: int, max_len: int,
                        prefix_len: int = 0, q_block: int, kv_block: int,
                        cache_dtype=torch.bfloat16):
    """Full-sequence block on one device that also emits its decode-cache
    entry. Returns (x, aux_loss, cache)."""
    xg, aux, cache = _block_full(
        _one_device_layout(x.device), cfg, kind, params, [x],
        layer_idx=layer_idx, prefix_len=prefix_len, q_block=q_block,
        kv_block=kv_block, fill=(max_len, cache_dtype))
    return xg[0], aux, cache


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


def prefill(cfg: ModelConfig, params: Params, x, *,
            max_len: int, prefix_len: int = 0, q_block: int = 512,
            kv_block: int = 1024, cache_dtype=torch.bfloat16):
    """Prefill on embedded activations x (B, T, D), or one (B_g, T, D)
    tensor a batch group on a mesh. Returns (hidden, cache); on a mesh the
    cache's tensors are blocks per `partitioning.cache_shardings`."""
    lay = program_layout(cfg, params)
    xg, one = _groups(x)
    plan = stack_plan(cfg)
    n_prefix = len(plan.prefix)
    t = xg[0].shape[1]
    kw = dict(prefix_len=prefix_len, q_block=q_block, kv_block=kv_block,
              fill=(max_len, cache_dtype))

    new_prefix = []
    for i, kind in enumerate(plan.prefix):
        xg, _, c = _block_full(lay, cfg, kind, params["prefix"][i], xg,
                               layer_idx=i, **kw)
        new_prefix.append(c)

    # the units' entries stacked on a leading axis, each buffer made from
    # unit 0's entry (its shapes, its ``pos``) and filled unit by unit
    new_units = [None] * len(plan.unit) if plan.n_units > 0 else []
    for u in range(plan.n_units):
        unit_params = _unit(params["units"], u)
        for p, kind in enumerate(plan.unit):
            xg, _, c = _block_full(lay, cfg, kind, unit_params[p], xg,
                                   layer_idx=n_prefix + p, **kw)
            if u == 0:
                new_units[p] = _stacked_map(
                    lambda a: _stack_empty(a, plan.n_units), c)
            _copy_into(_unit(new_units[p], u), c)

    base_tail = n_prefix + plan.n_units * len(plan.unit)
    new_tail = []
    for i, kind in enumerate(plan.tail):
        xg, _, c = _block_full(lay, cfg, kind, params["tail"][i], xg,
                               layer_idx=base_tail + i, **kw)
        new_tail.append(c)

    xg = _norm(lay, cfg, params["final_norm"], xg)
    cache = {"prefix": new_prefix, "units": new_units, "tail": new_tail,
             "pos": t}
    return (xg[0] if one else xg), cache


def decode_step(cfg: ModelConfig, params: Params, cache: Cache, x, *,
                donate: bool = False):
    """One token step on embedded activations x (B, 1, D), or one
    (B_g, 1, D) tensor a batch group on a mesh.

    ``donate``: update ``cache``'s buffers in place (they become the
    returned cache's); otherwise ``cache`` is left as it was."""
    lay = program_layout(cfg, params)
    xg, one = _groups(x)
    if not donate:
        cache = _tree_map(torch.clone, cache)
    plan = stack_plan(cfg)
    n_prefix = len(plan.prefix)
    new_prefix = []
    for i, kind in enumerate(plan.prefix):
        xg, c = _block_decode(lay, cfg, kind, params["prefix"][i], xg,
                              cache["prefix"][i], layer_idx=i)
        new_prefix.append(c)

    new_units = cache["units"]
    if plan.n_units > 0:
        for u in range(plan.n_units):
            unit_params = _unit(params["units"], u)
            for p, kind in enumerate(plan.unit):
                # the unit's cache entry is a view into the stacked buffer
                xg, _ = _block_decode(lay, cfg, kind, unit_params[p], xg,
                                      _unit(cache["units"][p], u),
                                      layer_idx=n_prefix + p)
        new_units = [c._replace(pos=c.pos + 1) for c in cache["units"]]

    base_tail = n_prefix + plan.n_units * len(plan.unit)
    new_tail = []
    for i, kind in enumerate(plan.tail):
        xg, c = _block_decode(lay, cfg, kind, params["tail"][i], xg,
                              cache["tail"][i], layer_idx=base_tail + i)
        new_tail.append(c)

    xg = _norm(lay, cfg, params["final_norm"], xg)
    new_cache = {"prefix": new_prefix, "units": new_units, "tail": new_tail,
                 "pos": cache["pos"] + 1}
    return (xg[0] if one else xg), new_cache
