"""Uniform model API over the assembly families.

Port of `repro.models.registry`. ``build_model(cfg)`` returns a ModelAPI
whose five functions are what the training and serving loops need:

    init(key)                  -> params
    loss(params, batch)        -> (scalar loss, metrics dict); its gradient
                                  comes from `torch.autograd` on leaf
                                  parameters (`train.build_train_step`),
                                  each stacked unit rematerialised when
                                  ``remat``
    prefill(params, batch)     -> (last-position logits, cache)
    decode(params, cache, tok) -> (logits, new cache)
    init_cache(batch, max_len) -> cache

``key`` is a `torch.Generator` (the parameters are made on its device)
or an int seed for a generator on the model's ``device``. Batches (int
tokens; stub modalities per the assignment):

    lm:    {tokens (B,S), labels (B,S)}
    vlm:   {patches (B,P,D) f32, tokens (B,S-P), labels (B,S-P)}
    audio: {frames (B,F,D) f32, tokens (B,S), labels (B,S)}

Batch arrays may be numpy or torch; they are moved to the parameters'
device.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import spmd
from repro_torch.models import encdec, lm
from repro_torch.models.layers import embedding

# decode tables for whisper's learned positions are sized to the largest
# assigned decode shape
_MAX_LEARNED_POS = 32768


class ModelAPI(NamedTuple):
    cfg: ModelConfig
    init: Callable[..., Any]
    loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    init_cache: Callable[..., Any]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean next-token CE, f32 softmax, ignoring labels < 0."""
    total, count = _ce_terms(logits, labels)
    return total / torch.clamp_min(count, 1.0)


def _ce_terms(logits: torch.Tensor, labels: torch.Tensor):
    """(sum of the CE over the labels >= 0, their count), float32."""
    from repro_torch.models.sharding_hints import hint_logits
    logits = hint_logits(logits.to(torch.float32))
    labels = labels.to(logits.device).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(
        logits, torch.clamp_min(labels, 0)[..., None], dim=-1)[..., 0]
    nll = logz - gold
    mask = (labels >= 0).to(torch.float32)
    return torch.sum(nll * mask), torch.sum(mask)


def _compute_dtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32


def build_model(cfg: ModelConfig, *, q_block: int = 512,
                kv_block: int = 1024, remat: bool = True,
                device="cuda") -> ModelAPI:
    """The model's API. ``device``: where `init` makes the parameters from
    an int seed and `init_cache` its caches (the card unless the caller
    asks for the CPU); the other functions run where their parameters
    lie."""
    build = _build_encdec if cfg.family == "audio" else _build_lm
    return build(cfg, q_block, kv_block, remat, torch.device(device))


def _rows(lay, x) -> list:
    """A batch array (numpy, torch or placed) as each batch group's rows
    on its owner (`spmd.rows_of`)."""
    return [spmd.rows_of(lay, x, g) for g in range(lay.n_groups)]


def _generator(key, device: torch.device) -> torch.Generator:
    """``key`` itself, or a generator on ``device`` seeded with it."""
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=device).manual_seed(int(key))


# ---------------------------------------------------------------------------
# decoder-only (lm / moe / vlm)
# ---------------------------------------------------------------------------

def _build_lm(cfg: ModelConfig, q_block: int, kv_block: int,
              remat: bool, device: torch.device) -> ModelAPI:
    """The decoder-only API. Each function runs the mesh program
    (`models.lm`) on the layout of its parameters: placed on a mesh
    (`distributed.partitioning.shard`), or on one device. Batch arrays are
    cut into the batch groups' rows (a placed batch: each group's block);
    logits come back as one logical tensor on the mesh's first device."""
    is_vlm = cfg.family == "vlm"
    dtype = _compute_dtype(cfg)

    def init(key):
        return lm.init_params(_generator(key, device), cfg,
                              max_positions=_MAX_LEARNED_POS
                              if cfg.learned_pos else 0)

    def _embed_inputs(params, batch):
        lay = lm.program_layout(cfg, params)
        x = embedding.mesh_embed(lay, cfg, params["embedding"],
                                 _rows(lay, batch["tokens"]), dtype=dtype)
        prefix_len = 0
        if is_vlm:
            patches = [p.to(dtype) for p in _rows(lay, batch["patches"])]
            x = [torch.cat([p, xx], dim=1) for p, xx in zip(patches, x)]
            prefix_len = patches[0].shape[1]
        return lay, x, prefix_len

    def loss(params, batch):
        lay, x, prefix_len = _embed_inputs(params, batch)
        h, aux = lm.forward(cfg, params, x, prefix_len=prefix_len,
                            q_block=q_block, kv_block=kv_block, remat=remat)
        if is_vlm:
            h = [hh[:, prefix_len:] for hh in h]
        parts, split = embedding.mesh_logits(lay, cfg, params["embedding"],
                                             h)
        ce = _mesh_cross_entropy(lay, parts, _rows(lay, batch["labels"]),
                                 split)
        aux_w = cfg.moe.router_aux_loss if cfg.moe is not None else 0.0
        total = ce + aux_w * aux
        return total, {"ce": ce, "aux": aux}

    def prefill_fn(params, batch, *, max_len: int):
        lay, x, prefix_len = _embed_inputs(params, batch)
        h, cache = lm.prefill(cfg, params, x, max_len=max_len,
                              prefix_len=prefix_len, q_block=q_block,
                              kv_block=kv_block)
        parts, split = embedding.mesh_logits(lay, cfg, params["embedding"],
                                             [hh[:, -1:] for hh in h])
        return embedding.mesh_unshard_logits(lay, parts, split), cache

    def decode(params, cache, tokens, *, donate: bool = False):
        """``donate``: update ``cache`` in place (it is the returned
        cache); otherwise ``cache`` is left as it was."""
        lay = lm.program_layout(cfg, params)
        pos = cache["pos"]
        x = embedding.mesh_embed(lay, cfg, params["embedding"],
                                 _rows(lay, tokens),
                                 positions=torch.tensor([pos]), dtype=dtype)
        h, cache = lm.decode_step(cfg, params, cache, x, donate=donate)
        parts, split = embedding.mesh_logits(lay, cfg, params["embedding"],
                                             h)
        return embedding.mesh_unshard_logits(lay, parts, split), cache

    def init_cache(batch, max_len):
        return lm.init_cache(cfg, batch, max_len, device=device)

    return ModelAPI(cfg=cfg, init=init, loss=loss, prefill=prefill_fn,
                    decode=decode, init_cache=init_cache)


def _mesh_cross_entropy(lay, parts: list, labels: list, split: bool
                        ) -> torch.Tensor:
    """`cross_entropy` of the mesh's logits, the mean over the global
    label count. ``split``: the parts are the model shards' vocabulary
    slices (`embedding.mesh_logits`): the max and the sum of exponentials
    fold over the model axis, and the gold logit comes from the shard
    that holds it. The groups' terms fold in group order."""
    if not split:
        terms = [_ce_terms(p, lab) for p, lab in zip(parts, labels)]
    else:
        from repro_torch.models.sharding_hints import hint_logits
        m = lay.n_model
        n = parts[0].shape[-1]
        lf = [hint_logits(p.to(torch.float32)) for p in parts]
        mx = spmd.max_over_model(lay, [torch.amax(x, dim=-1) for x in lf])
        se = spmd.model_sum(lay, [
            torch.sum(torch.exp(x - mx[i // m].to(x.device)[..., None]),
                      dim=-1) for i, x in enumerate(lf)])
        gold_parts = []
        for i, x in enumerate(lf):
            local = labels[i // m].to(x.device).long() - (i % m) * n
            own = (local >= 0) & (local < n)
            pick = torch.take_along_dim(
                x, torch.clamp(local, 0, n - 1)[..., None], dim=-1)[..., 0]
            gold_parts.append(torch.where(own, pick, torch.zeros_like(pick)))
        gold = spmd.model_sum(lay, gold_parts)
        terms = []
        for g in range(lay.n_groups):
            lab = labels[g].to(se[g].device).long()
            nll = torch.log(se[g]) + mx[g] - gold[g]
            mask = (lab >= 0).to(torch.float32)
            terms.append((torch.sum(nll * mask), torch.sum(mask)))
    total = spmd.batch_fold(lay, [t for t, _ in terms])
    count = spmd.batch_fold(lay, [c for _, c in terms])
    return total / torch.clamp_min(count, 1.0)


# ---------------------------------------------------------------------------
# enc-dec (whisper)
# ---------------------------------------------------------------------------

def _build_encdec(cfg: ModelConfig, q_block: int, kv_block: int,
                  remat: bool, device: torch.device) -> ModelAPI:
    """The encoder-decoder API, the mesh program of `_build_lm` on
    `models.encdec`: the frames and tokens cut into the batch groups'
    rows, logits and the loss as there."""
    dtype = _compute_dtype(cfg)

    def init(key):
        return encdec.init_params(_generator(key, device), cfg,
                                  max_positions=_MAX_LEARNED_POS)

    def loss(params, batch):
        lay = lm.program_layout(cfg, params)
        enc_out = encdec.encode(cfg, params, _rows(lay, batch["frames"]),
                                remat=remat)
        h = encdec.decode_full(cfg, params, _rows(lay, batch["tokens"]),
                               enc_out, q_block=q_block, kv_block=kv_block,
                               remat=remat)
        parts, split = embedding.mesh_logits(lay, cfg, params["embedding"],
                                             h)
        ce = _mesh_cross_entropy(lay, parts, _rows(lay, batch["labels"]),
                                 split)
        return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                                 device=ce.device)}

    def prefill_fn(params, batch, *, max_len: int):
        lay = lm.program_layout(cfg, params)
        h, cache = encdec.prefill(cfg, params, _rows(lay, batch["frames"]),
                                  _rows(lay, batch["tokens"]),
                                  max_len=max_len, q_block=q_block,
                                  kv_block=kv_block)
        parts, split = embedding.mesh_logits(lay, cfg, params["embedding"],
                                             [hh[:, -1:] for hh in h])
        return embedding.mesh_unshard_logits(lay, parts, split), cache

    def decode(params, cache, tokens, *, donate: bool = False):
        """``donate``: update ``cache`` in place (it is the returned
        cache); otherwise ``cache`` is left as it was."""
        lay = lm.program_layout(cfg, params)
        pos = cache["pos"]
        x = embedding.mesh_embed(lay, cfg, params["embedding"],
                                 _rows(lay, tokens),
                                 positions=torch.tensor([pos]), dtype=dtype)
        h, cache = encdec.decode_step(cfg, params, cache, x, donate=donate)
        parts, split = embedding.mesh_logits(lay, cfg, params["embedding"],
                                             h)
        return embedding.mesh_unshard_logits(lay, parts, split), cache

    def init_cache(batch, max_len):
        return encdec.init_cache(cfg, batch, max_len, device=device)

    return ModelAPI(cfg=cfg, init=init, loss=loss, prefill=prefill_fn,
                    decode=decode, init_cache=init_cache)
