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
    from repro_torch.models.sharding_hints import hint_logits
    logits = hint_logits(logits.to(torch.float32))
    labels = labels.to(logits.device).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(
        logits, torch.clamp_min(labels, 0)[..., None], dim=-1)[..., 0]
    nll = logz - gold
    mask = (labels >= 0).to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


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


def _on(params, x):
    """A batch array (numpy or torch) on the parameters' device."""
    dev = params["embedding"]["embed"].device
    return torch.as_tensor(x).to(dev)


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
    is_vlm = cfg.family == "vlm"
    dtype = _compute_dtype(cfg)

    def init(key):
        return lm.init_params(_generator(key, device), cfg,
                              max_positions=_MAX_LEARNED_POS
                              if cfg.learned_pos else 0)

    def _embed_inputs(params, batch):
        x = embedding.embed(cfg, params["embedding"],
                            _on(params, batch["tokens"]), dtype=dtype)
        prefix_len = 0
        if is_vlm:
            patches = _on(params, batch["patches"]).to(dtype)
            x = torch.cat([patches, x], dim=1)
            prefix_len = patches.shape[1]
        return x, prefix_len

    def loss(params, batch):
        x, prefix_len = _embed_inputs(params, batch)
        h, aux = lm.forward(cfg, params, x, prefix_len=prefix_len,
                            q_block=q_block, kv_block=kv_block, remat=remat)
        if is_vlm:
            h = h[:, prefix_len:]
        logits = embedding.logits(cfg, params["embedding"], h)
        ce = cross_entropy(logits, _on(params, batch["labels"]))
        aux_w = cfg.moe.router_aux_loss if cfg.moe is not None else 0.0
        total = ce + aux_w * aux
        return total, {"ce": ce, "aux": aux}

    def prefill_fn(params, batch, *, max_len: int):
        x, prefix_len = _embed_inputs(params, batch)
        h, cache = lm.prefill(cfg, params, x, max_len=max_len,
                              prefix_len=prefix_len, q_block=q_block,
                              kv_block=kv_block)
        logits = embedding.logits(cfg, params["embedding"], h[:, -1:])
        return logits, cache

    def decode(params, cache, tokens, *, donate: bool = False):
        """``donate``: update ``cache`` in place (it is the returned
        cache); otherwise ``cache`` is left as it was."""
        pos = cache["pos"]
        x = embedding.embed(cfg, params["embedding"], _on(params, tokens),
                            positions=torch.tensor([pos]), dtype=dtype)
        h, cache = lm.decode_step(cfg, params, cache, x, donate=donate)
        logits = embedding.logits(cfg, params["embedding"], h)
        return logits, cache

    def init_cache(batch, max_len):
        return lm.init_cache(cfg, batch, max_len, device=device)

    return ModelAPI(cfg=cfg, init=init, loss=loss, prefill=prefill_fn,
                    decode=decode, init_cache=init_cache)


# ---------------------------------------------------------------------------
# enc-dec (whisper)
# ---------------------------------------------------------------------------

def _build_encdec(cfg: ModelConfig, q_block: int, kv_block: int,
                  remat: bool, device: torch.device) -> ModelAPI:
    dtype = _compute_dtype(cfg)

    def init(key):
        return encdec.init_params(_generator(key, device), cfg,
                                  max_positions=_MAX_LEARNED_POS)

    def loss(params, batch):
        enc_out = encdec.encode(cfg, params, _on(params, batch["frames"]),
                                remat=remat)
        h = encdec.decode_full(cfg, params, _on(params, batch["tokens"]),
                               enc_out, q_block=q_block, kv_block=kv_block,
                               remat=remat)
        logits = embedding.logits(cfg, params["embedding"], h)
        ce = cross_entropy(logits, _on(params, batch["labels"]))
        return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                                 device=ce.device)}

    def prefill_fn(params, batch, *, max_len: int):
        h, cache = encdec.prefill(cfg, params, _on(params, batch["frames"]),
                                  _on(params, batch["tokens"]),
                                  max_len=max_len, q_block=q_block,
                                  kv_block=kv_block)
        logits = embedding.logits(cfg, params["embedding"], h[:, -1:])
        return logits, cache

    def decode(params, cache, tokens, *, donate: bool = False):
        """``donate``: update ``cache`` in place (it is the returned
        cache); otherwise ``cache`` is left as it was."""
        pos = cache["pos"]
        x = embedding.embed(cfg, params["embedding"], _on(params, tokens),
                            positions=torch.tensor([pos]), dtype=dtype)
        h, cache = encdec.decode_step(cfg, params, cache, x, donate=donate)
        logits = embedding.logits(cfg, params["embedding"], h)
        return logits, cache

    def init_cache(batch, max_len):
        return encdec.init_cache(cfg, batch, max_len, device=device)

    return ModelAPI(cfg=cfg, init=init, loss=loss, prefill=prefill_fn,
                    decode=decode, init_cache=init_cache)
