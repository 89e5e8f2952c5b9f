"""Serving steps: prefill + decode of a language model on one device.

Port of `repro.serving.serve_step`. The reference jits prefill and decode
with explicit shardings over its mesh; the port serves on one device, so
there is nothing to shard: ``mesh`` is None or the port's one-position
`launch.mesh.Mesh`, and a larger mesh raises (placing a language model
over a mesh is ROADMAP Queue 1 item 5d, the multi-device LM mesh). The steps
run where the parameters lie.
"""
from __future__ import annotations

from repro_torch.models.registry import ModelAPI
from repro_torch.models.sharding_hints import check_one_device


def build_serve_fns(model: ModelAPI, mesh, *, max_len: int):
    """(prefill_for(batch_size), decode_for(batch_size, *,
    donate_cache=True)): each returns the step for that batch size.

    ``prefill(params, batch) -> (last-position logits, cache)`` with a
    cache of ``max_len`` positions; ``decode(params, cache, tokens) ->
    (logits, cache)``. With ``donate_cache`` the decode step writes the
    new token into the given cache's buffers (as the reference donates
    them), otherwise it leaves the given cache as it was."""
    check_one_device(mesh, "build_serve_fns")

    def _check_batch(what, n, batch_size):
        if n != batch_size:
            raise ValueError(f"{what} for batch {batch_size} got {n} rows")

    def prefill_for(batch_size):
        def prefill(params, batch):
            _check_batch("prefill", len(batch["tokens"]), batch_size)
            return model.prefill(params, batch, max_len=max_len)
        return prefill

    def decode_for(batch_size, *, donate_cache: bool = True):
        def decode(params, cache, tokens):
            _check_batch("decode", len(tokens), batch_size)
            return model.decode(params, cache, tokens, donate=donate_cache)
        return decode

    return prefill_for, decode_for
