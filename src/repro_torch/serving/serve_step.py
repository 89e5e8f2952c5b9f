"""Serving steps: prefill + decode of a language model, on one device or
a mesh.

Port of `repro.serving.serve_step`. The reference jits prefill and decode
with explicit shardings over its mesh: parameters per the partitioning
rules, caches per `cache_shardings`, tokens per the batch spec. The port
places the same way: on a mesh of more than one position the parameters
are placed by `param_shardings` (`partitioning.shard`, blocks that are
views where a position's device is the parameter's: no copy) unless they
are placed on it already, the prefill returns its cache as blocks per
`cache_shardings`, and the mesh program (`models.lm`) cuts the tokens
into the batch groups' rows; logits come back as one logical tensor on
the mesh's first device (the reference's replicated output). ``mesh``
None or one position serves where the parameters lie.
"""
from __future__ import annotations

from repro_torch.distributed import partitioning
from repro_torch.distributed.partitioning import Placed
from repro_torch.models.registry import ModelAPI


def build_serve_fns(model: ModelAPI, mesh, *, max_len: int):
    """(prefill_for(batch_size), decode_for(batch_size, *,
    donate_cache=True)): each returns the step for that batch size.

    ``prefill(params, batch) -> (last-position logits, cache)`` with a
    cache of ``max_len`` positions; ``decode(params, cache, tokens) ->
    (logits, cache)``. With ``donate_cache`` the decode step writes the
    new token into the given cache's buffers (as the reference donates
    them), otherwise it leaves the given cache as it was."""
    multi = mesh is not None and mesh.size > 1

    def _check_batch(what, n, batch_size):
        if n != batch_size:
            raise ValueError(f"{what} for batch {batch_size} got {n} rows")

    def _placed(params):
        leaf = params["embedding"]["embed"]
        if not multi or (isinstance(leaf, Placed) and leaf.mesh is mesh):
            return params
        return partitioning.shard(params,
                                  partitioning.param_shardings(mesh, params))

    def prefill_for(batch_size):
        def prefill(params, batch):
            _check_batch("prefill", len(batch["tokens"]), batch_size)
            return model.prefill(_placed(params), batch, max_len=max_len)
        return prefill

    def decode_for(batch_size, *, donate_cache: bool = True):
        def decode(params, cache, tokens):
            _check_batch("decode", len(tokens), batch_size)
            return model.decode(_placed(params), cache, tokens,
                                donate=donate_cache)
        return decode

    return prefill_for, decode_for
