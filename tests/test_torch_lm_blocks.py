"""`repro_torch.models.lm.apply_block_full`, `apply_block_decode` and
`apply_block_prefill` against live JAX's, on the CPU, in float32, for
every block kind: attention (olmo-1b), an MoE layer (deepseek-moe-16b),
multi-head latent attention (minicpm3-4b), the RG-LRU (recurrentgemma-9b),
the mLSTM and the sLSTM (xlstm-125m), each on its smoke config.

The reference's block parameters (its own ``init_block``) reach the port
as tensors; the inputs come from a fixed numpy seed. The full block and
the prefill run on T tokens (the prefill fills a cache of T + 1), and a
decode step of token T + 1 reads that cache. Held at
the mesh tests' float32 tolerance, rtol 1e-4 / atol 1e-5.
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch  # noqa: F401  (precision pins)
from repro.configs import get_smoke_config as ref_get_smoke
from repro.models import lm as ref_lm
from repro_torch.configs import get_smoke_config
from repro_torch.models import lm

F32 = dict(rtol=1e-4, atol=1e-5)
B, T = 2, 4

# (arch, block kind, layer index): one of each kind
BLOCKS = {"attention": ("olmo-1b", "attn", 0),
          "moe": ("deepseek-moe-16b", "attn", 1),
          "mla": ("minicpm3-4b", "attn", 0),
          "rglru": ("recurrentgemma-9b", "rglru", 0),
          "mlstm": ("xlstm-125m", "mlstm", 0),
          "slstm": ("xlstm-125m", "slstm", 1)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _leaves(tree):
    """The array leaves of a cache entry (NamedTuple / dict), in order;
    positions (ints or scalars) as ints."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _setup(which):
    arch, kind, layer = BLOCKS[which]
    rcfg = dataclasses.replace(ref_get_smoke(arch), compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch),
                               compute_dtype="float32")
    assert tcfg.layer_kinds()[layer] == kind
    rp = ref_lm.init_block(jax.random.PRNGKey(3), rcfg, kind, layer)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), rp)
    x = np.random.default_rng(7).normal(
        size=(B, T + 1, tcfg.d_model)).astype(np.float32)
    return rcfg, tcfg, kind, layer, rp, tp, x


def test_the_block_functions_take_the_reference_parameters():
    for name in ("apply_block_full", "apply_block_decode",
                 "apply_block_prefill"):
        ref = inspect.signature(getattr(ref_lm, name)).parameters
        mine = inspect.signature(getattr(lm, name)).parameters
        assert list(mine) == list(ref), name
        assert [p.kind for p in mine.values()] == \
            [p.kind for p in ref.values()], name


@pytest.mark.parametrize("which", sorted(BLOCKS))
def test_block_full_prefill_and_decode_match_live_jax(which):
    rcfg, tcfg, kind, layer, rp, tp, x = _setup(which)
    kw = dict(layer_idx=layer, q_block=4, kv_block=4)
    # full sequence
    xs, xt = x[:, :T], x[:, T:]
    rx, raux = ref_lm.apply_block_full(rcfg, kind, rp, jnp.asarray(xs), **kw)
    with torch.no_grad():
        tx, taux = lm.apply_block_full(tcfg, kind, tp, torch.from_numpy(xs),
                                       **kw)
    np.testing.assert_allclose(_np(tx), _np(rx), **F32)
    np.testing.assert_allclose(_np(taux), _np(raux), **F32)
    # prefill of the T tokens (a float32 cache), then one decode step
    pkw = dict(kw, max_len=T + 1, cache_dtype=jnp.float32)
    rpx, rpaux, rcache = ref_lm.apply_block_prefill(
        rcfg, kind, rp, jnp.asarray(xs), **pkw)
    with torch.no_grad():
        tpx, tpaux, tcache = lm.apply_block_prefill(
            tcfg, kind, tp, torch.from_numpy(xs),
            **dict(pkw, cache_dtype=torch.float32))
    np.testing.assert_allclose(_np(tpx), _np(rpx), **F32)
    np.testing.assert_allclose(_np(tpaux), _np(rpaux), **F32)
    got, want = _leaves(tcache), _leaves(rcache)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, int):
            assert g == int(w)
        else:
            np.testing.assert_allclose(_np(g), _np(w), **F32)
    rdx, rdc = ref_lm.apply_block_decode(rcfg, kind, rp,
                                         jnp.asarray(xt), rcache,
                                         layer_idx=layer)
    with torch.no_grad():
        tdx, tdc = lm.apply_block_decode(tcfg, kind, tp,
                                         torch.from_numpy(xt),
                                         tcache, layer_idx=layer)
    np.testing.assert_allclose(_np(tdx), _np(rdx), **F32)
    for g, w in zip(_leaves(tdc), _leaves(rdc)):
        if isinstance(g, int):
            assert g == int(w)
        else:
            np.testing.assert_allclose(_np(g), _np(w), **F32)
