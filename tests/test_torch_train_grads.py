"""The port's backward pass against live JAX, on the CPU: the attention /
MoE decoders (this file) and the other mixers
(`test_torch_train_grads_mixers.py`), every LM config between them.

For each smoke config (deepseek-moe-16b with both routers, the Sinkhorn
one through `core.ot`'s fixed iterations) in float32 compute, the
reference's weights reach the port through
`convert.lm_params_from_numpy`; one `TokenPipeline` batch (B 2, S 32)
goes through ``jax.jit(jax.value_and_grad(model.loss))`` and the port's
``model.loss`` and `torch.autograd`. The leaves' paths (spelled as
``jax.tree_util.keystr``) are the same, the losses agree to float32
rtol 1e-6 and every gradient lies within 1e-5 of the reference's,
relative to the leaf's largest |gradient|.
The model runs with remat on, as both packages' defaults.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch  # noqa: F401  (precision pins)
from repro.configs import get_smoke_config as ref_get_smoke
from repro.configs import registry as ref_registry
from repro.data.tokens import TokenPipeline as RefTokenPipeline
from repro.models import build_model as ref_build_model
from repro_torch import _tree
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import build_model

GRAD_REL = 1e-5
CASES = [("deepseek-moe-16b", None), ("deepseek-moe-16b", "sinkhorn"),
         ("mixtral-8x22b", None), ("olmo-1b", None), ("gemma-2b", None),
         ("starcoder2-3b", None), ("paligemma-3b", None)]


def _cfg(cfg, router):
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    if router is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, router=router))
    return cfg


def check_gradients(arch, router=None, *, loss_rtol=1e-6,
                    grad_rel=GRAD_REL):
    """Loss and per-leaf gradients of one smoke config against live JAX."""
    rcfg = _cfg(ref_get_smoke(arch), router)
    tcfg = _cfg(get_smoke_config(arch), router)
    rm = ref_build_model(rcfg, q_block=16, kv_block=16)
    params = rm.init(jax.random.PRNGKey(0))
    batch = RefTokenPipeline(rcfg, batch=2, seq_len=32).batch_at(0)
    (rloss, _), rgrads = jax.jit(jax.value_and_grad(rm.loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})

    tm = build_model(tcfg, q_block=16, kv_block=16, device="cpu")
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, params),
                              device="cpu")
    leaves = [p.requires_grad_(True) for p in _tree.leaves(tp)]
    tloss, _ = tm.loss(tp, batch)
    tgrads = torch.autograd.grad(tloss, leaves)

    np.testing.assert_allclose(float(tloss.detach()), float(rloss),
                               rtol=loss_rtol)
    ref_flat = jax.tree_util.tree_flatten_with_path(rgrads)[0]
    assert [jax.tree_util.keystr(p) for p, _ in ref_flat] == \
        [_tree.keystr(p) for p, _ in _tree.flatten_with_path(tp)]
    for (path, r), t in zip(ref_flat, tgrads, strict=True):
        r = np.asarray(r)
        assert t.shape == r.shape and t.dtype == torch.float32
        assert torch.isfinite(t).all()
        err = np.abs(t.numpy() - r).max() / max(np.abs(r).max(), 1e-30)
        assert err <= grad_rel, (jax.tree_util.keystr(path), err)


def test_every_config_is_covered():
    from test_torch_train_grads_mixers import CASES as MIXER_CASES
    assert sorted({a for a, _ in CASES + MIXER_CASES}) == \
        sorted(ref_registry.arch_ids())


@pytest.mark.parametrize("arch,router", CASES,
                         ids=[f"{a}-{r or 'default'}" for a, r in CASES])
def test_float32_gradients_match_reference(arch, router):
    check_gradients(arch, router)
