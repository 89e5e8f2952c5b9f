"""The port's train step (`repro_torch.train.build_train_step`) against the
reference's jitted step on a 1-device mesh, on the CPU.

deepseek-moe-16b's smoke config in float32 compute (MoE dispatch, the
router's load-balance loss, the dense first layer, stacked units under
remat), one initial state made by the reference and carried over by
`convert.train_state_from_numpy`, three steps of `TokenPipeline` batches
(B 4, S 32) with microbatches 1 and 2 and compression off and on. Held:
the metrics' names; the loss and grad_norm of every step at rtol 1e-5;
the parameters' movement over the three steps
by the update criterion ||dp_port - dp_ref|| / ||dp_ref|| per leaf --
Adam's first steps move an element by about +-lr, so an element whose
gradient sits at rounding level may flip between two correct runs; so a
norm, not elementwise: 1e-3 without compression, 1e-2 with it (an int8
code at a rounding edge moves a whole quantization step).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch  # noqa: F401  (precision pins)
from repro.configs import get_smoke_config as ref_get_smoke
from repro.data.tokens import TokenPipeline as RefTokenPipeline
from repro.launch.mesh import make_mesh as ref_make_mesh
from repro.models import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro.train import step as ref_step
from repro_torch import _tree
from repro_torch.configs import get_smoke_config
from repro_torch.convert import train_state_from_numpy
from repro_torch.launch.mesh import one_device_mesh
from repro_torch.models import build_model
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.train import TrainState, build_train_step

ARCH = "deepseek-moe-16b"


def _update_rel(p0, ref_params, port_params):
    worst = 0.0
    for a, r, t in zip(p0, jax.tree.leaves(ref_params),
                       _tree.leaves(port_params), strict=True):
        dr = np.asarray(r, np.float64) - a
        dt = t.numpy().astype(np.float64) - a
        worst = max(worst, np.linalg.norm(dt - dr)
                    / max(np.linalg.norm(dr), 1e-30))
    return worst


@pytest.mark.parametrize("microbatches,compression",
                         [(1, False), (1, True), (2, False), (2, True)])
def test_train_step_follows_reference(microbatches, compression):
    rcfg, tcfg = (dataclasses.replace(c, compute_dtype="float32")
                  for c in (ref_get_smoke(ARCH), get_smoke_config(ARCH)))
    rm = ref_build_model(rcfg, q_block=16, kv_block=16)
    tm = build_model(tcfg, q_block=16, kv_block=16, device="cpu")
    ropt = ref_adamw(ref_warmup_cosine(3e-3, warmup_steps=1,
                                       total_steps=10))
    topt = adamw(warmup_cosine(3e-3, warmup_steps=1, total_steps=10))
    mesh = ref_make_mesh((1, 1), ("data", "model"))
    pipe = RefTokenPipeline(rcfg, batch=4, seq_len=32)

    rs = ref_step.init_state(rm, ropt, jax.random.PRNGKey(0),
                             grad_compression=compression)
    ts = train_state_from_numpy(jax.tree.map(np.asarray, rs), device="cpu")
    assert isinstance(ts, TrainState) and (ts.comp is None) != compression
    p0 = [np.array(x, np.float64) for x in jax.tree.leaves(rs.params)]
    rfn = ref_step.build_train_step(rm, ropt, mesh,
                                    microbatches=microbatches,
                                    grad_compression=compression,
                                    donate=False)
    tfn = build_train_step(tm, topt, one_device_mesh("cpu"),
                           microbatches=microbatches,
                           grad_compression=compression)
    for i in range(3):
        batch = pipe.batch_at(i)
        with mesh:
            rs, rmet = rfn(rs, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tmet = tfn(ts, batch)
        assert sorted(tmet) == sorted(rmet)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tmet[k]), float(rmet[k]),
                                       rtol=1e-5, err_msg=f"step {i} {k}")
        assert int(ts.opt.step) == int(rs.opt.step) == i + 1
    bound = 1e-2 if compression else 1e-3
    assert _update_rel(p0, rs.params, ts.params) <= bound
    if compression:
        for a, b in zip(_tree.leaves(ts.comp.residual),
                        jax.tree.leaves(rs.comp.residual)):
            assert torch.isfinite(a).all()
            assert a.shape == np.asarray(b).shape
