"""The port's backward pass against live JAX on the CPU, the mixers:
multi-head latent attention (minicpm3-4b), RG-LRU (recurrentgemma-9b),
xLSTM (xlstm-125m) and the encoder-decoder (whisper-small); the method
and tolerances of `test_torch_train_grads.py`.

Whisper's decoder runs in bfloat16 at any compute dtype in both packages
(the reference's `encdec.decode_full` embeds the decoder's tokens at
`embedding.embed`'s default dtype, the port's at `embedding.mesh_embed`'s),
so its float32 case lifts that default to float32 in both packages alike (a wrapper, in the test only)
and is held to the float32 bounds; the model as it is, with its bfloat16
decoder, is held to the loss at rtol 1e-4 and the gradients at 3e-2 of
each leaf's largest (bfloat16 rounding, in both packages).
"""
import functools

import jax.numpy as jnp
import pytest
import torch

from repro.models import encdec as ref_encdec
from repro_torch.models import encdec
from test_torch_train_grads import check_gradients

CASES = [("minicpm3-4b", None), ("recurrentgemma-9b", None),
         ("xlstm-125m", None), ("whisper-small", None)]


@pytest.mark.parametrize("arch", ["minicpm3-4b", "recurrentgemma-9b",
                                  "xlstm-125m"])
def test_float32_gradients_match_reference(arch):
    check_gradients(arch)


def test_whisper_float32_gradients_match_reference(monkeypatch):
    # the port's decoder embeds through `embedding.mesh_embed` (the mesh
    # program's lookup), at its default dtype
    for mod, name, f32 in ((ref_encdec, "embed", jnp.float32),
                           (encdec, "mesh_embed", torch.float32)):
        monkeypatch.setattr(mod.embedding, name, functools.partial(
            getattr(mod.embedding, name), dtype=f32))
    check_gradients("whisper-small")


def test_whisper_gradients_with_its_bfloat16_decoder():
    check_gradients("whisper-small", loss_rtol=1e-4, grad_rel=3e-2)
