"""GPT-2 decoder (port: models/gpt2.py) against the JAX package on the same
weights: teacher-forced logits, and ``init_cache`` plus four ``step``s
under a non-trivial beam ancestry, against both JAX step paths (XLA, and
the Pallas decode kernel in interpret mode with the stack and QKV folds
off), to atol 1e-4 at f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.inference.decoding import (
    _tile_state as jax_tile_state)
from image_captioning_ml_project_tpu_torch.inference.decoding import (
    _tile_state)
from torch_port_helpers import both_models, images_uint8, jax_images

torch.set_num_threads(1)

B, K, L = 2, 3, 8


def test_teacher_forced_logits_match_jax():
    cfg, model, variables, port = both_models(1)
    imgs = images_uint8(2)
    caps = np.random.RandomState(3).randint(3, 1000, (B, 7))
    caps[0, 5:] = cfg.model.pad_token_id  # caption pads are masked keys
    want = jax.jit(model.apply)(variables, jax_images(imgs),
                                jnp.asarray(caps))
    with torch.inference_mode():
        got = port(torch.from_numpy(imgs), torch.from_numpy(caps))
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=1e-4, rtol=0)


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_init_cache_and_steps_under_ancestry_match_jax(kernel, monkeypatch):
    monkeypatch.setenv("ICT_DECODE_STACK", "0")
    monkeypatch.setenv("ICT_DECODE_FOLD", "0")
    _, model, variables, port = both_models(2, decode_kernel=kernel)
    imgs = images_uint8(4)
    rs = np.random.RandomState(5)
    # global beam rows of each slot's own image, as beam search keeps them
    anc = (np.arange(B * K)[:, None] // K * K
           + rs.randint(0, K, (B * K, L))).astype(np.int32)
    tokens = rs.randint(3, 1000, (4, B * K))

    jstate = model.apply(variables, jax_images(imgs), L,
                         method=model.init_cache)
    jstate = jax_tile_state(jstate, K)
    jstate = dict(jstate, lazy=dict(jstate["lazy"],
                                    ancestry=jnp.asarray(anc)))
    step = jax.jit(lambda s, t: model.apply(variables, s, t,
                                            method=model.step))
    with torch.inference_mode():
        tstate = _tile_state(port.init_cache(torch.from_numpy(imgs), L), K)
        tstate["lazy"]["ancestry"] = torch.from_numpy(anc)
        for toks in tokens:
            want, jstate = step(jstate, jnp.asarray(toks))
            got, tstate = port.step(tstate, torch.from_numpy(toks))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-4, rtol=0)
    assert tstate["pos"] == int(jstate["pos"]) == 4
    for jl, tl, jp, tp in zip(jstate["lazy"]["layers"],
                              tstate["lazy"]["layers"],
                              jstate["shared"]["layers"],
                              tstate["shared"]["layers"]):
        for key in ("k", "v"):
            np.testing.assert_allclose(tl[key].numpy(),
                                       np.asarray(jl[key])[:, :L],
                                       atol=1e-5, rtol=0)
        for key in ("pk", "pv"):
            np.testing.assert_allclose(tp[key].numpy(), np.asarray(jp[key]),
                                       atol=1e-5, rtol=0)


def test_suffix_cache_holds_exactly_max_length_positions():
    port = both_models(1)[3]
    with torch.inference_mode():
        state = port.init_cache(torch.from_numpy(images_uint8(0)), 11)
    assert state["pos"] == 0
    assert state["lazy"]["layers"][0]["k"].shape == (B, 11, 64)
    assert state["shared"]["layers"][0]["pk"].shape == (B, 3, 64)
