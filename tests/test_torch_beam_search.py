"""The slice as a whole: the tiny CLIP + GPT-2 model through
``init_cache``/``step``/``beam_search`` (beam 5, max length 10, length
penalty 0.8, min length 2) in the port and in the JAX package, from the
same weights and images: tokens identical and scores within 1e-4 at f32.
A vocabulary of 1000 takes the materialised log-softmax candidate path, one
of 5000 the fused path (LSE + block maxima + fused top-k)."""

import functools

import jax
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.inference.decoding import (
    beam_search as jax_beam_search)
from image_captioning_ml_project_tpu_torch.inference.decoding import (
    _gather_state, _tile_state, beam_search)
from torch_port_helpers import both_models, images_uint8, jax_images

torch.set_num_threads(1)

B = 3


@functools.lru_cache(maxsize=None)
def _jax_decoder(vocab, hf_compat):
    cfg, model = both_models(0, vocab=vocab)[:2]
    mc, ic = cfg.model, cfg.inference

    @jax.jit
    def run(variables, images):
        state = model.apply(variables, images, ic.max_length,
                            method=model.init_cache)
        return jax_beam_search(
            lambda s, t: model.apply(variables, s, t, method=model.step),
            state, images.shape[0], ic.beam_size, mc.bos_token_id,
            mc.eos_token_id, mc.pad_token_id, ic.max_length,
            length_penalty=ic.length_penalty, min_length=ic.min_length,
            return_all=True, hf_compat=hf_compat)

    return run


def _port_decode(cfg, port, images, hf_compat):
    mc, ic = cfg.model, cfg.inference
    with torch.inference_mode():
        state = port.init_cache(torch.from_numpy(images), ic.max_length)
        return beam_search(
            port.step, state, images.shape[0], ic.beam_size, mc.bos_token_id,
            mc.eos_token_id, mc.pad_token_id, ic.max_length,
            length_penalty=ic.length_penalty, min_length=ic.min_length,
            return_all=True, hf_compat=hf_compat)


@pytest.mark.parametrize("vocab", [1000, 5000],
                         ids=["materialized", "fused"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beam_search_matches_jax(seed, vocab):
    cfg, _, variables, port = both_models(seed, vocab=vocab)
    images = images_uint8(seed + 10, n=B)
    want = _jax_decoder(vocab, True)(variables, jax_images(images))
    got = _port_decode(cfg, port, images, True)
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-4, rtol=0)
    assert got.tokens.shape == (B, 5, cfg.inference.max_length)


def test_beam_search_without_hf_rules_matches_jax():
    cfg, _, variables, port = both_models(0, vocab=1000)
    images = images_uint8(20, n=B)
    want = _jax_decoder(1000, False)(variables, jax_images(images))
    got = _port_decode(cfg, port, images, False)
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-4, rtol=0)


def test_tile_and_gather_leave_shared_and_lazy_caches_alone():
    k = torch.arange(6.).reshape(2, 3)
    state = {"shared": {"x": k}, "lazy": {"layers": [{"k": k}]},
             "rows": k, "pos": 4}
    tiled = _tile_state(state, 2)
    assert tiled["shared"]["x"] is k and tiled["pos"] == 4
    assert torch.equal(tiled["rows"], k.repeat_interleave(2, dim=0))
    assert tiled["lazy"]["layers"][0]["k"].shape == (4, 3)
    tiled["lazy"]["ancestry"] = torch.arange(4)[:, None].repeat(1, 5)
    idx = torch.tensor([1, 1, 3, 2])
    out = _gather_state(tiled, idx)
    assert out["lazy"]["layers"] is tiled["lazy"]["layers"]
    assert torch.equal(out["lazy"]["ancestry"][:, 0], idx)
    assert torch.equal(out["rows"], tiled["rows"][idx])
