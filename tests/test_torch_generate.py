"""The decoders' greedy ``generate`` (port: models/gpt2.py,
models/decoders.py) and ``ImageCaptioningModel.generate`` (port:
models/captioning_model.py) against the JAX package's, on tiny models of
the three families from one set of weights and images, f32, three seeds
each: tokens identical; the LSTM's attention weights within 1e-5 of the
largest (sums in another order, carried through the steps).

Each is ported with what it leaves out: GPT-2's pads after EOS, the
Transformer's and the LSTM's no EOS handling at all (their tokens run on
past EOS). The LSTM's output layer is scaled so that its logits are
peaked, as in the beam-search tests; its soft attention runs through the
kernel switch (JAX's Pallas kernel in interpret mode)."""

import jax
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu_torch.models.captioning_model import (
    load_model)
from torch_port_helpers import both_models, images_uint8, jax_images

torch.set_num_threads(1)

FAMILIES = {
    "gpt2": {},
    "transformer": {"encoder": "vit", "decoder": "transformer"},
    "lstm": {"encoder": "resnet", "decoder": "lstm", "attention": "soft",
             "attention_heads": 1, "use_pallas": True},
}


def _setup(family, seed):
    cfg, model, variables, port = both_models(seed, vocab=1000,
                                              **FAMILIES[family])
    if family == "lstm":
        tree = jax.tree_util.tree_map(np.array, variables)
        tree["params"]["decoder"]["output_layer"]["kernel"] *= 30.0
        variables = tree
        port = load_model(cfg, "cpu", params=variables)
    return cfg, model, variables, port


def _check_extras(family, got, want):
    if family == "lstm":
        w = np.asarray(want["attention_weights"])
        g = got["attention_weights"].numpy()
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-5 * np.abs(w).max(), rtol=0)
    else:
        assert got == {} and want == {}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_decoder_generate_matches_jax(family, seed):
    """``decoder.generate`` on the encoder's features, each package's
    features from its own encoder."""
    cfg, model, variables, port = _setup(family, seed)
    images = images_uint8(seed + 500, n=3)
    L = 9

    def jax_generate(mdl, images):
        return mdl.decoder.generate(mdl.encode(images), L)

    want_tok, want_x = jax.jit(lambda v, im: model.apply(
        v, im, method=jax_generate))(variables, jax_images(images))
    with torch.inference_mode():
        got_tok, got_x = port.decoder.generate(
            port.encode(torch.from_numpy(images)), L)
    assert got_tok.shape == (3, L)
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    _check_extras(family, got_x, want_x)
    assert (got_tok[:, 0] == cfg.model.bos_token_id).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_model_generate_matches_jax(family, seed):
    """``ImageCaptioningModel.generate`` with its default length, the
    config's ``inference.max_length``."""
    cfg, model, variables, port = _setup(family, seed)
    images = images_uint8(seed + 600, n=2)
    want_tok, want_x = jax.jit(lambda v, im: model.apply(
        v, im, method=model.generate))(variables, jax_images(images))
    with torch.inference_mode():
        got_tok, got_x = port.generate(torch.from_numpy(images))
    assert got_tok.shape == (2, cfg.inference.max_length)
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    _check_extras(family, got_x, want_x)


def test_gpt2_generate_pads_after_eos():
    """GPT-2's ``generate`` emits pads after a row's first EOS (the EOS
    embedding, tied to the LM head, lifted so that rows end early)."""
    cfg, _, variables, _ = _setup("gpt2", 0)
    tree = jax.tree_util.tree_map(np.array, variables)
    wte = tree["params"]["decoder"]["backbone"]["wte"]["embedding"]
    wte[cfg.model.eos_token_id] *= 200.0
    port = load_model(cfg, "cpu", params=tree)
    with torch.inference_mode():
        tokens, _ = port.generate(torch.from_numpy(images_uint8(7, n=2)), 6)
    mc = cfg.model
    ended = 0
    for row in tokens.tolist():
        if mc.eos_token_id in row[1:]:
            first = row.index(mc.eos_token_id, 1)
            assert set(row[first + 1:]) <= {mc.pad_token_id}
            ended += first < len(row) - 1
    assert ended >= 1
