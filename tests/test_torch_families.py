"""The three families this slice adds, as a whole, against the JAX package
on the CPU at f32, from one seeded draw of weights
(``torch_port_helpers.family_models``): the Q-Former (ViT + 8 learned
queries), BUTD (detector regions, 2 to 6 of 6 valid an image) and Swin
(two stages on a grid that needs padding), each with a Transformer
decoder of width 128 (the width at which the JAX package's fused
cross-attention engages), through ``init_cache``/``step``/``beam_search``
(beam 5, max length 10): tokens identical and scores within 1e-4 on three
seeds each; the teacher-forced logits within 1e-4. And BUTD's mask: the
features and boxes of masked regions cannot change the tokens, in either
package; and the Q-Former over BUTD's masked regions (its memory mask from
the encoder's) agrees with JAX too."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.inference.decoding import (
    beam_search as jax_beam_search)
from image_captioning_ml_project_tpu_torch.inference.decoding import (
    batch_size_of, beam_search)
from torch_port_helpers import (family_inputs, family_models, jax_inputs,
                                port_inputs)

torch.set_num_threads(1)

FAMILIES = ["qformer", "butd", "swin"]
WIDTH = 128


@functools.lru_cache(maxsize=None)
def _jax_decode(family):
    cfg, model = family_models(family, width=WIDTH)[:2]
    mc, ic = cfg.model, cfg.inference

    @jax.jit
    def run(variables, inputs):
        state = model.apply(variables, inputs, ic.max_length,
                            method=model.init_cache)
        n = jax.tree_util.tree_leaves(inputs)[0].shape[0]
        return jax_beam_search(
            lambda s, t: model.apply(variables, s, t, method=model.step),
            state, n, ic.beam_size, mc.bos_token_id, mc.eos_token_id,
            mc.pad_token_id, ic.max_length,
            length_penalty=ic.length_penalty, min_length=ic.min_length)

    return run


def _port_decode(cfg, port, x):
    mc, ic = cfg.model, cfg.inference
    with torch.inference_mode():
        state = port.init_cache(x, ic.max_length)
        return beam_search(port.step, state, batch_size_of(x), ic.beam_size,
                           mc.bos_token_id, mc.eos_token_id, mc.pad_token_id,
                           ic.max_length, length_penalty=ic.length_penalty,
                           min_length=ic.min_length)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("family", FAMILIES)
def test_beam_search_matches_jax(family, seed):
    cfg, _, variables, port = family_models(family, width=WIDTH)
    x = family_inputs(cfg, seed + 50, n=3)
    want = _jax_decode(family)(variables, jax_inputs(x))
    got = _port_decode(cfg, port, port_inputs(x))
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("family", FAMILIES + ["butd_qformer"])
def test_teacher_forced_logits_match_jax(family):
    cfg, model, variables, port = family_models(family)
    x = family_inputs(cfg, 7)
    caps = np.random.RandomState(8).randint(3, cfg.model.vocab_size, (2, 6))
    want = model.apply(variables, jax_inputs(x), jnp.asarray(caps))
    with torch.no_grad():
        got = port(port_inputs(x), torch.from_numpy(caps))
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["pooled_features"].numpy(),
                               np.asarray(want["pooled_features"]),
                               atol=1e-5, rtol=1e-5)


def test_butd_masked_regions_cannot_leak():
    """The port of ``tests/test_family_kernels.py::
    test_butd_masked_regions_cannot_leak``: large noise in the features and
    boxes of the masked regions leaves both packages' tokens as they
    were, and the two equal."""
    cfg, _, variables, port = family_models("butd", width=WIDTH)
    x = family_inputs(cfg, 11, n=3)
    noisy = dict(x)
    rs = np.random.RandomState(12)
    for key in ("region_features", "region_boxes"):
        noise = (100 * rs.randn(*x[key].shape)).astype(np.float32)
        noisy[key] = np.where(x["region_mask"][..., None], x[key], noise)
    assert (~x["region_mask"]).any()
    run = _jax_decode("butd")
    want = np.asarray(run(variables, jax_inputs(x)).tokens)
    np.testing.assert_array_equal(
        np.asarray(run(variables, jax_inputs(noisy)).tokens), want)
    for inputs in (x, noisy):
        np.testing.assert_array_equal(
            _port_decode(cfg, port, port_inputs(inputs)).tokens.numpy(),
            want)
