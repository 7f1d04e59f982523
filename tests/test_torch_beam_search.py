"""The slices as a whole: a tiny model of each ported pair through
``init_cache``/``step``/``beam_search`` (beam 5, max length 10, length
penalty 0.8, min length 2) in the port and in the JAX package, from the
same weights and images: tokens identical and scores within 1e-4 at f32.
A vocabulary of 1000 takes the materialised log-softmax candidate path, one
of 5000 the fused path (LSE + block maxima + fused top-k).

* CLIP + GPT-2: the port's default configuration (whole-stack decode,
  encoder fold) against the JAX package's XLA decode and, on the same
  switches, against its Pallas whole-stack decode and encoder kernels in
  interpret mode;
* ViT + Transformer decoder: the port's fold (default) and split
  configurations against the JAX package's XLA decode;
* ResNet + LSTM with soft attention through the kernel switch (the served
  configuration) and multi-head attention, against the JAX package with
  its Pallas kernels in interpret mode, with the output layer scaled so
  that the logits are peaked (the seeded tiny LSTM's are almost flat,
  which leaves its beams in near-ties);
* the JAX package's default configuration (ViT-B/16 + GPT-2 with 8 heads
  of 96, at its widths, one layer each, 32x32 images)."""

import functools

import jax
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.config import get_default_config
from image_captioning_ml_project_tpu.inference.decoding import (
    beam_search as jax_beam_search)
from image_captioning_ml_project_tpu.models.captioning_model import (
    ImageCaptioningModel)
from image_captioning_ml_project_tpu_torch.inference.decoding import (
    _gather_state, _tile_state, beam_search)
from image_captioning_ml_project_tpu_torch.models.captioning_model import (
    load_model)
from image_captioning_ml_project_tpu_torch.utils import profiling
from torch_port_helpers import (IMAGE_SIZE, both_models, images_uint8,
                                jax_images)

torch.set_num_threads(1)

B = 3


@functools.lru_cache(maxsize=None)
def _jax_decoder(vocab, hf_compat, decode_kernel="xla", **family):
    cfg, model = both_models(0, vocab=vocab, decode_kernel=decode_kernel,
                             **family)[:2]
    return _jitted_decode(cfg, model, hf_compat)


def _jitted_decode(cfg, model, hf_compat=True):
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


@pytest.mark.parametrize("recorder", [False, True],
                         ids=["recorder_off", "recorder_on"])
def test_beam_search_records_a_step_and_a_sync_a_step(recorder):
    """Tokens identical to the JAX package's with the span recorder on
    and off; on, one ``decode.step`` and one ``decode.stop_check`` under
    it per step run, and under each check a ``decode.host_syncs`` record;
    off, no record."""
    cfg, _, variables, port = both_models(1, vocab=5000)
    images = images_uint8(11, n=B)
    want = _jax_decoder(5000, True)(variables, jax_images(images))
    steps = 0

    def step_fn(state, tokens):
        nonlocal steps
        steps += 1
        return port.step(state, tokens)

    mc, ic = cfg.model, cfg.inference
    profiling.records()
    if recorder:
        profiling.enable()
    try:
        with torch.inference_mode():
            state = port.init_cache(torch.from_numpy(images), ic.max_length)
            got = beam_search(step_fn, state, B, ic.beam_size,
                              mc.bos_token_id, mc.eos_token_id,
                              mc.pad_token_id, ic.max_length,
                              length_penalty=ic.length_penalty,
                              min_length=ic.min_length, return_all=True)
    finally:
        profiling.disable()
    recs = profiling.records()
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    assert steps > 0
    if not recorder:
        assert recs == []
        return
    step_ids = {r.id for r in recs if r.name == "decode.step"}
    checks = [r for r in recs if r.name == "decode.stop_check"]
    syncs = [r for r in recs if r.name == "decode.host_syncs"]
    assert len(step_ids) == len(checks) == steps
    assert {r.parent for r in checks} == step_ids
    assert sum(r.attrs["n"] for r in syncs) == steps
    assert {r.parent for r in syncs} == {r.id for r in checks}


def test_beam_search_without_hf_rules_matches_jax():
    cfg, _, variables, port = both_models(0, vocab=1000)
    images = images_uint8(20, n=B)
    want = _jax_decoder(1000, False)(variables, jax_images(images))
    got = _port_decode(cfg, port, images, False)
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beam_search_on_default_configuration_matches_jax(seed, monkeypatch):
    """The default configuration in both packages: whole-stack decode and
    encoder fold (JAX's Pallas kernels in interpret mode, the encoder
    forced on as its CPU tests do; the port's plain versions)."""
    for name in ("ICT_DECODE_STACK", "ICT_DECODE_FOLD"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("ICT_ENCODER_FOLD", "force")
    cfg, _, variables, port = both_models(seed, vocab=5000,
                                          decode_kernel="pallas")
    images = images_uint8(seed + 30, n=B)
    want = _jax_decoder(5000, True, "pallas")(variables, jax_images(images))
    got = _port_decode(cfg, port, images, True)
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-4, rtol=0)


_VIT_TRANSFORMER = {"encoder": "vit", "decoder": "transformer"}


@pytest.mark.parametrize("vocab", [1000, 5000],
                         ids=["materialized", "fused"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transformer_beam_search_matches_jax(seed, vocab):
    """ViT + Transformer decoder, the port's default (fold)
    configuration."""
    cfg, _, variables, port = both_models(seed, vocab=vocab,
                                          **_VIT_TRANSFORMER)
    images = images_uint8(seed + 40, n=B)
    want = _jax_decoder(vocab, True, **_VIT_TRANSFORMER)(
        variables, jax_images(images))
    got = _port_decode(cfg, port, images, True)
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-4, rtol=0)


def test_transformer_split_beam_search_matches_jax(monkeypatch):
    """ViT + Transformer decoder, the split configuration
    (``ICT_DECODE_FOLD=0``)."""
    monkeypatch.setenv("ICT_DECODE_FOLD", "0")
    cfg, _, variables, port = both_models(1, vocab=5000, **_VIT_TRANSFORMER)
    images = images_uint8(50, n=B)
    want = _jax_decoder(5000, True, **_VIT_TRANSFORMER)(
        variables, jax_images(images))
    got = _port_decode(cfg, port, images, True)
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-4, rtol=0)


def test_jax_default_configuration_matches_jax():
    """The JAX package's default configuration (ViT-B/16 + GPT-2, width
    768, 8 heads of 96) at its widths with one layer each, 32x32 images
    and vocab 1000, f32: the port builds it through ``load_model`` and
    decodes the JAX package's tokens."""
    import jax.numpy as jnp

    cfg = get_default_config()
    cfg.model.encoder.num_layers = cfg.model.decoder.num_layers = 1
    cfg.image_size = cfg.model.encoder.image_size = IMAGE_SIZE
    cfg.model.vocab_size, cfg.model.dtype = 1000, "float32"
    model = ImageCaptioningModel(cfg)
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, IMAGE_SIZE, IMAGE_SIZE, 3)),
        jnp.zeros((2, 5), jnp.int32))
    port = load_model(cfg, "cpu", params=variables)
    assert port.decoder.backbone.blocks[0].attn.num_heads == 8
    images = images_uint8(60, n=2)
    want = _jitted_decode(cfg, model)(variables, jax_images(images))
    got = _port_decode(cfg, port, images, True)
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-4, rtol=0)


def _peaked(variables, factor=30.0):
    """The variables with the LSTM's output layer scaled by ``factor``."""
    tree = jax.tree_util.tree_map(np.array, variables)
    tree["params"]["decoder"]["output_layer"]["kernel"] *= factor
    return tree


@pytest.mark.parametrize("attention,heads", [("soft", 1), ("multi_head", 4)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lstm_beam_search_matches_jax(seed, attention, heads):
    """ResNet + LSTM through the kernel switch (``use_pallas``), the fused
    candidate path (vocab 5000): the port's per-image memory against the
    JAX decoder's tiled ``static`` features."""
    family = dict(encoder="resnet", decoder="lstm", attention=attention,
                  attention_heads=heads, use_pallas=True)
    cfg, model, variables, _ = both_models(seed, vocab=5000, **family)
    tree = _peaked(variables)
    port = load_model(cfg, "cpu", params=tree)
    images = images_uint8(seed + 70, n=B)
    want = _jitted_decode(cfg, model)(tree, jax_images(images))
    got = _port_decode(cfg, port, images, True)
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
