"""LSTM decoder (port: models/decoders.py ``LSTMDecoder``, models/lstm.py)
against the JAX package's, on a tiny ResNet + LSTM model from one set of
weights, with inputs made with numpy from a seed: the teacher-forced
logits, attention weights and hidden states, and ``init_cache`` followed
by five ``step`` calls, for the soft and the multi-head variants with the
kernel switch ``use_pallas`` off and on (JAX's Pallas kernels in interpret
mode, the port's plain versions). Then the bf16 decode state: the port's
soft context, and so the LSTM carry, keep the model's dtype.

Tolerance: float32 1e-5 of the largest magnitude (sums in another order,
carried through the steps)."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu_torch.inference.decoding import (
    beam_search)
from image_captioning_ml_project_tpu_torch.models.captioning_model import (
    load_model)
from image_captioning_ml_project_tpu_torch.models.lstm import StackedLSTM
from torch_port_helpers import both_models, images_uint8, jax_images

torch.set_num_threads(1)

_VARIANTS = [("soft", 1, False), ("soft", 1, True), ("multi_head", 4, False),
             ("multi_head", 4, True)]
_IDS = ["soft-xla", "soft-kernel", "multi_head-xla", "multi_head-kernel"]


def _models(attention, heads, pallas, seed=0):
    return both_models(seed, encoder="resnet", decoder="lstm",
                       attention=attention, attention_heads=heads,
                       use_pallas=pallas)


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)


@pytest.mark.parametrize("attention,heads,pallas", _VARIANTS, ids=_IDS)
def test_teacher_forced_forward_matches_jax(attention, heads, pallas):
    cfg, model, variables, port = _models(attention, heads, pallas)
    images = images_uint8(3, n=2)
    captions = np.random.RandomState(4).randint(
        0, cfg.model.vocab_size, (2, 7)).astype(np.int32)
    want = model.apply(variables, jax_images(images), jnp.asarray(captions))
    with torch.inference_mode():
        got = port(torch.from_numpy(images),
                   torch.from_numpy(captions).long())
    for key in ("logits", "attention_weights", "hidden_states"):
        _close(got[key].numpy(), want[key])


@pytest.mark.parametrize("attention,heads,pallas", _VARIANTS, ids=_IDS)
def test_init_cache_and_steps_match_jax(attention, heads, pallas):
    """Five steps on 2 images x 3 rows (the JAX state tiled over the rows,
    the port's image memory per image), feeding both the same tokens."""
    cfg, model, variables, port = _models(attention, heads, pallas)
    images = images_uint8(5, n=2)
    K = 3
    state_j = model.apply(variables, jax_images(images), 10,
                          method=model.init_cache)
    state_j = {k: (v if k == "static" else jnp.repeat(v, K, axis=0))
               for k, v in state_j.items()}
    state_j["static"] = {k: jnp.repeat(v, K, axis=0)
                         for k, v in state_j["static"].items()}
    with torch.inference_mode():
        state_p = port.init_cache(torch.from_numpy(images), 10)
        state_p = dict(state_p, **{k: state_p[k].repeat_interleave(K, 0)
                                   for k in ("h", "c", "prev_context")})
    _close(state_p["h"].numpy(), state_j["h"])
    tokens = np.random.RandomState(6).randint(
        0, cfg.model.vocab_size, (5, 2 * K))
    for t in tokens:
        logits_j, state_j = model.apply(variables, state_j, jnp.asarray(t),
                                        method=model.step)
        with torch.inference_mode():
            logits_p, state_p = port.step(state_p, torch.from_numpy(t))
        _close(logits_p.numpy(), logits_j)
        for key in ("h", "c", "prev_context"):
            _close(state_p[key].numpy(), state_j[key])


def test_stacked_lstm_gates_in_torch_order():
    """One layer against the textbook cell: gates i, f, g, o of one
    product of [x; h]."""
    lstm = StackedLSTM(3, 4, 1)
    rs = np.random.RandomState(2)
    h, c = (torch.from_numpy(rs.randn(2, 1, 4).astype(np.float32))
            for _ in range(2))
    x = torch.from_numpy(rs.randn(2, 3).astype(np.float32))
    with torch.no_grad():
        h2, c2, top = lstm(h, c, x)
    gates = lstm.cells[0].gates(torch.cat([x, h[:, 0]], -1))
    i, f, g, o = gates.detach().split(4, -1)
    c_want = torch.sigmoid(f) * c[:, 0] + torch.sigmoid(i) * torch.tanh(g)
    torch.testing.assert_close(c2[:, 0], c_want)
    torch.testing.assert_close(top, torch.sigmoid(o) * torch.tanh(c_want))
    assert torch.equal(h2[:, 0], top)


@pytest.mark.parametrize("attention,heads", [("soft", 1), ("adaptive", 1),
                                             ("multi_head", 4)])
def test_bf16_decode_keeps_the_carry_dtype(attention, heads):
    """bf16 weights, kernel path: a beam-5 decode runs, and the decode
    state's h, c and ``prev_context`` stay bf16 at every step (the JAX
    soft path's f32 context would change the carry's dtype)."""
    cfg = copy.deepcopy(_models(attention, heads, True)[0])
    cfg.model.dtype = "bfloat16"
    port = load_model(cfg, "cpu")
    seen = []

    def step(state, tokens):
        logits, state = port.step(state, tokens)
        seen.append({k: state[k].dtype for k in ("h", "c", "prev_context")})
        return logits, state

    mc, ic = cfg.model, cfg.inference
    with torch.inference_mode():
        state = port.init_cache(torch.from_numpy(images_uint8(7, n=2)),
                                ic.max_length)
        res = beam_search(step, state, 2, ic.beam_size, mc.bos_token_id,
                          mc.eos_token_id, mc.pad_token_id, ic.max_length,
                          length_penalty=ic.length_penalty,
                          min_length=ic.min_length)
    assert res.tokens.shape == (2, ic.max_length)
    assert bool(torch.isfinite(res.scores).all())
    assert seen and all(d == {"h": torch.bfloat16, "c": torch.bfloat16,
                              "prev_context": torch.bfloat16} for d in seen)


def test_context_width_must_match_the_hidden_width():
    """The LSTM input is [embedding; previous context], the context
    starting as H zeros: a soft context of another width is refused."""
    cfg = copy.deepcopy(_models("soft", 1, False)[0])
    cfg.model.encoder.feature_dim = 48
    with pytest.raises(ValueError, match="must agree"):
        load_model(cfg, "cpu")
