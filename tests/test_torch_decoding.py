"""Greedy, nucleus and diverse-beam decoding (port: inference/decoding.py)
against the JAX package's, on tiny models of the three families from one
set of weights and images (3 images, max length 10, min length 2, f32):

* ``greedy_decode`` on both loops (the early-exit loop with an EOS, the
  fixed-length one without): tokens identical;
* ``sample_decode`` with the JAX draw's Gumbel noise stood in for the
  port's (:func:`gumbel_noise`, step ``t`` given the noise of
  ``rngs[t - 1]``): tokens and mask identical; log-probabilities within
  1e-6 absolute where both sample from the same logits (a fixed table of
  logits per token), and within 1e-5 through the models (whose f32 logits
  differ by up to about 3e-6: sums in another order);
* ``_top_p_filter`` on random f32 logits: identical (no token sat on the
  threshold in these inputs);
* diverse ``beam_search`` (K = 4 in 2 groups, K = 6 in 3) with penalty 0
  and 0.5, HF rules on and off, ``return_all``, on the materialised
  (vocab 1000) and fused (vocab 5000) candidate paths: tokens identical,
  scores within 1e-5;
* ``decode()`` for each strategy, and its ``ValueError``;
* greedy GPT-2 against HF ``generate`` on a tiny random
  ``GPT2LMHeadModel`` conditioned on the same image prefix.

The JAX package's Pallas kernels (the LSTM's attention through
``use_pallas``) run in interpret mode, as its own CPU tests run them. The
LSTM's output layer is scaled so that its logits are peaked, as in the
beam-search tests (the seeded tiny LSTM's are almost flat)."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_captioning_ml_project_tpu.inference import decoding as jax_dec
from image_captioning_ml_project_tpu_torch.inference import decoding
from image_captioning_ml_project_tpu_torch.models.captioning_model import (
    load_model)
from torch_port_helpers import both_models, images_uint8, jax_images

torch.set_num_threads(1)

B = 3
FAMILIES = {
    "gpt2": {},
    "transformer": {"encoder": "vit", "decoder": "transformer"},
    "lstm": {"encoder": "resnet", "decoder": "lstm", "attention": "soft",
             "attention_heads": 1, "use_pallas": True},
}


def _peaked(variables, factor=30.0):
    tree = jax.tree_util.tree_map(np.array, variables)
    tree["params"]["decoder"]["output_layer"]["kernel"] *= factor
    return tree


def _setup(family, seed, vocab=1000):
    """(config, flax model, variables, port model): the LSTM's with its
    output layer scaled."""
    cfg, model, variables, port = both_models(seed, vocab=vocab,
                                              **FAMILIES[family])
    if family == "lstm":
        variables = _peaked(variables)
        port = load_model(cfg, "cpu", params=variables)
    return cfg, model, variables, port


def _jax_run(model, variables, images, max_length, decode_fn):
    """``decode_fn(step_fn, state)`` on the JAX model under ``jit``."""
    @jax.jit
    def run(variables, images):
        state = model.apply(variables, images, max_length,
                            method=model.init_cache)
        return decode_fn(
            lambda s, t: model.apply(variables, s, t, method=model.step),
            state)

    return run(variables, jax_images(images))


def _port_run(port, images, max_length, decode_fn):
    with torch.inference_mode():
        state = port.init_cache(torch.from_numpy(images), max_length)
        return decode_fn(port.step, state)


@pytest.mark.parametrize("early_exit", [True, False],
                         ids=["early-exit", "fixed-length"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_greedy_matches_jax(family, seed, early_exit):
    """With an EOS and ``min_length`` on the early-exit loop; without an
    EOS (the fixed-length scan) on the other."""
    cfg, model, variables, port = _setup(family, seed)
    mc, ic = cfg.model, cfg.inference
    L = ic.max_length
    images = images_uint8(seed + 100, n=B)
    kw = (dict(eos_token_id=mc.eos_token_id, pad_token_id=mc.pad_token_id,
               min_length=ic.min_length) if early_exit else {})
    want = _jax_run(model, variables, images, L,
                    lambda f, s: jax_dec.greedy_decode(
                        f, s, B, mc.bos_token_id, L, **kw))
    got = _port_run(port, images, L,
                    lambda f, s: decoding.greedy_decode(
                        f, s, B, mc.bos_token_id, L, **kw))
    assert got.shape == (B, L)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_noise(rng, max_length, shape):
    """The Gumbel noise JAX's ``categorical`` adds at each step of
    ``sample_decode``: step ``t`` draws from ``rngs[t - 1]``."""
    rngs = jax.random.split(rng, max_length)
    return [torch.from_numpy(np.array(
        jax.random.gumbel(rngs[i], shape, jnp.float32)))
        for i in range(max_length)]


def test_gumbel_noise_is_the_jax_draw():
    """JAX's ``categorical`` is ``argmax(logits + gumbel(key))``, the draw
    the port makes with its noise; the port's noise is standard Gumbel."""
    key = jax.random.PRNGKey(3)
    logits = jnp.asarray(np.random.RandomState(0).randn(64, 100), jnp.float32)
    noise = jax.random.gumbel(key, logits.shape, jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(jax.random.categorical(key, logits)),
        np.asarray(jnp.argmax(logits + noise, axis=-1)))
    g = torch.Generator().manual_seed(0)
    x = decoding.gumbel_noise((200_000,), g, torch.device("cpu"))
    assert x.dtype == torch.float32 and torch.isfinite(x).all()
    assert abs(float(x.mean()) - 0.5772) < 0.01   # Euler-Mascheroni
    assert abs(float(x.var()) - np.pi ** 2 / 6) < 0.03


def _sample_pair(family, seed, temperature, top_p, early_exit, monkeypatch):
    cfg, model, variables, port = _setup(family, seed)
    mc, ic = cfg.model, cfg.inference
    L = ic.max_length
    images = images_uint8(seed + 200, n=B)
    rng = jax.random.PRNGKey(seed)
    ids = (mc.bos_token_id, mc.eos_token_id, mc.pad_token_id)
    kw = dict(temperature=temperature, top_p=top_p,
              min_length=ic.min_length, early_exit=early_exit)
    want = _jax_run(model, variables, images, L,
                    lambda f, s: jax_dec.sample_decode(
                        f, s, rng, B, *ids, L, **kw))
    noise = _jax_noise(rng, L, (B, mc.vocab_size))
    calls = []

    def jax_noise(shape, generator, device):
        assert tuple(shape) == (B, mc.vocab_size)
        calls.append(shape)
        return noise[len(calls) - 1].to(device)

    monkeypatch.setattr(decoding, "gumbel_noise", jax_noise)
    got = _port_run(port, images, L,
                    lambda f, s: decoding.sample_decode(
                        f, s, torch.Generator(), B, *ids, L, **kw))
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.logprobs.numpy(),
                               np.asarray(want.logprobs), atol=1e-5, rtol=0)
    assert got.mask.any()
    return got


@pytest.mark.parametrize("early_exit", [True, False],
                         ids=["early-exit", "fixed-length"])
@pytest.mark.parametrize("top_p", [1.0, 0.9])
@pytest.mark.parametrize("temperature", [0.7, 1.0])
def test_sample_decode_on_equal_logits_matches_jax(temperature, top_p,
                                                   early_exit, monkeypatch):
    """Both engines over the same logits (a fixed [V, V] table read by the
    previous token): the sampling arithmetic alone, log-probabilities
    within 1e-6."""
    V, L, Bs = 300, 12, 8
    table = (np.random.RandomState(7).randn(V, V) * 3).astype(np.float32)
    table[:, 2] += 9.0                       # EOS likely: rows finish
    table_j, table_t = jnp.asarray(table), torch.from_numpy(table)
    ids = (1, 2, 0)
    kw = dict(temperature=temperature, top_p=top_p, min_length=3,
              early_exit=early_exit)
    rng = jax.random.PRNGKey(11)
    want = jax.jit(lambda s: jax_dec.sample_decode(
        lambda st, t: (table_j[t], st), s, rng, Bs, *ids, L, **kw))(
            {"x": jnp.zeros((Bs, 1))})
    noise = _jax_noise(rng, L, (Bs, V))
    calls = []

    def jax_noise(shape, generator, device):
        calls.append(shape)
        return noise[len(calls) - 1]

    monkeypatch.setattr(decoding, "gumbel_noise", jax_noise)
    got = decoding.sample_decode(lambda st, t: (table_t[t], st),
                                 {"x": torch.zeros(Bs, 1)},
                                 torch.Generator(), Bs, *ids, L, **kw)
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.logprobs.numpy(),
                               np.asarray(want.logprobs), atol=1e-6, rtol=0)
    assert (got.tokens == ids[1]).any()      # some rows finish


@pytest.mark.parametrize("top_p", [1.0, 0.9])
@pytest.mark.parametrize("temperature", [0.7, 1.0])
def test_sample_decode_matches_jax(temperature, top_p, monkeypatch):
    _sample_pair("gpt2", 0, temperature, top_p, True, monkeypatch)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_nucleus_matches_jax_on_each_family(family, seed, monkeypatch):
    """Top-p 0.9 at temperature 0.7, each family, each seed."""
    _sample_pair(family, seed, 0.7, 0.9, True, monkeypatch)


def test_sample_decode_fixed_length_matches_jax(monkeypatch):
    """The fixed-length loop (``early_exit=False``), which keeps each
    step's input and runs ``max_length`` steps."""
    got = _sample_pair("gpt2", 1, 1.0, 0.9, False, monkeypatch)
    assert not bool(got.mask[:, 0].any())


@pytest.mark.parametrize("top_p", [0.5, 0.9, 0.99])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_top_p_filter_matches_jax(seed, top_p):
    rs = np.random.RandomState(seed)
    logits = (rs.randn(16, 1000) * rs.uniform(0.5, 4.0, (16, 1))
              ).astype(np.float32)
    want = np.asarray(jax_dec._top_p_filter(jnp.asarray(logits), top_p))
    got = decoding._top_p_filter(torch.from_numpy(logits), top_p).numpy()
    np.testing.assert_array_equal(got, want)
    kept = (got > -1e8).sum(axis=1)
    assert (kept >= 1).all() and (kept < 1000).all()


@functools.lru_cache(maxsize=None)
def _jax_diverse(family, vocab, K, G, penalty, hf_compat):
    cfg, model = both_models(0, vocab=vocab, **FAMILIES[family])[:2]
    mc, ic = cfg.model, cfg.inference

    @jax.jit
    def run(variables, images):
        state = model.apply(variables, images, ic.max_length,
                            method=model.init_cache)
        return jax_dec.beam_search(
            lambda s, t: model.apply(variables, s, t, method=model.step),
            state, images.shape[0], K, mc.bos_token_id, mc.eos_token_id,
            mc.pad_token_id, ic.max_length, length_penalty=ic.length_penalty,
            min_length=ic.min_length, num_beam_groups=G,
            diversity_penalty=penalty, return_all=True, hf_compat=hf_compat)

    return run


def _diverse_pair(family, seed, vocab, K, G, penalty, hf_compat):
    cfg, _, variables, port = _setup(family, seed, vocab=vocab)
    mc, ic = cfg.model, cfg.inference
    images = images_uint8(seed + 300, n=B)
    want = _jax_diverse(family, vocab, K, G, penalty, hf_compat)(
        variables, jax_images(images))
    got = _port_run(port, images, ic.max_length,
                    lambda f, s: decoding.beam_search(
                        f, s, B, K, mc.bos_token_id, mc.eos_token_id,
                        mc.pad_token_id, ic.max_length,
                        length_penalty=ic.length_penalty,
                        min_length=ic.min_length, num_beam_groups=G,
                        diversity_penalty=penalty, return_all=True,
                        hf_compat=hf_compat))
    assert got.tokens.shape == (B, K, ic.max_length)
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-5, rtol=0)
    return got


@pytest.mark.parametrize("hf_compat", [True, False], ids=["hf", "no-hf"])
@pytest.mark.parametrize("penalty", [0.0, 0.5])
@pytest.mark.parametrize("K,G", [(4, 2), (6, 3)])
@pytest.mark.parametrize("vocab", [1000, 5000],
                         ids=["materialized", "fused"])
def test_diverse_beam_search_matches_jax(vocab, K, G, penalty, hf_compat):
    _diverse_pair("gpt2", 0, vocab, K, G, penalty, hf_compat)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_diverse_beam_search_matches_jax_on_each_family(family, seed):
    """K = 6 in 3 groups, penalty 0.5, the fused path, each family."""
    _diverse_pair(family, seed, 5000, 6, 3, 0.5, True)


def test_diverse_groups_differ_under_the_penalty():
    """With the penalty the groups' best candidates differ more than
    without it (the penalty is what makes them diverse)."""
    def distinct(penalty):
        got = _diverse_pair("gpt2", 1, 1000, 6, 3, penalty, False)
        return sum(len({tuple(r) for r in got.tokens[b].tolist()})
                   for b in range(B))

    assert distinct(0.5) >= distinct(0.0)


def test_beam_groups_must_divide_the_beam():
    with pytest.raises(ValueError, match="divisible"):
        decoding.beam_search(None, {"x": torch.zeros(1, 2)}, 1, 5, 1, 2, 0,
                             10, num_beam_groups=2)


def _config(strategy, **over):
    ic = types.SimpleNamespace(
        decoding_strategy=strategy, max_length=10, min_length=2,
        temperature=0.8, top_p=0.9, beam_size=4, length_penalty=0.8,
        num_beam_groups=2, diversity_penalty=0.5)
    for k, v in over.items():
        setattr(ic, k, v)
    return ic


def test_decode_dispatches_on_the_strategy():
    """``decode()`` gives what each strategy's function gives: greedy,
    nucleus (the generator given, and without one a generator seeded 0),
    beam with groups (tokens, or with ``return_all`` the BeamResult); an
    unknown strategy raises ``ValueError``."""
    cfg, _, _, port = _setup("gpt2", 0)
    mc = cfg.model
    ids = (mc.bos_token_id, mc.eos_token_id, mc.pad_token_id)
    images = images_uint8(400, n=B)

    def run(fn):
        return _port_run(port, images, 10, fn)

    got = run(lambda f, s: decoding.decode(f, s, B, _config("greedy"), *ids))
    want = run(lambda f, s: decoding.greedy_decode(
        f, s, B, ids[0], 10, eos_token_id=ids[1], pad_token_id=ids[2],
        min_length=2))
    assert torch.equal(got, want)

    got = run(lambda f, s: decoding.decode(
        f, s, B, _config("nucleus"), *ids,
        generator=torch.Generator().manual_seed(5)))
    want = run(lambda f, s: decoding.sample_decode(
        f, s, torch.Generator().manual_seed(5), B, *ids, 10,
        temperature=0.8, top_p=0.9, min_length=2).tokens)
    assert torch.equal(got, want)
    got = run(lambda f, s: decoding.decode(f, s, B, _config("nucleus"),
                                           *ids))
    want = run(lambda f, s: decoding.sample_decode(
        f, s, torch.Generator().manual_seed(0), B, *ids, 10,
        temperature=0.8, top_p=0.9, min_length=2).tokens)
    assert torch.equal(got, want)

    beam = dict(length_penalty=0.8, min_length=2, num_beam_groups=2,
                diversity_penalty=0.5)
    got = run(lambda f, s: decoding.decode(f, s, B, _config("beam"), *ids,
                                           max_length=8))
    want = run(lambda f, s: decoding.beam_search(f, s, B, 4, *ids, 8,
                                                 **beam))
    assert torch.equal(got, want.tokens)
    got = run(lambda f, s: decoding.decode(f, s, B, _config("beam"), *ids,
                                           return_all=True))
    want = run(lambda f, s: decoding.beam_search(f, s, B, 4, *ids, 10,
                                                 return_all=True, **beam))
    assert torch.equal(got.tokens, want.tokens)
    assert torch.equal(got.scores, want.scores)

    with pytest.raises(ValueError, match="Unknown decoding strategy"):
        run(lambda f, s: decoding.decode(f, s, B, _config("typical"), *ids))


# -- greedy GPT-2 against HF generate ----------------------------------------

HF_V, HF_H, HF_L, HF_NH, HF_P, HF_MAX = 101, 64, 2, 4, 3, 12
PAD, BOS, EOS = 0, 1, 2


def _hf_pair(seed):
    """A tiny random HF ``GPT2LMHeadModel`` and the port's GPT-2 decoder
    holding its weights (converted by ``models/hf_port.port_gpt2``), with
    a random image prefix; the decoder's stacked weights built as at load."""
    from transformers import GPT2Config, GPT2LMHeadModel

    from image_captioning_ml_project_tpu_torch.config import (
        DecoderConfig, DecoderType)
    from image_captioning_ml_project_tpu_torch.models.gpt2 import GPT2Decoder
    from image_captioning_ml_project_tpu_torch.models.hf_port import port_gpt2
    from image_captioning_ml_project_tpu_torch.params import (
        stack_layer_weights)

    torch.manual_seed(seed)
    tm = GPT2LMHeadModel(GPT2Config(
        vocab_size=HF_V, n_positions=64, n_embd=HF_H, n_layer=HF_L,
        n_head=HF_NH, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
        bos_token_id=BOS, eos_token_id=EOS, pad_token_id=PAD)).eval()
    dec = GPT2Decoder(
        DecoderConfig(decoder_type=DecoderType.GPT2, hidden_dim=HF_H,
                      num_layers=HF_L, num_heads=HF_NH, max_length=HF_MAX,
                      prefix_length=HF_P, gpt2_n_positions=64),
        vocab_size=HF_V, pad_token_id=PAD, bos_token_id=BOS,
        eos_token_id=EOS, feature_dim=32)
    ours = {k[len("decoder."):]: v
            for k, v in port_gpt2(tm.state_dict(), HF_L).items()}
    g = torch.Generator().manual_seed(seed)
    ours["image_to_prefix.weight"] = torch.randn(HF_P * HF_H, 32,
                                                 generator=g) * 0.02
    ours["image_to_prefix.bias"] = torch.zeros(HF_P * HF_H)
    ours["image_prefix"] = torch.randn(1, HF_P, HF_H, generator=g)
    dec.load_state_dict({k: v.clone().contiguous() for k, v in ours.items()})
    dec = dec.eval().requires_grad_(False)
    stack_layer_weights(types.SimpleNamespace(
        decoder=dec, encoder=types.SimpleNamespace(backbone=None)))
    pooled = torch.randn(4, 32, generator=g)
    return tm, dec, pooled


def _truncate_at_eos(row):
    row = list(row)
    return tuple(row[:row.index(EOS) + 1] if EOS in row else row)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_gpt2_matches_hf_generate(seed):
    """``greedy_decode`` over the port's decoder (default decode path)
    against HF's greedy ``generate`` from the same prefix K/V: the prefix
    embeddings run through HF's model (which adds the positions itself)
    give its ``past_key_values``."""
    from transformers import DynamicCache

    tm, dec, pooled = _hf_pair(seed)
    Bh = pooled.shape[0]
    with torch.inference_mode():
        state = dec.init_cache({"pooled_features": pooled}, HF_MAX)
        ours = decoding.greedy_decode(dec.step, state, Bh, BOS, HF_MAX,
                                      eos_token_id=EOS, pad_token_id=PAD)
        raw = (dec._prefix_embeds(pooled)
               - dec.backbone.wpe.weight[:HF_P][None])
    with torch.no_grad():
        past = tm(inputs_embeds=raw.clone(), use_cache=True).past_key_values
        cache = DynamicCache.from_legacy_cache(past.to_legacy_cache())
        prompt = torch.cat([torch.zeros(Bh, HF_P, dtype=torch.long),
                            torch.full((Bh, 1), BOS, dtype=torch.long)], 1)
        gen = tm.generate(input_ids=prompt,
                          attention_mask=torch.ones_like(prompt),
                          past_key_values=cache, num_beams=1,
                          do_sample=False, max_length=HF_P + HF_MAX)
    hf = gen.numpy()[:, HF_P:]
    for b in range(Bh):
        assert _truncate_at_eos(ours[b].tolist()) == \
            _truncate_at_eos(hf[b].tolist())
