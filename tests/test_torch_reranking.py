"""CLIP reranking (port: models/clip_text.py, inference/reranking.py,
ops/resize.py, params.py's scorer bridges) against the JAX package's, on a
tiny CLIP (vision width 32, 2 layers, patch 8 on 24x24 images; text width
32, 2 layers, vocabulary 100 with EOT 99, 16 positions; projection 16),
f32, from one set of weights:

* the text tower's hidden states and pooled vectors on both EOT branches
  (pool at the first ``eos_token_id``, or at ``argmax(input_ids)`` for the
  legacy 2 and for None) within 1e-5 of the largest;
* the scorer's image and text features and its logits within 1e-5 of the
  largest (the vision tower through the encoder kernel's plain version,
  JAX's through its per-layer modules);
* the HF loader (``scorer_from_hf``) against JAX's ``port_clip_model`` +
  the flax bridge on a tiny random HF ``CLIPModel``: identical state
  dicts, and HF's own logits within 1e-5 of the largest;
* the cubic resize against ``jax.image.resize(..., "cubic")``, growing and
  shrinking, within 1e-5 of the largest;
* ``CLIPReranker`` / ``rerank_candidates``: the same winners as JAX's,
  scores within 1e-5 of the largest, the served 32x32 images resized to
  the checkpoint's 24;
* ``build_hf_reranker`` with a tiny ``CLIPModel`` and tokenizer standing
  in for ``from_pretrained`` (nothing is read or downloaded), and its
  missing-files branch, which returns None with the JAX package's
  warning."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from image_captioning_ml_project_tpu.inference import reranking as jax_rr
from image_captioning_ml_project_tpu.models import clip_text as jax_clip
from image_captioning_ml_project_tpu_torch.inference import reranking
from image_captioning_ml_project_tpu_torch.models.clip_text import CLIPScorer
from image_captioning_ml_project_tpu_torch.ops.resize import resize_cubic
from image_captioning_ml_project_tpu_torch.params import (load_scorer,
                                                          scorer_from_flax,
                                                          scorer_from_hf)

torch.set_num_threads(1)

CLIP = dict(vision_hidden=32, vision_layers=2, vision_heads=4, patch_size=8,
            text_vocab=100, text_hidden=32, text_layers=2, text_heads=4,
            text_max_positions=16, projection_dim=16)
CLIP_SIZE, SERVED_SIZE, T, EOT, SOT = 24, 32, 16, 99, 98


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)


def _ids(seed, n, eot=EOT):
    """n CLIP id rows: SOT, words in [3, 97], EOT, zero padding."""
    rs = np.random.RandomState(seed)
    ids = np.zeros((n, T), np.int32)
    for i in range(n):
        k = rs.randint(1, T - 2)
        ids[i, 0] = SOT
        ids[i, 1:k + 1] = rs.randint(3, 98, k)
        ids[i, k + 1] = eot
    return ids


def _pair(seed, eos=EOT):
    """(flax scorer, variables, the port's scorer) with equal weights."""
    model = jax_clip.CLIPScorer(text_eos_token_id=eos, **CLIP)
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(seed),
        jnp.zeros((1, CLIP_SIZE, CLIP_SIZE, 3)), jnp.zeros((1, T), jnp.int32))
    port = load_scorer(CLIPScorer(image_size=CLIP_SIZE, text_eos_token_id=eos,
                                  **CLIP), scorer_from_flax(variables), "cpu")
    return model, variables, port


def _images(seed, n, size=CLIP_SIZE):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(
        np.float32)


@pytest.mark.parametrize("eos", [EOT, 2, None], ids=["eot", "legacy-2",
                                                     "none"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_text_backbone_matches_jax(seed, eos):
    model, variables, port = _pair(seed, eos)
    ids = _ids(seed + 10, 4)
    want_x, want_pooled = model.apply(variables, jnp.asarray(ids),
                                      method=lambda m, i: m.text(i))
    with torch.inference_mode():
        got_x, got_pooled = port.text(torch.from_numpy(ids).long())
    _close(got_x, want_x)
    _close(got_pooled, want_pooled)


def test_text_backbone_pools_at_eot():
    """Pooling reads the EOT position: the first ``eos_token_id``, or the
    largest id for the legacy configs."""
    _, _, port = _pair(0)
    ids = torch.from_numpy(_ids(3, 2)).long()
    with torch.inference_mode():
        x, pooled = port.text(ids)
    eot = (ids == EOT).int().argmax(dim=-1)
    assert torch.equal(pooled, x[torch.arange(2), eot])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scorer_matches_jax(seed):
    model, variables, port = _pair(seed)
    images = _images(seed + 20, 3)
    ids = _ids(seed + 30, 5)
    jim, jids = jnp.asarray(images), jnp.asarray(ids)
    tim, tids = torch.from_numpy(images), torch.from_numpy(ids).long()
    with torch.inference_mode():
        _close(port.encode_image(tim),
               model.apply(variables, jim, method=model.encode_image))
        _close(port.encode_text(tids),
               model.apply(variables, jids, method=model.encode_text))
        _close(port(tim, tids), model.apply(variables, jim, jids))
    assert port.logit_scale.dtype == torch.float32
    assert port.vision.stack is not None


def _hf_clip(seed):
    torch.manual_seed(seed)
    cfg = transformers.CLIPConfig(
        text_config=dict(vocab_size=100, hidden_size=32,
                         intermediate_size=128, num_hidden_layers=2,
                         num_attention_heads=4, max_position_embeddings=T,
                         eos_token_id=EOT, bos_token_id=SOT, pad_token_id=0),
        vision_config=dict(hidden_size=32, intermediate_size=128,
                           num_hidden_layers=2, num_attention_heads=4,
                           image_size=CLIP_SIZE, patch_size=8),
        projection_dim=16)
    return transformers.CLIPModel(cfg).eval()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hf_loader_matches_jax_port(seed):
    hf = _hf_clip(seed)
    sd = hf.state_dict()
    got = scorer_from_hf(sd)
    want = scorer_from_flax(jax_clip.port_clip_model(
        {k: v.numpy() for k, v in sd.items()}, vision_layers=2,
        text_layers=2))
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    port = load_scorer(CLIPScorer(image_size=CLIP_SIZE, text_eos_token_id=EOT,
                                  **CLIP), got, "cpu")
    images = _images(seed + 40, 2)
    ids = _ids(seed + 50, 3)
    with torch.inference_mode():
        ours = port(torch.from_numpy(images), torch.from_numpy(ids).long())
        theirs = hf(input_ids=torch.from_numpy(ids).long(),
                    pixel_values=torch.from_numpy(images).permute(0, 3, 1, 2)
                    ).logits_per_image
    _close(ours, theirs.numpy())


@pytest.mark.parametrize("size,shape", [(48, (32, 32)), (20, (32, 32)),
                                        (24, (20, 40))],
                         ids=["grow", "shrink", "mixed"])
def test_cubic_resize_matches_jax(size, shape):
    x = np.random.RandomState(size).randn(2, *shape, 3).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, size, size, 3), "cubic")
    _close(resize_cubic(torch.from_numpy(x), size), want)


def _decode_fn(ids):
    return " ".join(f"w{int(i)}" for i in ids if int(i) > 2)


def _clip_tokenize(texts):
    """A deterministic word-hash CLIP tokenizer: SOT, one id in [3, 97]
    per word, EOT, zero padding to 16 positions."""
    out = np.zeros((len(texts), T), np.int32)
    for r, text in enumerate(texts):
        words = [3 + sum(map(ord, w)) * 7919 % 95 for w in text.split()]
        row = [SOT] + words[:T - 2] + [EOT]
        out[r, :len(row)] = row
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rerank_candidates_picks_jax_winner(seed):
    """The served 32x32 uint8 images, resized on their device to the
    checkpoint's 24, score 6 candidates each."""
    model, variables, port = _pair(seed)
    rs = np.random.RandomState(seed + 60)
    images = rs.randint(0, 256, (3, SERVED_SIZE, SERVED_SIZE, 3)).astype(
        np.uint8)
    cand = rs.randint(0, 50, (3, 6, 8)).astype(np.int32)
    jr = jax_rr.CLIPReranker(model, variables, _clip_tokenize, _decode_fn,
                             image_size=CLIP_SIZE)
    pr = reranking.CLIPReranker(port, _clip_tokenize, _decode_fn,
                                image_size=CLIP_SIZE)
    want_best, want_scores = jax_rr.rerank_candidates(
        jnp.asarray(cand), jnp.asarray(images), _decode_fn, _clip_tokenize,
        model, variables, score_fn=jr._score)
    with torch.inference_mode():
        got_best, got_scores = reranking.rerank_candidates(
            torch.from_numpy(cand), torch.from_numpy(images), _decode_fn,
            _clip_tokenize, port, score_fn=pr.score)
    _close(got_scores, want_scores)
    np.testing.assert_array_equal(got_best, want_best)
    np.testing.assert_array_equal(
        pr(torch.from_numpy(images), torch.from_numpy(cand)),
        np.asarray(jr(images, cand)))
    # without a score_fn: the scorer on images already CLIP-normalised at
    # its size
    normed = _images(seed + 61, 3)
    want_best, want_scores = jax_rr.rerank_candidates(
        jnp.asarray(cand), jnp.asarray(normed), _decode_fn, _clip_tokenize,
        model, variables)
    with torch.inference_mode():
        got_best, got_scores = reranking.rerank_candidates(
            torch.from_numpy(cand), torch.from_numpy(normed), _decode_fn,
            _clip_tokenize, port)
    _close(got_scores, want_scores)
    np.testing.assert_array_equal(got_best, want_best)


def _word_tokenizer():
    """A word-level HF tokenizer over the hash tokenizer's words, standing
    in for CLIP's BPE: pad 0, SOT 98, EOT 99."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    vocab = {"<pad>": 0, "<unk>": 1, "<|startoftext|>": SOT,
             "<|endoftext|>": EOT}
    vocab.update({f"w{i}": i for i in range(3, 98)})
    tok = Tokenizer(models.WordLevel(vocab=vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(
        single="<|startoftext|> $A <|endoftext|>",
        special_tokens=[("<|startoftext|>", SOT), ("<|endoftext|>", EOT)])
    return transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, pad_token="<pad>", unk_token="<unk>")


def test_build_hf_reranker_matches_jax(monkeypatch):
    """Both packages' ``build_hf_reranker`` over the same tiny checkpoint
    and tokenizer pick the same captions (the port's on the CPU)."""
    hf = _hf_clip(5)
    tok = _word_tokenizer()
    monkeypatch.setattr(transformers.CLIPModel, "from_pretrained",
                        classmethod(lambda cls, *a, **k: hf))
    monkeypatch.setattr(transformers.CLIPTokenizer, "from_pretrained",
                        classmethod(lambda cls, *a, **k: tok))
    port = reranking.build_hf_reranker(_decode_fn, "cpu")
    ref = jax_rr.build_hf_reranker(_decode_fn)
    assert port is not None and ref is not None
    assert port.image_size == CLIP_SIZE
    rs = np.random.RandomState(70)
    images = rs.randint(0, 256, (4, SERVED_SIZE, SERVED_SIZE, 3)).astype(
        np.uint8)
    cand = rs.randint(3, 98, (4, 5, 9)).astype(np.int32)
    np.testing.assert_array_equal(
        port(torch.from_numpy(images), torch.from_numpy(cand)),
        np.asarray(ref(images, cand)))
    ids = port.clip_tokenize_fn(["w5 w6", "w7"])
    assert ids.shape == (2, T) and ids[0, :4].tolist() == [SOT, 5, 6, EOT]


def test_build_hf_reranker_without_local_files(tmp_path, caplog):
    """No checkpoint in the given directory: None, with the warning."""
    with caplog.at_level(logging.WARNING):
        got = reranking.build_hf_reranker(_decode_fn, "cpu",
                                          clip_model_name=str(tmp_path))
    assert got is None
    assert "continuing without reranking" in caplog.text
