"""The port's ``setup_tokenizer`` (port: main.py) against the JAX
package's: the same tokenizer, vocabulary size and special ids on each of
its branches. A locally cached HF tokenizer is stood in for by a tiny
word-level tokenizer built in memory (no file is read, nothing is
downloaded); the word-vocabulary branch reads a tiny annotations file
written by the test."""

import json
import sys

import numpy as np
import pytest
import torch
import transformers
from tokenizers import Tokenizer, models, pre_tokenizers

from image_captioning_ml_project_tpu import config as jax_config
from image_captioning_ml_project_tpu import main as jax_main
from image_captioning_ml_project_tpu.data import tokenizer as jax_tokenizer
from image_captioning_ml_project_tpu_torch import config as port_config
from image_captioning_ml_project_tpu_torch import main as port_main
from image_captioning_ml_project_tpu_torch.data import (
    tokenizer as port_tokenizer)

torch.set_num_threads(1)

_WORDS = ["a", "cat", "sat", "on", "the", "mat", "dog", "ran"]
# GPT-2's wiring (bos = eos, no pad: the adapter sets pad to eos) and a
# BERT-style one (no bos or eos: the adapter takes cls and sep)
_STYLES = {
    "gpt2": (["<|endoftext|>"], dict(bos_token="<|endoftext|>",
                                     eos_token="<|endoftext|>")),
    "bert": (["[PAD]", "[CLS]", "[SEP]"], dict(pad_token="[PAD]",
                                               cls_token="[CLS]",
                                               sep_token="[SEP]")),
}


def _hf_tokenizer(style):
    """A fresh word-level HF tokenizer (the adapter sets its pad token, so
    each package gets its own)."""
    specials, kw = _STYLES[style]
    vocab = {w: i for i, w in enumerate(specials + ["[UNK]"] + _WORDS)}
    tok = Tokenizer(models.WordLevel(vocab=vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    return transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token="[UNK]", **kw)


def _configs(tmp_path):
    """The port's flagship config and the JAX package's copy of it, each
    with its own output directory."""
    cfg = port_main.flagship_config()
    cfg.data_root = str(tmp_path)
    out = {}
    for name, module in (("port", port_config), ("jax", jax_config)):
        c = module.config_from_dict(port_config.config_to_dict(cfg))
        c.output_dir = str(tmp_path / name)
        out[name] = c
    return out


def _ids(cfg):
    m = cfg.model
    return m.vocab_size, m.pad_token_id, m.bos_token_id, m.eos_token_id


@pytest.mark.parametrize("style", sorted(_STYLES))
def test_hf_branch_matches_jax(tmp_path, monkeypatch, style):
    """No ``--vocab``: both packages ask for the cached tokenizer of the
    decoder's pretrained name, locally only, and wire the same ids."""
    asked = []

    def from_pretrained(name, **kw):
        asked.append((name, kw))
        return _hf_tokenizer(style)

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        from_pretrained)
    cfgs = _configs(tmp_path)
    port_tok = port_main.setup_tokenizer(cfgs["port"])
    jax_tok = jax_main.setup_tokenizer(cfgs["jax"])
    assert isinstance(port_tok, port_tokenizer.HFTokenizerAdapter)
    assert isinstance(jax_tok, jax_tokenizer.HFTokenizerAdapter)
    name = cfgs["port"].model.decoder.pretrained_model_name
    assert asked == [(name, {"local_files_only": True})] * 2
    assert _ids(cfgs["port"]) == _ids(cfgs["jax"])
    assert cfgs["port"].model.vocab_size == len(_STYLES[style][0]) + 1 + len(
        _WORDS)
    text = "the cat sat on a mat"
    for length in (12, 5):  # padded, and cut
        got, got_mask = port_tok.encode(text, length)
        want, want_mask = jax_tok.encode(text, length)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_mask, want_mask)
        assert port_tok.decode(got) == jax_tok.decode(want)
    eos, bos = port_tok.eos_token_id, port_tok.bos_token_id
    ids = [bos] + list(port_tok.encode("a dog ran", 8)[0][1:4]) + [eos, 7]
    assert port_tok.decode(ids) == jax_tok.decode(ids) == "a dog ran"
    assert port_tok.decode(ids, skip_special_tokens=False) == \
        jax_tok.decode(ids, skip_special_tokens=False)


def _write_annotations(tmp_path, cfg):
    captions = (["a cat sat on the mat"] * 5 + ["the dog ran"] * 6
                + ["a bird flew"] * 2)
    path = tmp_path / cfg.train_json
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"annotations": [
        {"image_id": i, "caption": c} for i, c in enumerate(captions)]}))


def _raise(*args, **kw):
    raise OSError("no cached tokenizer")


@pytest.mark.parametrize("how", ["not cached", "no transformers"])
def test_word_vocab_branch_matches_jax(tmp_path, monkeypatch, how):
    """The HF branch fails (nothing cached, or ``transformers`` missing):
    both packages build the same word vocabulary from the annotations,
    save it, and wire the same ids."""
    if how == "not cached":
        monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                            _raise)
    else:
        monkeypatch.setitem(sys.modules, "transformers", None)
    cfgs = _configs(tmp_path)
    _write_annotations(tmp_path, cfgs["port"])
    port_tok = port_main.setup_tokenizer(cfgs["port"])
    jax_tok = jax_main.setup_tokenizer(cfgs["jax"])
    assert isinstance(port_tok, port_tokenizer.WordVocab)
    assert port_tok.word2idx == jax_tok.word2idx
    assert _ids(cfgs["port"]) == _ids(cfgs["jax"]) == (4 + 8, 0, 1, 2)
    with open(tmp_path / "port" / "vocab.json") as f:
        assert json.load(f) == port_tok.word2idx
    ids, _ = port_tok.encode("the dog sat", 6)
    np.testing.assert_array_equal(ids, jax_tok.encode("the dog sat", 6)[0])
    # an explicit --vocab JSON comes first, before any HF lookup
    cfgs = _configs(tmp_path)
    tok = port_main.setup_tokenizer(cfgs["port"],
                                    str(tmp_path / "port" / "vocab.json"))
    assert tok.word2idx == port_tok.word2idx


def test_truncate_at_eos_matches_jax():
    for ids, eos, bos, pad in (([5, 5, 3, 4, 5, 9], 5, 5, 5),
                               ([1, 3, 4, 2, 0, 0], 2, 1, 0),
                               ([1, 3, 4], 2, 1, None), ([], 2, None, None),
                               ([2, 2, 2], 2, 1, 0)):
        assert port_tokenizer.truncate_at_eos(ids, eos, bos, pad) == \
            jax_tokenizer.truncate_at_eos(ids, eos, bos, pad)
