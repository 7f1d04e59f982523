"""The port's GPT-2 byte-level BPE tokenizer (``data/bpe.py``) and
``load_tokenizer`` against the JAX package's, on the CPU.

Both read the same ``vocab.json`` and ``merges.txt``, written here (all
256 byte units plus merges over common fragments, as ``tests/test_bpe.py``
builds them). Over seeded random text (ASCII words, non-ASCII letters,
contractions, digits, punctuation, runs of spaces, tabs and newlines) the
ids, ``encode``'s ids and mask, and the decoded text must be identical.
``load_tokenizer``'s three branches (``word`` with a vocab path, a vocab
JSON path, a HuggingFace name, here a tiny tokenizer patched into
``from_pretrained``) give what JAX's give."""

import json

import numpy as np
import pytest

from image_captioning_ml_project_tpu.data import bpe as jax_bpe
from image_captioning_ml_project_tpu.data import tokenizer as jax_tok
from image_captioning_ml_project_tpu_torch import data as port_data
from image_captioning_ml_project_tpu_torch.data import bpe
from image_captioning_ml_project_tpu_torch.data import tokenizer as port_tok

MERGES = [("Ġ", "t"), ("Ġt", "h"), ("Ġth", "e"), ("a", "n"), ("an", "d"),
          ("i", "n"), ("in", "g"), ("Ġ", "a"), ("c", "a"), ("ca", "t"),
          ("Ġ", "d"), ("o", "g"), ("Ġd", "og"), ("'", "s"), ("e", "r"),
          ("Ġ", "w"), ("Ġw", "a"), ("Ã", "©"), ("Ġ", "Ġ"), ("1", "2")]

WORDS = ["the", "cat", "and", "a", "dog", "running", "walker", "dogs'",
         "it's", "we're", "they've", "I'm", "you'll", "he'd", "don't",
         "café", "naïve", "θ", "日本語", "Ünïcödé", "123", "3½", "x_y",
         "!!", "...", "(ok)", "🙂", "e-mail", "#1"]
SPACES = [" ", " ", " ", "  ", "   ", "\t", "\n", " \n ", "　"]


def _hf_tokenizer():
    """A tiny word-level HF tokenizer with GPT-2's special-token wiring,
    built in memory (``tests/test_torch_tokenizer.py``'s)."""
    import transformers
    from tokenizers import Tokenizer, models, pre_tokenizers

    words = ["<|endoftext|>", "[UNK]", "a", "cat", "sat", "on", "the", "mat",
             "dog", "ran"]
    tok = Tokenizer(models.WordLevel(vocab={w: i for i, w in
                                            enumerate(words)},
                                     unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    return transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token="[UNK]", bos_token="<|endoftext|>",
        eos_token="<|endoftext|>")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bpe")
    units = [jax_bpe.bytes_to_unicode()[b] for b in range(256)]
    tokens = units + ["".join(m) for m in MERGES] + ["<|endoftext|>"]
    vocab_file, merges_file = str(tmp / "vocab.json"), str(tmp / "merges.txt")
    with open(vocab_file, "w", encoding="utf-8") as f:
        json.dump({t: i for i, t in enumerate(tokens)}, f)
    with open(merges_file, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        f.write("\n".join(" ".join(m) for m in MERGES) + "\n")
    return vocab_file, merges_file


def _texts(seed, n=40):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        k = rs.randint(1, 12)
        parts = [WORDS[i] for i in rs.randint(0, len(WORDS), k)]
        gaps = [SPACES[i] for i in rs.randint(0, len(SPACES), k + 1)]
        text = gaps[0] + "".join(p + g for p, g in zip(parts, gaps[1:]))
        out.append(text if rs.rand() < 0.7 else text.strip())
    return out


def test_bytes_to_unicode_and_pattern_are_jax():
    assert bpe.bytes_to_unicode() == jax_bpe.bytes_to_unicode()
    assert bpe._PAT.pattern == jax_bpe._PAT.pattern
    assert port_data.GPT2BPETokenizer is bpe.GPT2BPETokenizer


@pytest.mark.parametrize("seed", range(4))
def test_ids_and_text_are_jax(files, seed):
    mine, theirs = bpe.GPT2BPETokenizer(*files), \
        jax_bpe.GPT2BPETokenizer(*files)
    assert (mine.pad_token_id, mine.bos_token_id, mine.eos_token_id,
            len(mine)) == (theirs.pad_token_id, theirs.bos_token_id,
                           theirs.eos_token_id, len(theirs))
    for text in _texts(seed):
        ids = mine.tokenize_ids(text)
        assert ids == theirs.tokenize_ids(text), repr(text)
        assert mine.decode(ids) == theirs.decode(ids) == text, repr(text)
        for max_length in (6, 40):
            a, b = mine.encode(text, max_length), \
                theirs.encode(text, max_length)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            assert mine.decode(a[0]) == theirs.decode(b[0])
            assert mine.decode(a[0], skip_special_tokens=False) == \
                theirs.decode(b[0], skip_special_tokens=False)


def test_load_tokenizer_branches_are_jax(tmp_path, monkeypatch):
    import transformers

    words = ["a cat on a mat", "two dogs and a cat"]
    path = str(tmp_path / "vocab.json")
    jax_tok.WordVocab.build(words, threshold=1).save(path)
    for args in (("word", path), (path,)):
        mine, theirs = port_tok.load_tokenizer(*args), \
            jax_tok.load_tokenizer(*args)
        assert isinstance(mine, port_tok.WordVocab)
        assert mine.word2idx == theirs.word2idx
    for load in (port_tok.load_tokenizer, jax_tok.load_tokenizer):
        with pytest.raises(ValueError, match="vocab_path"):
            load("word")

    asked = []

    def from_pretrained(name, **kw):
        asked.append((name, kw))
        return _hf_tokenizer()

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        from_pretrained)
    mine, theirs = port_tok.load_tokenizer("gpt2"), \
        jax_tok.load_tokenizer("gpt2")
    assert isinstance(mine, port_tok.HFTokenizerAdapter)
    # the port never asks the hub: only a locally cached tokenizer
    assert asked[0] == ("gpt2", {"local_files_only": True})
    for text in ("a cat sat on the mat", "the dog ran"):
        a, b = mine.encode(text, 8), theirs.encode(text, 8)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert mine.decode(a[0]) == theirs.decode(b[0])
