"""Tokenizers: copies of ``WordVocab``, ``truncate_at_eos``,
``HFTokenizerAdapter`` and ``load_tokenizer`` from ``image_captioning_ml_project_tpu.data.
tokenizer`` (same ids, same JSON file, same ``encode``/``decode``), carried
here because the port never imports the JAX package.

``WordVocab`` ids: ``<pad>``=0, ``<start>``=1, ``<end>``=2, ``<unk>``=3,
then corpus words above the frequency threshold in insertion order. Words
are lowercased alphabetic runs, digit runs and single punctuation marks.
``HFTokenizerAdapter`` wraps a HuggingFace tokenizer with the same
interface.
"""

from __future__ import annotations

import json
import re
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

PAD, START, END, UNK = 0, 1, 2, 3

_TOKEN_RE = re.compile(r"[a-zA-Z]+|[0-9]+|[^\sa-zA-Z0-9]")


def word_tokenize(text: str) -> List[str]:
    return _TOKEN_RE.findall(text.lower())


class WordVocab:
    specials = ["<pad>", "<start>", "<end>", "<unk>"]

    pad_token_id = PAD
    bos_token_id = START
    eos_token_id = END
    unk_token_id = UNK

    def __init__(self, word2idx: Optional[Dict[str, int]] = None):
        if word2idx is None:
            word2idx = {w: i for i, w in enumerate(self.specials)}
        self.word2idx = dict(word2idx)
        self.idx2word = {i: w for w, i in self.word2idx.items()}

    @classmethod
    def build(cls, captions: Iterable[str], threshold: int = 5) -> "WordVocab":
        """The words of a caption corpus seen at least ``threshold`` times."""
        counter = Counter()
        for cap in captions:
            counter.update(word_tokenize(cap))
        vocab = cls()
        for word, count in counter.items():
            if count >= threshold:
                vocab.add_word(word)
        return vocab

    def add_word(self, word: str) -> int:
        if word not in self.word2idx:
            idx = len(self.word2idx)
            self.word2idx[word] = idx
            self.idx2word[idx] = word
        return self.word2idx[word]

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.word2idx, f)

    @classmethod
    def load(cls, path: str) -> "WordVocab":
        with open(path) as f:
            return cls(json.load(f))

    @property
    def vocab_size(self) -> int:
        return len(self.word2idx)

    def __len__(self):
        return len(self.word2idx)

    def __call__(self, word: str) -> int:
        return self.word2idx.get(word, UNK)

    def encode(self, text: str, max_length: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """``<start> words... <end>``, padded or cut to ``max_length``;
        the mask marks real tokens."""
        ids = [START] + [self(w) for w in word_tokenize(text)] + [END]
        ids = ids[:max_length]
        mask = np.zeros(max_length, dtype=np.int32)
        mask[:len(ids)] = 1
        out = np.full(max_length, PAD, dtype=np.int32)
        out[:len(ids)] = ids
        return out, mask

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True
               ) -> str:
        """Words of ``ids``; with ``skip_special_tokens`` the specials are
        dropped and the text ends at the first ``<end>``."""
        words = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in (PAD, START, UNK):
                continue
            if i == END and skip_special_tokens:
                break
            words.append(self.idx2word.get(i, "<unk>"))
        return " ".join(words)


def truncate_at_eos(ids: List[int], eos_id, bos_id=None, pad_id=None
                    ) -> List[int]:
    """Cut a generated id sequence at its first content-terminating EOS:
    leading special ids (BOS, and EOS/pad where a GPT-2-style tokenizer
    shares them) are skipped first, then everything from the next EOS on
    is dropped."""
    specials = {int(eos_id)}
    if bos_id is not None:
        specials.add(int(bos_id))
    if pad_id is not None:
        specials.add(int(pad_id))
    start = 0
    while start < len(ids) and int(ids[start]) in specials:
        start += 1
    for i in range(start, len(ids)):
        if int(ids[i]) == int(eos_id):
            return ids[:i]
    return ids


class HFTokenizerAdapter:
    """A HuggingFace tokenizer with the special-token wiring of the JAX
    package: pad falls back to eos, bos to cls, eos to sep."""

    def __init__(self, hf_tokenizer):
        self.hf = hf_tokenizer
        if self.hf.pad_token is None:
            self.hf.pad_token = self.hf.eos_token

    @property
    def vocab_size(self) -> int:
        return len(self.hf)

    def __len__(self):
        return len(self.hf)

    @property
    def pad_token_id(self):
        return self.hf.pad_token_id

    @property
    def bos_token_id(self):
        bid = getattr(self.hf, "bos_token_id", None)
        return bid if bid is not None else self.hf.cls_token_id

    @property
    def eos_token_id(self):
        eid = self.hf.eos_token_id
        # BERT-style tokenizers have no eos; [SEP] terminates sequences
        return eid if eid is not None else self.hf.sep_token_id

    def encode(self, text: str, max_length: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """``[BOS] token ids [EOS]``, padded or cut to ``max_length``; the
        mask (not the pad id, which may equal eos) marks real tokens. The
        adapter frames the specials itself (``add_special_tokens=False``)."""
        enc = self.hf(text, truncation=True, max_length=max_length - 2,
                      add_special_tokens=False)
        ids = ([int(self.bos_token_id)] + list(enc["input_ids"])
               + [int(self.eos_token_id)])
        out = np.full(max_length, int(self.pad_token_id), dtype=np.int32)
        mask = np.zeros(max_length, dtype=np.int32)
        out[:len(ids)] = ids
        mask[:len(ids)] = 1
        return out, mask

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True
               ) -> str:
        ids = [int(i) for i in ids]
        if skip_special_tokens:
            ids = truncate_at_eos(ids, self.eos_token_id, self.bos_token_id,
                                  self.pad_token_id)
        return self.hf.decode(ids, skip_special_tokens=skip_special_tokens)


def load_tokenizer(name_or_path: str, vocab_path: Optional[str] = None):
    """Resolve a tokenizer: ``word`` with ``vocab_path``, or a vocab JSON
    path -> :class:`WordVocab`; anything else names a HuggingFace
    tokenizer, which must be cached locally (nothing is downloaded)."""
    if name_or_path == "word":
        if not vocab_path:
            raise ValueError(
                "the 'word' tokenizer needs vocab_path (a vocab JSON "
                "built by setup_tokenizer)")
        return WordVocab.load(vocab_path)
    if name_or_path.endswith(".json"):
        return WordVocab.load(name_or_path)
    from transformers import AutoTokenizer

    return HFTokenizerAdapter(AutoTokenizer.from_pretrained(
        name_or_path, local_files_only=True))
