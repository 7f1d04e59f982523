"""Word-level vocabulary: a copy of ``WordVocab`` from
``image_captioning_ml_project_tpu.data.tokenizer`` (same ids, same JSON
file, same ``encode``/``decode``), carried here because the port never
imports the JAX package.

ids: ``<pad>``=0, ``<start>``=1, ``<end>``=2, ``<unk>``=3, then corpus
words above the frequency threshold in insertion order. Words are
lowercased alphabetic runs, digit runs and single punctuation marks.
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
