"""Self-contained GPT-2 byte-level BPE tokenizer: a copy of
``image_captioning_ml_project_tpu.data.bpe`` (same ids, same text), carried
here because the port never imports the JAX package.

The reference's modern stack tokenizes with HF's pretrained GPT-2 tokenizer
(reference: src/main.py:156-168). In a no-network environment the HF hub is
unreachable, so this module implements the GPT-2 byte-level BPE algorithm
directly from local ``vocab.json`` + ``merges.txt`` files (the exact format
OpenAI/HF publish). Produces identical ids to HF's slow GPT2Tokenizer for
the same files; exposes the same small interface as the other tokenizers
(encode/decode + special ids).
"""

from __future__ import annotations

import json
import re
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte→unicode map."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


# GPT-2's pre-tokenizer uses \p{L}/\p{N}; stdlib `re` equivalents:
# [^\W\d_] = unicode letters, \d = unicode digits, (?:[^\s\w]|_) = the rest.
_PAT = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?(?:[^\W\d_])+| ?\d+| ?(?:[^\s\w]|_)+"
    r"|\s+(?!\S)|\s+")


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class GPT2BPETokenizer:
    """Byte-level BPE with GPT-2 semantics.

    GPT-2 has a single special token ``<|endoftext|>`` serving as
    bos/eos/pad (the reference maps pad←eos, src/main.py:160-161).
    """

    def __init__(self, vocab_file: str, merges_file: str,
                 unk_token: str = "<|endoftext|>"):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(merges_file, encoding="utf-8") as f:
            # HF-exact parsing: drop the "#version" header and the final
            # (empty) line — including HF's quirk of dropping the last merge
            # when the file lacks a trailing newline.
            merges = [tuple(line.split()) for line in
                      f.read().split("\n")[1:-1] if line]
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.cache: Dict[str, str] = {}
        self.unk_token = unk_token
        eot = self.encoder.get(unk_token, len(self.encoder) - 1)
        self.pad_token_id = eot
        self.bos_token_id = eot
        self.eos_token_id = eot

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def __len__(self):
        return len(self.encoder)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token)
        pairs = _get_pairs(word)
        if not pairs:
            return token
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1e18))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def tokenize_ids(self, text: str) -> List[int]:
        ids: List[int] = []
        unk = self.encoder.get(self.unk_token)
        for token in _PAT.findall(text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            for piece in self._bpe(token).split(" "):
                ids.append(self.encoder.get(piece, unk))
        return ids

    def encode(self, text: str, max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        """``<|endoftext|> BPE ids <|endoftext|>``, padded with eos (= pad)
        to max_length. The trailing EOS (covered by the attention mask) is
        what lets the loss supervise sequence termination even though GPT-2's
        pad and eos ids coincide — masking by pad id alone would strip it.
        The leading BOS supervises the first word from the same conditioning
        decode uses (see HFTokenizerAdapter.encode / docs/parity.md)."""
        ids = ([self.bos_token_id] + self.tokenize_ids(text)[: max_length - 2]
               + [self.eos_token_id])
        out = np.full(max_length, self.pad_token_id, dtype=np.int32)
        mask = np.zeros(max_length, dtype=np.int32)
        out[: len(ids)] = ids
        mask[: len(ids)] = 1
        return out, mask

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        ids = [int(i) for i in ids]
        if skip_special_tokens:
            from .tokenizer import truncate_at_eos

            ids = truncate_at_eos(ids, self.eos_token_id, self.bos_token_id,
                                  self.pad_token_id)
        pieces = []
        for i in ids:
            if skip_special_tokens and i == self.eos_token_id:
                continue
            pieces.append(self.decoder.get(i, ""))
        text = "".join(pieces)
        data = bytearray(self.byte_decoder.get(c, 32) for c in text)
        return data.decode("utf-8", errors="replace")
