"""Frozen-BERT word embeddings for the legacy decoder's ``use_bert`` path.

A copy of ``image_captioning_ml_project_tpu.legacy.bert_embedder`` (which
is torch and ``transformers`` already): the legacy decoder can replace its
learned embedding table with frozen BERT embeddings, re-merging wordpieces
back to word level (tokenize ``[CLS] caption``, run BERT, and for
multi-piece words *sum* the piece embeddings). BERT runs once per batch on
the host (frozen, no gradients) and the trainer takes the word-level
arrays. ``transformers`` is imported only where a model is loaded by name.
"""

from __future__ import annotations

from typing import List

import numpy as np


class BertCaptionEmbedder:
    """Precompute [T, 768] word-level embeddings for captions.

    Requires a locally available BERT (``from_pretrained`` with
    ``local_files_only=True`` or an explicitly passed model/tokenizer —
    this environment has no network egress; tests inject tiny random HF
    models).
    """

    def __init__(self, model=None, tokenizer=None,
                 model_name: str = "bert-base-uncased"):
        if model is None or tokenizer is None:
            import torch  # noqa: F401
            from transformers import BertModel, BertTokenizer

            tokenizer = BertTokenizer.from_pretrained(
                model_name, local_files_only=True)
            model = BertModel.from_pretrained(model_name,
                                              local_files_only=True)
        self.model = model.eval()
        self.tokenizer = tokenizer
        self.dim = self.model.config.hidden_size

    def embed_words(self, words: List[str], max_length: int) -> np.ndarray:
        """Word-level embeddings [max_length, dim]; multi-piece words are
        summed (reference: models/decoder.py:99-108); positions beyond the
        caption are zero (pad)."""
        import torch

        pieces: List[str] = ["[CLS]"]
        word_spans = []
        for w in words:
            wp = self.tokenizer.tokenize(w) or [self.tokenizer.unk_token]
            word_spans.append((len(pieces), len(pieces) + len(wp)))
            pieces.extend(wp)
        ids = self.tokenizer.convert_tokens_to_ids(pieces)
        with torch.no_grad():
            hidden = self.model(torch.tensor([ids])).last_hidden_state[0]
        out = np.zeros((max_length, self.dim), dtype=np.float32)
        for i, (s, e) in enumerate(word_spans[: max_length]):
            out[i] = hidden[s:e].sum(dim=0).numpy()
        return out

    def embed_caption(self, caption: str, max_length: int) -> np.ndarray:
        from ..data.tokenizer import word_tokenize

        # legacy framing: <start> w1 ... wn <end>; specials get zero vectors
        words = word_tokenize(caption)
        out = np.zeros((max_length, self.dim), dtype=np.float32)
        inner = self.embed_words(words, max_length - 1)
        out[1:] = inner  # slot 0 = <start> (zero embedding)
        return out

    def embed_batch(self, captions: List[str], max_length: int) -> np.ndarray:
        return np.stack([self.embed_caption(c, max_length) for c in captions])

    def vocab_table(self, vocab, batch_size: int = 256) -> np.ndarray:
        """Context-free per-token embedding table [V, dim] for
        autoregressive generation (each vocab word embedded standalone as
        ``[CLS] pieces``, multi-piece sums as in :meth:`embed_words`; ALL
        special tokens — pad/start/end/unk — map to zero vectors like the
        caption framing). Training/teacher-forcing use the contextual
        :meth:`embed_batch` path; generation needs a static
        token -> embedding map because future context does not exist yet.

        Words are packed into padded batches (one BERT forward per
        ``batch_size`` words, masked so pads don't attend) instead of one
        forward per word, and the result is cached per vocabulary — a
        ~10k-word COCO vocab is seconds, not minutes, and repeated
        validate() calls pay nothing."""
        import torch

        key = (len(vocab.idx2word),
               hash(tuple(sorted(vocab.idx2word.items()))))
        cached = getattr(self, "_vocab_table_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]

        specials = {vocab.pad_token_id, vocab.bos_token_id,
                    vocab.eos_token_id, vocab.unk_token_id}
        table = np.zeros((len(vocab.idx2word), self.dim), dtype=np.float32)
        cls_id = self.tokenizer.convert_tokens_to_ids(["[CLS]"])[0]
        pad_id = self.tokenizer.convert_tokens_to_ids(["[PAD]"])[0]
        rows = []  # (vocab idx, [CLS]+piece ids)
        for idx, word in vocab.idx2word.items():
            if idx in specials:
                continue
            wp = (self.tokenizer.tokenize(word)
                  or [self.tokenizer.unk_token])
            rows.append((idx, [cls_id]
                         + self.tokenizer.convert_tokens_to_ids(wp)))
        for start in range(0, len(rows), batch_size):
            chunk = rows[start:start + batch_size]
            L = max(len(ids) for _, ids in chunk)
            ids = np.full((len(chunk), L), pad_id, dtype=np.int64)
            mask = np.zeros((len(chunk), L), dtype=np.int64)
            for r, (_, seq) in enumerate(chunk):
                ids[r, : len(seq)] = seq
                mask[r, : len(seq)] = 1
            with torch.no_grad():
                hidden = self.model(
                    torch.from_numpy(ids),
                    attention_mask=torch.from_numpy(mask),
                ).last_hidden_state.numpy()
            for r, (idx, seq) in enumerate(chunk):
                table[idx] = hidden[r, 1: len(seq)].sum(axis=0)
        self._vocab_table_cache = (key, table)
        return table
