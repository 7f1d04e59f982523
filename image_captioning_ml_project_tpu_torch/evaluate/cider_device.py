"""Per-sample CIDEr-D on the device, for SCST rewards.

Counterpart of ``image_captioning_ml_project_tpu.evaluate.cider_device``:
CIDEr-D (tf-idf n-gram cosine, n = 1..4, count clipping, length gaussian
sigma = 6, x10) in torch ops over **token ids**, so an SCST step's rewards
stay on the device and the host never waits for them.

Token-space note: rewards are computed over tokenizer ids (the standard
SCST practice) rather than PTB-normalised words; validation metrics still
use the host scorers of :mod:`.metrics`.

Flow:
* :func:`build_df_table` -- host, once per training corpus: document
  frequencies of hashed n-grams -> sorted hash tables and idf payloads,
  tensors on the trainer's device.
* :func:`encode_references` -- host, per batch (numpy): reference token
  arrays [B, R, L] and their validity mask.
* :func:`per_sample_cider_device` -- device: candidate tokens [B, L] ->
  rewards [B]. Nothing in it reads a value back to the host.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..ops.ngram import lookup_sorted, ngram_hashes, ngram_hashes_np

MAX_N = 4
SIGMA = 6.0


class DFTable(NamedTuple):
    """Sorted hash -> idf lookup, one per n-gram order."""

    tables: Tuple[torch.Tensor, ...]   # each [M_n] sorted int64 hashes
    idfs: Tuple[torch.Tensor, ...]     # each [M_n] float32
    log_n: float                       # log(number of reference images)


def _strip(tokens: Sequence[int], special_ids) -> np.ndarray:
    return np.asarray([t for t in tokens if t not in special_ids],
                      dtype=np.uint32)


def build_df_table(references: List[List[Sequence[int]]],
                   special_ids=(0, 1, 2), device="cpu") -> DFTable:
    """Host: document frequencies over a reference corpus, as tensors on
    ``device``. ``references[i]`` is the list of reference token sequences
    of image i."""
    log_n = float(np.log(max(len(references), 1)))
    tables, idfs = [], []
    for n in range(1, MAX_N + 1):
        df: Dict[int, float] = defaultdict(float)
        for refs in references:
            seen = set()
            for ref in refs:
                seen.update(ngram_hashes_np(_strip(ref, special_ids),
                                            n).tolist())
            for h in seen:
                df[h] += 1.0
        keys = np.array(sorted(df.keys()), dtype=np.int64)
        vals = np.array([log_n - np.log(max(df[int(k)], 1.0)) for k in keys],
                        dtype=np.float32)
        tables.append(torch.from_numpy(keys).to(device))
        idfs.append(torch.from_numpy(vals).to(device))
    return DFTable(tuple(tables), tuple(idfs), log_n)


def encode_references(refs_per_image: List[List[Sequence[int]]],
                      max_refs: int, max_len: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Host: pack per-image reference token lists into fixed arrays.

    Returns (tokens [B, R, L] int32 -- entries beyond a reference's length
    are **-1**, which no tokenizer emits, so a real token id 0 is never
    taken for packing -- and ref_valid [B, R] bool). Special tokens are
    stripped on the device (:func:`per_sample_cider_device`'s
    ``special_ids``)."""
    B = len(refs_per_image)
    tokens = np.full((B, max_refs, max_len), -1, dtype=np.int32)
    ref_valid = np.zeros((B, max_refs), dtype=bool)
    for i, refs in enumerate(refs_per_image):
        for r, ref in enumerate(refs[:max_refs]):
            arr = np.asarray(list(ref)[:max_len], dtype=np.int32)
            tokens[i, r, : len(arr)] = arr
            ref_valid[i, r] = True
    return tokens, ref_valid


def _token_valid(tokens: torch.Tensor, special_ids) -> torch.Tensor:
    valid = torch.ones(tokens.shape, dtype=torch.bool, device=tokens.device)
    for s in special_ids:
        valid = valid & (tokens != s)
    return valid


def _tf(hashes: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Term frequency of each window's hash within its own sequence:
    hashes [..., L] -> counts [..., L] float32 (0 where invalid)."""
    eq = hashes[..., :, None] == hashes[..., None, :]
    eq = eq & valid[..., None, :] & valid[..., :, None]
    return eq.sum(dim=-1).to(torch.float32)


def per_sample_cider_device(cand_tokens: torch.Tensor,
                            ref_tokens: torch.Tensor,
                            ref_valid: torch.Tensor,
                            df: DFTable,
                            special_ids=(0, 1, 2)) -> torch.Tensor:
    """Device CIDEr-D: cand [B, L], refs [B, R, Lr] (+ ref_valid [B, R])
    -> rewards [B] float32, on the candidates' device."""
    cand_valid = _token_valid(cand_tokens, special_ids)
    # the packing sentinel is -1 (encode_references); token id 0 can be a
    # real word and counts
    refs_tok_valid = _token_valid(ref_tokens, special_ids) & (ref_tokens >= 0)
    cand_len = cand_valid.sum(dim=-1).to(torch.float32)              # [B]
    ref_len = refs_tok_valid.sum(dim=-1).to(torch.float32)           # [B, R]
    n_refs = ref_valid.sum(dim=-1).clamp_min(1).to(torch.float32)    # [B]

    score_n = []
    for n in range(1, MAX_N + 1):
        table, idf = df.tables[n - 1], df.idfs[n - 1]
        ch, cv = ngram_hashes(cand_tokens, n, cand_valid)            # [B, L]
        rh, rv = ngram_hashes(ref_tokens, n, refs_tok_valid)         # [B, R, Lr]
        rv = rv & ref_valid[..., None]

        # an unseen n-gram counts as df = 1
        c_idf = lookup_sorted(table, ch, df.log_n, idf) * cv
        r_idf = lookup_sorted(table, rh, df.log_n, idf) * rv

        c_tf_raw, r_tf_raw = _tf(ch, cv), _tf(rh, rv)
        c_w = c_tf_raw * c_idf           # tf * idf per window
        r_w = r_tf_raw * r_idf

        # norms count each distinct n-gram once: divide by its multiplicity
        c_tf = c_tf_raw.clamp_min(1.0)
        r_tf = r_tf_raw.clamp_min(1.0)
        c_norm = (c_w * c_w / c_tf).sum(dim=-1).sqrt()               # [B]
        r_norm = (r_w * r_w / r_tf).sum(dim=-1).sqrt()               # [B, R]

        # min(cand_w, ref_w) * ref_w for each candidate window matched in
        # a reference: [B, R, L, Lr]
        match = ch[:, None, :, None] == rh[:, :, None, :]
        match = match & cv[:, None, :, None] & rv[:, :, None, :]
        # the reference weight of the candidate window's n-gram (0 if
        # unmatched)
        r_w_for_c = torch.where(match, r_w[:, :, None, :],
                                torch.zeros((), device=r_w.device)
                                ).amax(dim=-1)                       # [B, R, L]
        contrib = torch.minimum(c_w[:, None, :], r_w_for_c) * r_w_for_c \
            / c_tf[:, None, :]
        val = contrib.sum(dim=-1)                                    # [B, R]

        val = val / (c_norm[:, None] * r_norm).clamp_min(1e-8)
        delta = cand_len[:, None] - ref_len
        val = val * torch.exp(-(delta ** 2) / (2 * SIGMA ** 2))
        val = torch.where(ref_valid, val, torch.zeros((), device=val.device))
        score_n.append(val.sum(dim=-1) / n_refs)                     # [B]

    return 10.0 * torch.stack(score_n, dim=0).mean(dim=0)
