"""How ``correct`` is decided: the served captions of a sample of the
window's requests, and the program's conditioning of their images, judged
by the plain reference (``reference/<config>.py``) on the same images and
weights.

Beam search keeps K beams, so each served token lies within the K best
of the reference's next-token distribution given the served tokens before
it (among the non-EOS tokens, or among all for an EOS, with EOS barred
below the minimum length). Its gap is how far the served token's
reference log-probability lies below that K-th best: at most 0 in exact
arithmetic, rounding where the program computes in bf16, more in fp8,
nats for an altered token or a row left undecoded. Two numbers are read:

* ``rank_gap_nats``: the widest gap;
* ``rank_gap_mean_nats``: the mean over the served tokens of the gap's
  positive part, which counts every violation, not only the widest.

The captions alone would let a fault before the decoder pass: with seeded
weights a caption depends little on its image. So the conditioning is
compared as well: after the window the program's own ``init_cache`` (the
entry each batch of the window starts with) runs once more at the cell's
batch, on the sample's first ``condition_sample`` distinct images, and
what it leaves for the decoder (``configs/<config>.py``'s
``program_condition``: the prefix K/V of every GPT-2 layer, or every
layer's cross-attention K/V of the memory) is held against the
reference's ``condition_kv`` of the same images:

* ``condition_gap``: by the worst image, the norm of the difference over
  the norm of the reference's.

A configuration compares the numbers its file gives a limit
(``correct["serve"]``, ``correct["train"]`` for a training cell); the
others are printed, not compared. Beside them, never
compared, ``caption_mismatch``: the share of the first
``mismatch_sample`` captions that differ from the reference's own beam
search. Near ties flip whole captions under bf16, so it does not separate
bf16 from fp8 by the factor a limit needs.

The control (:func:`control`) does not decode: at each position of the
program's served tokens it reads the tokens the reference in fp8 ranks
best, as the contract reads a served model's control.
"""

from __future__ import annotations

import importlib
from typing import Dict, Optional

import numpy as np
import torch

from .reference.common import NEG, Numerics, no_tf32


def reference(cfg: dict, state, precision: str = "f32"):
    mod = importlib.import_module(f"portbench.reference.{cfg['name']}")
    return mod.Reference(state, cfg, Numerics(precision))


def _barred(logits: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Float logits with EOS barred at the steps below the minimum length,
    as the search bars it (``logits`` [n, L-1, V], step 1 first)."""
    lg = logits.float().clone()
    steps = torch.arange(1, lg.shape[1] + 1, device=lg.device)
    lg[:, steps < cfg["decode"]["min_length"], cfg["ids"]["eos"]] = NEG
    return lg


def rank_gaps(logits: torch.Tensor, served: torch.Tensor, cfg: dict,
              tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per served position (up to and including the first EOS) the gap
    (nats) by which the served token's log-probability lies below the
    K-th best it could have been kept against; -inf elsewhere.
    ``logits`` [n, L-1, V] predict ``served[:, 1:]``. With ``tokens``
    [n, L-1, C], the gaps [n, L-1, C] of those tokens at each position
    instead of the served one's."""
    K, eos = cfg["decode"]["beam_size"], cfg["ids"]["eos"]
    logp = torch.log_softmax(_barred(logits, cfg), dim=-1)
    y = served[:, 1:, None] if tokens is None else tokens
    mine = logp.gather(2, y)
    kth_all = logp.topk(K, dim=-1).values[:, :, -1:]
    logp[:, :, eos] = NEG
    kth_word = logp.topk(K, dim=-1).values[:, :, -1:]
    kth = torch.where(y == eos, kth_all, kth_word)
    is_eos = (served[:, 1:] == eos).int()
    after = (is_eos.cumsum(1) - is_eos) > 0   # positions past the EOS
    gaps = (kth - mine).masked_fill(after[:, :, None], float("-inf"))
    return gaps[:, :, 0] if tokens is None else gaps


def _fold(acc, g: torch.Tensor):
    """A block's gaps folded into (widest, sum of the positive parts,
    positions judged)."""
    seen = ~torch.isinf(g)
    return (max(acc[0], g.max().item()),
            acc[1] + float(g[seen].clamp_min(0).sum()),
            acc[2] + int(seen.sum()))


def _gap_numbers(acc) -> Dict[str, float]:
    return {"rank_gap_nats": acc[0],
            "rank_gap_mean_nats": acc[1] / max(acc[2], 1)}


def numbers(cfg: dict, state, images: np.ndarray, served: np.ndarray,
            device, block: int = 16) -> Dict[str, float]:
    """The compared number of ``served`` [n, L] token rows for uint8
    ``images`` [n, size, size, 3], by the float32 reference, ``block``
    images at a time; and the mismatch share of the first
    ``correct["mismatch_sample"]`` (under ``"diagnostic"``)."""
    no_tf32()
    ref = reference(cfg, state)
    acc, differ, n = (float("-inf"), 0.0, 0), 0, len(served)
    m = min(n, cfg["correct"]["mismatch_sample"])
    with torch.no_grad():
        for lo in range(0, n, block):
            img = torch.from_numpy(images[lo:lo + block]).to(device)
            tok = torch.from_numpy(served[lo:lo + block]).to(device)
            acc = _fold(acc, rank_gaps(ref.teacher_logits(img, tok), tok,
                                       cfg))
            if lo < m:
                k = min(block, m - lo)
                best, _ = ref.beam(img[:k])
                differ += int((best != tok[:k]).any(1).sum())
    return dict(_gap_numbers(acc), diagnostic={
        "caption_mismatch": differ / max(m, 1), "captions_judged": n,
        "tokens_judged": acc[2]})


def reference_condition(cfg: dict, state, images: np.ndarray, device,
                        precision: str = "f32", block: int = 16
                        ) -> torch.Tensor:
    """The reference's ``condition_kv`` of uint8 ``images``, ``block`` at a
    time: [n, D] float32 on ``device``."""
    no_tf32()
    ref = reference(cfg, state, precision)
    with torch.no_grad():
        return torch.cat([ref.condition_kv(torch.from_numpy(
            images[lo:lo + block]).to(device))
            for lo in range(0, len(images), block)])


def condition_gaps(cfg: dict, state, images: np.ndarray,
                   side: torch.Tensor, device) -> Dict[str, float]:
    """``condition_gap`` (module docstring) of ``side`` [n, D], one
    side's conditioning of ``images``, against the float32 reference's."""
    r = reference_condition(cfg, state, images, device)
    p = side.to(device).float()
    return {"condition_gap": float(((p - r).norm(dim=1)
                                    / r.norm(dim=1)).max())}


def control(cfg: dict, state, images: np.ndarray, served: np.ndarray,
            device, block: int = 16) -> Dict[str, float]:
    """The control's numbers: the reference with its products in fp8 put
    in the program's place, without decoding. At each position of the
    same images and served tokens, each of the K tokens that fp8 ranks
    best (any of them a beam search in fp8 could keep there) is judged
    as a served token is, by the float32 reference: ``rank_gap_nats``
    the widest gap, ``rank_gap_mean_nats`` the mean over the positions of
    the positive part of each position's widest."""
    no_tf32()
    ref, low = reference(cfg, state), reference(cfg, state, "fp8")
    K = cfg["decode"]["beam_size"]
    acc = (float("-inf"), 0.0, 0)
    with torch.no_grad():
        for lo in range(0, len(served), block):
            img = torch.from_numpy(images[lo:lo + block]).to(device)
            tok = torch.from_numpy(served[lo:lo + block]).to(device)
            first = _barred(low.teacher_logits(img, tok), cfg).topk(
                K, dim=-1).indices
            acc = _fold(acc, rank_gaps(ref.teacher_logits(img, tok), tok,
                                       cfg, first).max(-1).values)
    return _gap_numbers(acc)


def judge(values: Dict[str, float], limits: Dict[str, Optional[float]]
          ) -> Dict[str, dict]:
    """Each number the configuration gives a limit, beside it; ``ok``
    where it is within. A number read and given no limit is not judged
    (the caller prints it); a limit whose number was not read fails."""
    out = {}
    for name, limit in limits.items():
        value = values.get(name)
        out[name] = {"value": value, "limit": limit,
                     "ok": value is not None and limit is not None
                     and value <= limit}
    return out
