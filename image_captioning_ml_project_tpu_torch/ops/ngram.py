"""N-gram hashing over token ids, on the host (numpy) and on the device.

Counterpart of ``image_captioning_ml_project_tpu.ops.ngram``: the SCST
reward path scores captions by CIDEr on the device, so token sequences map
to rolling polynomial hashes (uint32, multiplier 1000003, one added to each
token), computed on the host when the document-frequency tables are built
and on the device for the candidates and references, bit-equal on both.

torch's uint32 support is partial, so the device hash computes in int64
and keeps the low 32 bits after each multiply-add: ``h < 2**32`` and
:data:`HASH_MULT` ``< 2**20``, so the product fits. A ``-1`` token (the
references' packing sentinel) becomes ``0xFFFFFFFF`` as the JAX package's
uint32 cast makes it, so the hashes equal JAX's for every window, valid or
not. Plain torch ops: no kernel.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

HASH_MULT = np.uint32(1000003)
_MASK32 = 0xFFFFFFFF


def ngram_hashes_np(tokens: np.ndarray, n: int) -> np.ndarray:
    """Host-side hash of all n-grams of a 1-D token array (uint32)."""
    tokens = np.asarray(tokens, dtype=np.uint32)
    if len(tokens) < n:
        return np.zeros((0,), dtype=np.uint32)
    h = np.zeros(len(tokens) - n + 1, dtype=np.uint32)
    with np.errstate(over="ignore"):
        for i in range(n):
            h = h * HASH_MULT + tokens[i: len(tokens) - n + 1 + i] \
                + np.uint32(1)
    return h


def ngram_hashes(tokens: torch.Tensor, n: int, valid: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device-side n-gram hashes over the time axis.

    tokens [..., L] integer; valid [..., L] bool marks real (non-special)
    tokens. Returns (hashes [..., L] int64 in ``[0, 2**32)``, window_valid
    [..., L]) where position i hashes tokens[i:i+n] (wrapping around the
    end, as ``jnp.roll`` does); windows that run past the end or contain
    any invalid token are masked False."""
    L = tokens.shape[-1]
    t = tokens.to(torch.int64) & _MASK32
    h = torch.zeros_like(t)
    w_valid = torch.ones(tokens.shape, dtype=torch.bool,
                         device=tokens.device)
    for i in range(n):
        shifted = torch.roll(t, -i, dims=-1)
        h = (h * int(HASH_MULT) + shifted + 1) & _MASK32
        w_valid = w_valid & torch.roll(valid, -i, dims=-1)
    # windows starting after L - n are out of range
    in_range = torch.arange(L, device=tokens.device) <= L - n
    return h, w_valid & in_range


def lookup_sorted(table: torch.Tensor, values: torch.Tensor,
                  default: float, payload: torch.Tensor) -> torch.Tensor:
    """Binary-search lookup: for each value, ``payload[j]`` where
    ``table[j] == value``, else ``default``. ``table`` is sorted int64."""
    if table.shape[0] == 0:
        # no reference reaches this n-gram order: every lookup misses
        return torch.full(values.shape, default, dtype=payload.dtype,
                          device=values.device)
    idx = torch.searchsorted(table, values.contiguous())
    idx = idx.clamp(0, table.shape[0] - 1)
    found = table[idx] == values
    return torch.where(found, payload[idx],
                       torch.full((), default, dtype=payload.dtype,
                                  device=values.device))
