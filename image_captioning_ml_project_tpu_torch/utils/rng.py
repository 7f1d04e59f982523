"""Seeded random streams for the port's host code.

Counterpart of ``image_captioning_ml_project_tpu.utils.rng``: where the
JAX package splits PRNG keys from one seed, this hands out seeds and
``torch.Generator`` objects from one seed, deterministically. The trainer
draws its dropout masks and its negatives from generators made here, so a
run is reproducible from ``config.seed`` alone, whatever else draws from
torch's global generator.
"""

from __future__ import annotations

from typing import List

import torch

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data`` (``jax.random.fold_in``'s
    role: the trainer folds the step into its dropout seed, so no two
    steps, resumed or not, share masks)."""
    return _splitmix64(_splitmix64(seed & _MASK64) ^ (data & _MASK64)) >> 1


def generator(seed: int, device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


class RngStream:
    """Deterministic stream of seeds, or of generators on ``device``, from
    a single seed. Holds Python state: use it in host-side code."""

    def __init__(self, seed: int, device="cpu"):
        self._seed = seed
        self._count = 0
        self.device = torch.device(device)

    def next_seed(self) -> int:
        self._count += 1
        return fold_in(self._seed, self._count)

    def next(self) -> torch.Generator:
        return generator(self.next_seed(), self.device)

    def next_n(self, n: int) -> List[torch.Generator]:
        return [self.next() for _ in range(n)]
