"""Curriculum learning: difficulty-ordered sampling with progressive pacing.
A copy of ``image_captioning_ml_project_tpu.train.curriculum`` (the same
index order from the same seed, epoch for epoch), carried here because the
port never imports the JAX package.

Behavioral parity with the reference sampler
(reference: src/train/curriculum.py:16-297): strategies caption_length /
num_objects / clip_score; epoch-progressive easy subset with a floor of
N/10 (:155-159); 10-bin within-bin shuffling (:164-177); random permutation
after ``warmup_epochs = min(5, num_epochs // 3)`` (:148-151, 293); the four
pacing functions (:199-267).

Host-side index permutation (ordering is inherently sequential) feeding the
fixed-shape batch iterator — the device pipeline is unchanged.
"""

from __future__ import annotations

import logging
from typing import Any, Iterable, List, Optional

import numpy as np


class CurriculumSampler:
    """Iterable of dataset indices, easy→hard with progressive inclusion."""

    def __init__(
        self,
        dataset,
        strategy: str = "caption_length",
        num_epochs: int = 15,
        warmup_epochs: int = 3,
        difficulty_scores: Optional[Iterable[float]] = None,
        shuffle_within_bins: bool = True,
        num_bins: int = 10,
        seed: int = 0,
        pacing: str = "linear",
    ):
        self.dataset = dataset
        self.strategy = strategy
        self.num_epochs = num_epochs
        self.warmup_epochs = warmup_epochs
        if not hasattr(PacingFunction, pacing):
            logging.getLogger(__name__).warning(
                "Unknown pacing '%s', falling back to linear", pacing)
            pacing = "linear"
        self.pacing = pacing
        self.shuffle_within_bins = shuffle_within_bins
        self.num_bins = num_bins
        self.current_epoch = 0
        self.rng = np.random.RandomState(seed)
        self.logger = logging.getLogger(__name__)

        if difficulty_scores is not None:
            self.difficulty_scores = np.asarray(list(difficulty_scores), dtype=np.float64)
        else:
            self.difficulty_scores = self._compute_difficulty_scores()
        self.sorted_indices = np.argsort(self.difficulty_scores, kind="stable")

    def _compute_difficulty_scores(self) -> np.ndarray:
        """reference: src/train/curriculum.py:69-129. Avoids the reference's
        per-sample __getitem__ sweep (which decodes every image) by using
        dataset metadata when available."""
        n = len(self.dataset)
        if self.strategy == "caption_length":
            if hasattr(self.dataset, "caption_lengths"):
                return self.dataset.caption_lengths().astype(np.float64)
            return np.full(n, 10.0)
        if self.strategy == "num_objects":
            if hasattr(self.dataset, "num_objects"):
                return np.asarray(self.dataset.num_objects(), dtype=np.float64)
            return np.full(n, 5.0)
        if self.strategy == "clip_score":
            if hasattr(self.dataset, "clip_scores"):
                s = np.asarray(self.dataset.clip_scores(), dtype=np.float64)
                return 1.0 / (s + 1e-8)
            return np.full(n, 1.0)
        self.logger.warning("Unknown strategy '%s', using neutral difficulty",
                            self.strategy)
        return np.arange(n, dtype=np.float64)

    def set_epoch(self, epoch: int):
        self.current_epoch = epoch

    def _num_included(self) -> int:
        # The reference hard-codes linear progress here (curriculum.py:155-159)
        # and leaves PacingFunction unwired; we wire it, defaulting to linear
        # which is value-identical to the reference's expression.
        progress = getattr(PacingFunction, self.pacing)(
            self.current_epoch, self.warmup_epochs)
        return max(int(progress * len(self.dataset)), len(self.dataset) // 10)

    def __iter__(self):
        n = len(self.dataset)
        if self.current_epoch >= self.warmup_epochs:
            return iter(self.rng.permutation(n).tolist())

        indices = self.sorted_indices[: self._num_included()].copy()
        if not self.shuffle_within_bins:
            # strict easy-to-hard order — a full shuffle here would be
            # MORE disorder than shuffle_within_bins=True, inverting the
            # flag's meaning
            return iter(indices.tolist())
        bin_size = len(indices) // self.num_bins
        if bin_size == 0:  # fewer items than bins: one bin, shuffle it
            self.rng.shuffle(indices)
            return iter(indices.tolist())
        out: List[int] = []
        for i in range(self.num_bins):
            start = i * bin_size
            end = start + bin_size if i < self.num_bins - 1 else len(indices)
            chunk = indices[start:end].copy()
            self.rng.shuffle(chunk)
            out.extend(chunk.tolist())
        return iter(out)

    def __len__(self):
        if self.current_epoch < self.warmup_epochs:
            return self._num_included()
        return len(self.dataset)


class PacingFunction:
    """reference: src/train/curriculum.py:199-267."""

    @staticmethod
    def linear(epoch: int, total_epochs: int) -> float:
        return min(1.0, (epoch + 1) / total_epochs)

    @staticmethod
    def root(epoch: int, total_epochs: int, power: float = 2.0) -> float:
        return min(1.0, ((epoch + 1) / total_epochs) ** (1.0 / power))

    @staticmethod
    def exponential(epoch: int, total_epochs: int, rate: float = 2.0) -> float:
        return min(1.0, ((epoch + 1) / total_epochs) ** rate)

    @staticmethod
    def step(epoch: int, total_epochs: int, num_steps: int = 3) -> float:
        progress = (epoch + 1) / total_epochs
        step_size = 1.0 / num_steps
        return min(1.0, (int(progress / step_size) + 1) * step_size)


def create_curriculum_sampler(dataset, config: Any,
                              difficulty_scores=None) -> Optional[CurriculumSampler]:
    """Factory (reference: src/train/curriculum.py:270-297)."""
    if not config.training.use_curriculum:
        return None
    return CurriculumSampler(
        dataset=dataset,
        strategy=config.training.curriculum_strategy,
        num_epochs=config.training.num_epochs,
        warmup_epochs=min(5, config.training.num_epochs // 3),
        difficulty_scores=difficulty_scores,
        shuffle_within_bins=True,
        num_bins=10,
        seed=config.seed,
        pacing=getattr(config.training, "curriculum_pacing", "linear"),
    )
