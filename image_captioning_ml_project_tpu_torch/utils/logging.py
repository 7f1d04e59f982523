"""Logging and metric accumulation: a copy of
``image_captioning_ml_project_tpu.utils.logging`` (console and
``training.log`` logging, running-average meters), held equal to it by the
tests."""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional


def setup_logging(output_dir: Optional[str] = None, name: str = "ic_tpu") -> logging.Logger:
    """Console + optional ``<output_dir>/training.log`` file logging
    (reference: src/train/trainer.py:100-108)."""
    handlers = [logging.StreamHandler()]
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        handlers.append(logging.FileHandler(os.path.join(output_dir, "training.log")))
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S",
        level=logging.INFO,
        handlers=handlers,
        force=True,
    )
    return logging.getLogger(name)


class AverageMeter:
    """Running average (reference: models/loss.py:1-10 ``loss_obj``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(1, self.count)


class MetricLogger:
    """Collects named AverageMeters for per-epoch loss component logging
    (reference: src/train/trainer.py:292-298 tqdm postfix components)."""

    def __init__(self):
        self.meters: Dict[str, AverageMeter] = {}

    def update(self, n: int = 1, **kwargs):
        for k, v in kwargs.items():
            self.meters.setdefault(k, AverageMeter()).update(float(v), n)

    def averages(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}

    def __str__(self):
        return ", ".join(f"{k}: {m.avg:.4f}" for k, m in self.meters.items())
