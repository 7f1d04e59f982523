"""Synthetic tiny-COCO fixture generator: a copy of
``image_captioning_ml_project_tpu.data.synthetic``, held equal to it by the
tests.

Creates a directory tree matching the COCO captions schema (``images``
with id/file_name and ``annotations`` with image_id/caption) — a few
random images plus captions JSON — for the tests and for ``chip_smoke.py``
where no real dataset is mounted.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

_WORDS = (
    "a the big small red blue young old man woman dog cat bird horse "
    "riding sitting standing walking running on in near under over "
    "street park beach field table chair grass snow water sky tree "
    "holding wearing eating playing with and while two three group"
).split()


def make_synthetic_coco(
    root: str,
    num_images: int = 8,
    captions_per_image: int = 5,
    image_size: int = 64,
    splits: Optional[List[str]] = None,
    seed: int = 0,
    image_format: str = "png",
    size_jitter: int = 0,
) -> str:
    """Build a tiny COCO-style dataset under ``root``; returns ``root``.

    Layout mirrors the reference Config defaults (src/config.py:134-138):
    ``annotations/captions_{split}2014.json`` + ``{split}2014/`` image dirs.
    """
    from PIL import Image

    rng = np.random.RandomState(seed)
    splits = splits or ["train", "val"]
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    for split in splits:
        img_dir = os.path.join(root, f"{split}2014")
        os.makedirs(img_dir, exist_ok=True)
        images, annotations = [], []
        ann_id = 1
        for i in range(num_images):
            image_id = (0 if split == "train" else 10_000) + i + 1
            fname = f"COCO_{split}2014_{image_id:012d}.{image_format}"
            h = image_size + (rng.randint(0, size_jitter + 1)
                              if size_jitter else 0)
            w = image_size + (rng.randint(0, size_jitter + 1)
                              if size_jitter else 0)
            arr = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
            Image.fromarray(arr).save(os.path.join(img_dir, fname))
            images.append({"id": image_id, "file_name": fname,
                           "height": h, "width": w})
            for _ in range(captions_per_image):
                n = rng.randint(4, 12)
                caption = " ".join(rng.choice(_WORDS, size=n))
                annotations.append({"id": ann_id, "image_id": image_id,
                                    "caption": caption})
                ann_id += 1
        with open(os.path.join(root, "annotations",
                               f"captions_{split}2014.json"), "w") as f:
            json.dump({"images": images, "annotations": annotations}, f)
    return root


def make_synthetic_object_features(
    root: str,
    annotation_file: str,
    max_objects: int = 12,
    feature_dim: int = 64,
    seed: int = 0,
    min_objects: int = 3,
) -> str:
    """Write ``{image_id}.npz`` detector-feature files (features/boxes) for
    every image in ``annotation_file`` (reference feature layout:
    src/data/dataset.py:280-306), with ``min_objects`` to ``max_objects``
    regions each (the JAX package's copy draws from 3)."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    with open(annotation_file) as f:
        ann = json.load(f)
    for img in ann["images"]:
        n = rng.randint(min_objects, max_objects + 1)
        np.savez(
            os.path.join(root, f"{img['id']}.npz"),
            features=rng.randn(n, feature_dim).astype(np.float32),
            boxes=rng.rand(n, 4).astype(np.float32),
        )
    return root
