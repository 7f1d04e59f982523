"""Image preprocessing of the served path, in PyTorch.

Counterpart of the image half of ``image_captioning_ml_project_tpu.data.
coco``: images leave the host as uint8 NHWC, resized and center-cropped
there (:func:`center_crop_resize`, PIL), and are normalised with the
ImageNet constants on their device (:func:`normalize_images`).
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(images_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> float32 NHWC, ``(x / 255 - mean) / std`` on the
    images' device."""
    x = images_uint8.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


def center_crop_resize(img, size: int):
    """Resize a PIL image's shorter side to ``size`` (bilinear), then crop
    the ``size`` x ``size`` center. PIL is imported here: the serving
    machine may lack it, and only encoded-bytes requests need it."""
    from PIL import Image

    W, H = img.size
    scale = size / min(W, H)
    img = img.resize((max(size, int(round(W * scale))),
                      max(size, int(round(H * scale)))), Image.BILINEAR)
    W, H = img.size
    left = (W - size) // 2
    top = (H - size) // 2
    return img.crop((left, top, left + size, top + size))
