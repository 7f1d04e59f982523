"""Image resizes on the device: the cubic resize of the CLIP reranker and
the antialiased bilinear resize of the device-resident eval preprocessing.

**Cubic**, with ``jax.image.resize(..., "cubic")``'s arithmetic.

The CLIP reranker resizes the served images to the CLIP checkpoint's size
on their device. The JAX package does it with ``jax.image.resize`` and
method ``"cubic"``: the Keys cubic kernel with a = -0.5, widened by the
scale when it shrinks (antialiased), each output pixel's weights
normalised to sum to 1 and zero where the sample falls outside the input.
That is one ``[in, out]`` weight matrix per spatial axis and two matrix
products, plain XLA there and plain torch here (no kernel of the JAX
package is involved). ``torch.nn.functional.interpolate(mode="bicubic")``
is not the same function: its kernel has a = -0.75 and its antialiasing
normalises otherwise.

**Bilinear from a canvas** (:func:`resize_square`, :func:`resize_normalize`),
the JAX package's ``ops/resize.py``: with ``device_resize`` the host only
decodes each image's centre square onto a fixed ``[C, C, 3]`` uint8
canvas, top-left, and gives its side ``s``; the card resizes. The filter
is PIL's antialiased triangle: per image one ``[out, C]`` weight matrix
from ``arange`` and ``s`` (support widened by the downscale factor,
columns at ``i >= s`` zeroed, each row divided by ``max(sum, 1e-8)``),
applied to the rows and then to the columns. The batch is two
``einsum``s over ``[B, out, C]`` weights, plain torch ops (the JAX
package has no Pallas kernel here either).
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.coco import IMAGENET_MEAN, IMAGENET_STD


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel (a = -0.5) at distances ``x`` >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def cubic_weights(in_size: int, out_size: int) -> torch.Tensor:
    """The float32 ``[in_size, out_size]`` weights taking an axis of
    ``in_size`` pixels to ``out_size`` (half-pixel centres), computed as
    JAX's ``compute_weight_mat`` computes them for a resize: the inverse
    scale in double precision, everything else in float32."""
    f32 = torch.float32
    inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=f32)
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    sample_f = (torch.arange(out_size, dtype=f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32)[:, None]).abs() \
        / kernel_scale
    weights = _keys_cubic(x)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def resize_cubic(images: torch.Tensor, size: int) -> torch.Tensor:
    """Float NHWC ``images`` resized to ``size`` x ``size`` on their device:
    the height and the width each through one product with its
    :func:`cubic_weights` (an axis already of that size is left as it is,
    as JAX leaves it)."""
    _, H, W, _ = images.shape
    x = images
    if W != size:
        x = torch.einsum("bhwc,wv->bhvc", x,
                         cubic_weights(W, size).to(x.device, x.dtype))
    if H != size:
        x = torch.einsum("bhwc,hu->buwc", x,
                         cubic_weights(H, size).to(x.device, x.dtype))
    return x


def _resize_weights(sizes: torch.Tensor, canvas: int,
                    out_size: int) -> torch.Tensor:
    """float32 ``[B, out_size, canvas]`` triangle-filter weights for
    sources occupying ``[0, sizes[b])`` of the canvas axis."""
    f32 = torch.float32
    s = sizes.to(f32)[:, None, None]                            # [B, 1, 1]
    scale = s / out_size
    fscale = torch.clamp_min(scale, 1.0)   # antialias support when shrinking
    o = torch.arange(out_size, dtype=f32, device=sizes.device)[:, None]
    i = torch.arange(canvas, dtype=f32, device=sizes.device)[None, :]
    center = (o + 0.5) * scale
    w = torch.clamp_min(1.0 - ((i + 0.5 - center) / fscale).abs(), 0.0)
    w = torch.where(i < s, w, torch.zeros((), dtype=f32, device=w.device))
    return w / torch.clamp_min(w.sum(dim=2, keepdim=True), 1e-8)


def resize_square(canvas_images: torch.Tensor, sizes: torch.Tensor,
                  out_size: int) -> torch.Tensor:
    """Each image's top-left ``sizes[b] x sizes[b]`` square of a
    ``[B, C, C, 3]`` uint8 canvas resized to ``[B, out, out, 3]`` float32
    (0-255) on the canvas's device: the rows, then the columns."""
    C = canvas_images.shape[1]
    w = _resize_weights(sizes.to(canvas_images.device), C, out_size)
    x = canvas_images.to(torch.float32)
    t = torch.einsum("boi,bijc->bojc", w, x)                    # rows
    return torch.einsum("bpj,bojc->bopc", w, t)                 # columns


def resize_normalize(canvas_images: torch.Tensor, sizes: torch.Tensor,
                     out_size: int) -> torch.Tensor:
    """The device-resident eval preprocessing: :func:`resize_square`, then
    the ImageNet normalisation ``(x / 255 - mean) / std``."""
    x = resize_square(canvas_images, sizes, out_size) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std
