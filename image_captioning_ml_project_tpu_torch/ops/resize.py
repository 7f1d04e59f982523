"""Cubic image resize with ``jax.image.resize(..., "cubic")``'s arithmetic.

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
"""

from __future__ import annotations

import numpy as np
import torch


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
