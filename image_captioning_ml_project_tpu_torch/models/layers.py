"""Layers shared by the port's models."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.numerics import layer_norm


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm`` numerics: f32 statistics whatever the input
    dtype (mean and mean of squares, variance clipped at 0), the scale
    folded into the rsqrt multiplier, f32 scale and bias, result cast back
    to the input dtype. Its parameters stay f32 under
    :func:`..utils.amp.cast_float_params`, as flax keeps them."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)
