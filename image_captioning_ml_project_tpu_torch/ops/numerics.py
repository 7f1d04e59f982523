"""The JAX package's numerics, spelled in plain PyTorch.

The plain versions of the fused kernels are built from these, so that each
rounding the JAX kernels make is written out once:

* :func:`dense` is flax ``nn.Dense``: the f32-accumulated product is
  rounded to the working dtype and the bias is then added in that dtype
  (``F.linear`` on CUDA instead adds the bias in f32 and rounds once);
* :func:`layer_norm` is flax ``LayerNorm`` (``_normalize``): f32 mean and
  mean of squares, variance clipped at 0, the scale folded into the rsqrt
  multiplier, f32 scale and bias, the result cast back;
* :func:`gelu_new` (GPT-2's MLP) and :func:`quick_gelu_f32` (the CLIP
  encoder fold) take working-dtype inputs, compute in f32 and round once.

In float32 every rounding is the identity.
"""

from __future__ import annotations

import numpy as np
import torch

_SQRT_2_OVER_PI = float(np.float32(np.sqrt(2 / np.pi)))


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: torch.Tensor) -> torch.Tensor:
    """``nn.Dense`` on x [..., in] with an ``nn.Linear``-layout weight
    [out, in]: ``round(x @ weight^T) + bias``, both in x's dtype."""
    return torch.matmul(x, weight.t()) + bias


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    mul = torch.rsqrt(var + eps) * weight.float()
    return ((xf - mu) * mul + bias.float()).to(x.dtype)


def gelu_new(y: torch.Tensor) -> torch.Tensor:
    """HF ``gelu_new`` as ``jax.nn.gelu(approximate=True)`` spells it."""
    yf = y.float()
    cdf = 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI
                                  * (yf + 0.044715 * yf ** 3)))
    return (yf * cdf).to(y.dtype)


def quick_gelu_f32(y: torch.Tensor) -> torch.Tensor:
    """CLIP's ``x * sigmoid(1.702 x)`` with the sigmoid in f32, as the
    Pallas encoder kernel runs it on the TPU."""
    yf = y.float()
    return (yf * torch.sigmoid(1.702 * yf)).to(y.dtype)
