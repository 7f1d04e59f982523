"""Inference-time weight cast (counterpart of
``image_captioning_ml_project_tpu.utils.amp``).

Serving runs the model in bf16: the weights are cast once, before any
decode, rather than at every use. Norm-layer scale and bias stay f32,
because the layer norm computes its statistics and affine in f32 from them
(:class:`..models.layers.LayerNorm`, as flax's ``_normalize`` does); so do
a BatchNorm's scale and bias (:class:`..models.encoders.BatchNorm`), and
its running statistics, buffers, are never cast: the JAX policy keeps the
norm dicts and the ``batch_stats`` collection f32 alike.
"""

from __future__ import annotations

import torch
from torch import nn

from ..models.encoders import BatchNorm
from ..models.layers import LayerNorm


def cast_float_params(model: nn.Module,
                      dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Cast every float32 parameter of ``model`` to ``dtype`` in place,
    except those of :class:`LayerNorm` and :class:`BatchNorm` modules.
    Returns ``model``."""
    for module in model.modules():
        if isinstance(module, (LayerNorm, BatchNorm)):
            continue
        for p in module.parameters(recurse=False):
            if p.dtype == torch.float32:
                p.data = p.data.to(dtype)
    return model
