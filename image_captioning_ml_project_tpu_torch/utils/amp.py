"""Weight casts for bf16 compute (counterpart of
``image_captioning_ml_project_tpu.utils.amp``).

Serving runs the model in bf16: the weights are cast once, before any
decode, rather than at every use (:func:`cast_float_params`). Training
keeps f32 master weights and computes in bf16 from a differentiable cast
of them at each step (:func:`cast_for_compute`), as flax modules with
``dtype=bfloat16`` cast their f32 params at use: the gradients land on
the f32 masters. Either way norm-layer scale and bias stay f32, because
the layer norm computes its statistics and affine in f32 from them
(:class:`..models.layers.LayerNorm`, as flax's ``_normalize`` does); so do
a BatchNorm's scale and bias (:class:`..models.encoders.BatchNorm`), and
its running statistics, buffers, are never cast: the JAX policy keeps the
norm dicts and the ``batch_stats`` collection f32 alike. So do the
parameters the JAX policy keeps as raw f32 leaves (``_RAW_F32_LEAVES``):
Swin's ``relative_position_bias_table``, gathered and added to f32 scores,
and CLIP's ``logit_scale``.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from ..models.encoders import BatchNorm
from ..models.layers import LayerNorm

# parameters consumed at f32 whatever the compute dtype, by their name
_RAW_F32_LEAVES = frozenset({"logit_scale", "relative_position_bias_table"})


def castable_parameters(model: nn.Module) -> List[str]:
    """Names of ``model``'s float32 parameters outside :class:`LayerNorm`
    and :class:`BatchNorm` modules and the raw f32 leaves: the ones a bf16
    compute casts."""
    names = []
    for prefix, module in model.named_modules():
        if isinstance(module, (LayerNorm, BatchNorm)):
            continue
        for name, p in module.named_parameters(recurse=False):
            if p.dtype == torch.float32 and name not in _RAW_F32_LEAVES:
                names.append(f"{prefix}.{name}" if prefix else name)
    return names


def cast_float_params(model: nn.Module,
                      dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Cast every float32 parameter of ``model`` to ``dtype`` in place,
    except those of :class:`LayerNorm` and :class:`BatchNorm` modules and
    the raw f32 leaves.
    Returns ``model``."""
    for name in castable_parameters(model):
        p = model.get_parameter(name)
        p.data = p.data.to(dtype)
    return model


def cast_for_compute(model: nn.Module, names: List[str],
                     dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """``{name: parameter cast to dtype}`` for the parameters ``names``
    (:func:`castable_parameters`), each cast differentiable, so that a
    ``torch.func.functional_call`` of ``model`` with them computes in
    ``dtype`` and its gradients reach the f32 parameters."""
    return {name: model.get_parameter(name).to(dtype) for name in names}
