"""Layers shared by the port's models, and their dropout."""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional

import torch
from torch import nn

from ..ops.layer_norm import layer_norm

_rng = threading.local()
_routes = threading.local()
_data = threading.local()


@contextlib.contextmanager
def dropout_generator(generator: Optional[torch.Generator]
                      ) -> Iterator[None]:
    """Draw the dropout masks of the forwards run inside from
    ``generator`` (on the activations' device): the trainer's explicit
    stream, as the JAX trainer passes its ``"dropout"`` key. Per thread;
    outside it, masks come from torch's default generator."""
    before = getattr(_rng, "generator", None)
    _rng.generator = generator
    try:
        yield
    finally:
        _rng.generator = before


@contextlib.contextmanager
def plain_routes() -> Iterator[None]:
    """Run the forwards inside on plain torch ops in eval mode too: eval
    numerics (no dropout, BatchNorm on its running statistics) that
    autograd can differentiate, since the decode and encoder kernels have
    no backward (the LayerNorm op, which has one, runs here too). The
    trainer's REINFORCE forward runs inside it, as the JAX trainer
    differentiates ``apply(..., train=False)``. Per thread."""
    before = getattr(_routes, "plain", False)
    _routes.plain = True
    try:
        yield
    finally:
        _routes.plain = before


@contextlib.contextmanager
def data_parallel(group) -> Iterator[None]:
    """Run the forwards inside as one rank of the data axis's ``group``
    (None: alone): training-mode BatchNorm then takes its statistics over
    the global batch, every rank's rows, as a flax ``BatchNorm`` does on a
    batch sharded over the mesh. Per thread."""
    before = getattr(_data, "group", None)
    _data.group = group
    try:
        yield
    finally:
        _data.group = before


def data_group():
    """The data axis's group of :func:`data_parallel`, or None."""
    return getattr(_data, "group", None)


def kernels_on(module: nn.Module) -> bool:
    """Whether ``module``'s forward takes its route through a kernel that
    has no backward: in eval mode, outside :func:`plain_routes`. Decided
    before any kernel is called. :class:`LayerNorm` does not ask: its op
    has a backward and runs in every mode."""
    return not module.training and not getattr(_routes, "plain", False)


def dropout(x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    """``flax.linen.Dropout``: in training, keep each entry with
    probability ``1 - rate`` and scale the kept ones by ``1 / (1 - rate)``
    (in ``x``'s dtype); the identity at rate 0 or outside training."""
    if not training or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    if keep_prob == 0.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, device=x.device,
                      generator=getattr(_rng, "generator", None)) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm`` numerics: f32 statistics whatever the input
    dtype (mean and mean of squares, variance clipped at 0), the scale
    folded into the rsqrt multiplier, f32 scale and bias, result cast back
    to the input dtype. Its parameters stay f32 under
    :func:`..utils.amp.cast_float_params`, as flax keeps them. Runs
    :func:`..ops.layer_norm.layer_norm` in every mode: on the card its
    kernels, forward and backward."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)
