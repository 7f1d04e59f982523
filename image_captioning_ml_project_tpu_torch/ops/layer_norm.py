"""LayerNorm as one op with its own backward: the hand-written CUDA kernels
of ``csrc/layer_norm.cu`` and their plain PyTorch version.

Every :class:`..models.layers.LayerNorm` runs :func:`layer_norm`, in eval
and in training. It replaces no TPU kernel: the JAX package leaves
LayerNorm to XLA, while in plain PyTorch its flax numerics
(:func:`.numerics.layer_norm`) are 14 launches forward and about 25 under
autograd, nearly each a full f32 pass over the activations. The note in
``csrc/layer_norm.cu`` gives the op's byte bound and its design.

:func:`layer_norm` dispatches on the input's device: a CPU tensor takes
:func:`.numerics.layer_norm`, differentiated by autograd; a CUDA tensor
launches the kernels or raises: the forward kernel (under autograd it
also keeps each row's mean and rstd) and :func:`layer_norm_backward`, one
kernel for dx and the partial sums of dgamma and dbeta, one that adds
those. :func:`layer_norm_plain` and :func:`layer_norm_backward_plain`
write out what the kernels compute (the forward bit for bit
:func:`.numerics.layer_norm`'s; the backward in one closed form, so its
rounding differs from autograd's), in float32, or float64 for float64
inputs: the card's tests and ``chip_smoke.py`` hold the kernels against
them, and the CPU tests run the autograd function over them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import numerics
from ._build import load_library
from ._checks import DTYPES, check_dtype, check_tensor, current_stream

# cudaErrorInvalidValue: what the C entries return for a width no row team
# holds (more than 1,024 16-byte chunks, or 1,024 values one at a time)
_INVALID_VALUE = 1


def _f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the plain versions' arithmetic type: float32, or float64
    for float64 inputs (so that ``gradcheck`` can hold them)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`.numerics.layer_norm` (y in x's dtype), and each row's
    statistics [..., 2]: the mean and rstd, rstd negative where the
    variance was clamped at 0 (the backward drops its term there)."""
    xf = _f32(x)
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    rstd = torch.rsqrt(var.clamp_min(0.0) + eps)
    y = ((xf - mu) * (rstd * _f32(weight)) + _f32(bias)).to(x.dtype)
    return y, torch.cat([mu, torch.where(var < 0, -rstd, rstd)], -1)


def layer_norm_backward_plain(dy: torch.Tensor, x: torch.Tensor,
                              stats: torch.Tensor, weight: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """dx (x's dtype), dgamma and dbeta of :func:`layer_norm_plain` as the
    kernel computes them, per row ``dx = rstd * (g dy - mean(g dy) - xhat
    * mean(g dy xhat))`` with the last term dropped where the variance was
    clamped; dgamma and dbeta summed over the rows."""
    xf, dyf = _f32(x), _f32(dy)
    mu, rstd = stats[..., :1], stats[..., 1:]
    r = rstd.abs()
    xhat = (xf - mu) * r
    gd = _f32(weight) * dyf
    mb = torch.where(rstd < 0, 0.0, (gd * xhat).mean(-1, keepdim=True))
    dx = (r * ((gd - gd.mean(-1, keepdim=True)) - xhat * mb)).to(x.dtype)
    H = x.shape[-1]
    return (dx, (dyf * xhat).reshape(-1, H).sum(0),
            dyf.reshape(-1, H).sum(0))


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    """The library's three C entry points, built and typed once."""
    lib = load_library("layer_norm")
    fwd, blocks, bwd = (lib.layer_norm_forward, lib.layer_norm_backward_blocks,
                        lib.layer_norm_backward)
    fwd.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                    + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int,
                                            ctypes.c_void_p])
    blocks.argtypes = [ctypes.c_int] * 5
    bwd.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 7
                    + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    for fn in (fwd, blocks, bwd):
        fn.restype = ctypes.c_int
    return fwd, blocks, bwd


@functools.lru_cache(maxsize=64)
def _backward_blocks(dtype: int, device: int, M: int, H: int,
                     vec: int) -> int:
    """The backward's blocks (rows of partial sums) for M rows of width H:
    what the card holds at once, fewer where the rows run out."""
    return _kernel_fns()[1](dtype, device, M, H, vec)


def _rows(x: torch.Tensor) -> Tuple[int, int]:
    H = x.shape[-1]
    return x.numel() // H, H


def _chunked(*tensors: torch.Tensor) -> bool:
    """Whether the kernels may move 16-byte chunks: the width a whole
    number of them and every operand on a 16-byte boundary."""
    H, item = tensors[0].shape[-1], tensors[0].element_size()
    return (H * item) % 16 == 0 and all(t.data_ptr() % 16 == 0
                                        for t in tensors)


def _check(x, *params):
    """x a CUDA tensor of the op's dtypes; each of ``params`` f32 [H]."""
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm has no kernel for {x.device}")
    check_dtype("layer_norm", x)
    check_tensor("x", x, x.shape, x.dtype, x.device)
    for name, p in zip(("weight", "bias"), params):
        check_tensor(name, p, x.shape[-1:], torch.float32, x.device)


def _raise(what, err, H):
    why = (f": no team of 32-256 threads holds a row of width {H} in four "
           f"chunks a thread" if err == _INVALID_VALUE else "")
    raise RuntimeError(f"{what} kernel launch failed: cudaError {err}{why}")


def _forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             eps: float, stats: bool):
    """y, and with ``stats`` the rows' statistics [..., 2] f32 (else None),
    of contiguous CUDA ``x``."""
    _check(x, weight, bias)
    M, H = _rows(x)
    y = torch.empty_like(x)
    st = (torch.empty(x.shape[:-1] + (2,), dtype=torch.float32,
                      device=x.device) if stats else None)
    if M:
        err = _kernel_fns()[0](
            DTYPES[x.dtype], x.device.index, y.data_ptr(),
            st.data_ptr() if stats else None, x.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), M, H, float(eps),
            int(_chunked(x, weight, bias)), current_stream(x.device))
        if err != 0:
            _raise("layer_norm", err, H)
        layer_norm.launches += 1
    return y, st


def layer_norm_backward(dy: torch.Tensor, x: torch.Tensor,
                        stats: torch.Tensor, weight: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dx, dgamma and dbeta of :func:`layer_norm` from the output's
    gradient ``dy``, the input ``x`` (contiguous), the forward's
    statistics and the scale, all on the card: launches the backward
    kernel and the reduction of its partial sums (counted once in
    ``layer_norm_backward.launches``) or raises."""
    dy = dy.contiguous()
    _check(x, weight)
    check_tensor("dy", dy, x.shape, x.dtype, x.device)
    check_tensor("stats", stats, x.shape[:-1] + (2,), torch.float32,
                 x.device)
    M, H = _rows(x)
    if not M:
        grads = torch.zeros(2, H, dtype=torch.float32, device=x.device)
        return torch.empty_like(x), grads[0], grads[1]
    dx = torch.empty_like(x)
    grads = torch.empty(2, H, dtype=torch.float32, device=x.device)
    dt, vec = DTYPES[x.dtype], int(_chunked(x, dy, weight))
    G = _backward_blocks(dt, x.device.index, M, H, vec)
    if G < 1:
        _raise("layer_norm_backward", _INVALID_VALUE, H)
    partial = torch.empty(G, 2, H, dtype=torch.float32, device=x.device)
    err = _kernel_fns()[2](
        dt, x.device.index, dx.data_ptr(), partial.data_ptr(),
        grads.data_ptr(), dy.data_ptr(), x.data_ptr(), stats.data_ptr(),
        weight.data_ptr(), M, H, G, vec, current_stream(x.device))
    if err != 0:
        _raise("layer_norm_backward", err, H)
    layer_norm_backward.launches += 1
    return dx, grads[0], grads[1]


class _LayerNorm(torch.autograd.Function):
    """The op under autograd: the forward keeps x, the scale and the rows'
    statistics; the backward is :func:`layer_norm_backward`."""

    @staticmethod
    def forward(x, weight, bias, eps):
        return _forward(x, weight, bias, eps, stats=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, weight, _, _ = inputs
        _, stats = output
        ctx.mark_non_differentiable(stats)
        ctx.save_for_backward(x, weight, stats)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, _):
        x, weight, stats = ctx.saved_tensors
        return (*layer_norm_backward(dy, x, stats, weight), None)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """flax ``LayerNorm`` of x [..., H] (float32 or bfloat16; any layout)
    with float32 ``weight`` and ``bias`` [H]; returns x's dtype and shape.
    Differentiable in x, weight and bias. A CPU tensor takes
    :func:`.numerics.layer_norm`; a CUDA tensor launches the kernels (the
    forward counted in ``layer_norm.launches``) or raises."""
    if x.device.type == "cpu":
        return numerics.layer_norm(x, weight, bias, eps)
    x = x.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _LayerNorm.apply(x, weight, bias, eps)[0]
    return _forward(x, weight, bias, eps, stats=False)[0]


layer_norm.launches = 0
layer_norm_backward.launches = 0
