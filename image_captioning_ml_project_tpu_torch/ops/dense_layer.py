"""One ``nn.Dense`` layer with its epilogue, by itself: the tensor-core GEMM
of ``csrc/common.cuh`` and its plain PyTorch version.

No model path calls this: the layer kernels (:mod:`.beam_decode_stack`,
:mod:`.encoder_stack`, :mod:`.beam_decode_attention`) issue the same GEMM
from their own host loops. It exists so that the GEMM can be held against
:func:`..ops.numerics.dense` at any (M, N, K), on the card, by
``chip_smoke.py`` and the tests marked ``cuda``.

:func:`dense_layer` dispatches on the tensor's device: a CPU tensor takes
:func:`dense_layer_plain`; a CUDA tensor launches the GEMM or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ._build import load_library
from ._checks import (DTYPES, check_dtype, check_no_grad, check_tensor,
                      current_stream)
from .numerics import dense, gelu_new, quick_gelu_f32

# the epilogues of csrc/common.cuh (`Epilogue`), by name
EPILOGUES = {"bias": 0, "gelu_new": 1, "quick_gelu": 2, "residual": 3}


def dense_layer_plain(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor,
                      residual: Optional[torch.Tensor] = None,
                      epilogue: str = "bias") -> torch.Tensor:
    """``round(x @ weight^T) + bias`` in x's dtype, then the epilogue:
    ``gelu_new``, ``quick_gelu`` (sigmoid in f32) or ``residual + ...``,
    each rounded once."""
    y = dense(x, weight, bias)
    if epilogue == "gelu_new":
        return gelu_new(y)
    if epilogue == "quick_gelu":
        return quick_gelu_f32(y)
    if epilogue == "residual":
        return residual + y
    if epilogue != "bias":
        raise ValueError(f"epilogue must be one of {sorted(EPILOGUES)}, got "
                         f"{epilogue!r}")
    return y


def check_dense_layer(x, weight, bias, residual, epilogue):
    """Raise on anything the GEMM does not take: operands of one dtype on
    one device, contiguous, 16-byte aligned, N and K multiples of 8 (TMA
    wants 16-byte strides; the epilogue moves 16-byte vectors)."""
    check_dtype("dense_layer", x)
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {sorted(EPILOGUES)}, got "
                         f"{epilogue!r}")
    if x.dim() != 2 or weight.dim() != 2:
        raise ValueError(f"expected x [M, K] and weight [N, K], got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    (M, K), N = x.shape, weight.shape[0]
    if M < 1 or N % 8 or K % 8:
        raise ValueError(f"dense_layer kernel needs at least one row and N "
                         f"and K multiples of 8, got M={M} N={N} K={K}")
    check_tensor("x", x, (M, K), x.dtype, x.device, aligned=True)
    check_tensor("weight", weight, (N, K), x.dtype, x.device, aligned=True)
    check_tensor("bias", bias, (N,), x.dtype, x.device, aligned=True)
    if (residual is not None) != (epilogue == "residual"):
        raise ValueError("a residual goes with the 'residual' epilogue, and "
                         "only with it")
    if residual is not None:
        check_tensor("residual", residual, (M, N), x.dtype, x.device,
                     aligned=True)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = load_library("encoder_stack").dense_layer
    fn.argtypes = ([ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p, ctypes.c_int] * 3
                   + [ctypes.c_void_p, ctypes.c_void_p]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(x, weight, bias, residual, epilogue):
    check_dense_layer(x, weight, bias, residual, epilogue)
    fn = _kernel_fn()
    (M, K), N = x.shape, weight.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    stream = current_stream(x.device)
    err = fn(DTYPES[x.dtype], x.device.index, out.data_ptr(), N,
             x.data_ptr(), K, weight.data_ptr(), K, bias.data_ptr(),
             residual.data_ptr() if residual is not None else None, N, M, N,
             K, EPILOGUES[epilogue], stream)
    if err != 0:
        raise RuntimeError(f"dense_layer kernel launch failed: cudaError "
                           f"{err}")
    return out


def dense_layer(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                residual: Optional[torch.Tensor] = None,
                epilogue: str = "bias") -> torch.Tensor:
    """x [M, K], weight [N, K] (the ``nn.Linear`` layout), bias [N],
    residual [M, N] with ``epilogue="residual"``; returns [M, N]. A CPU
    tensor takes the plain version; a CUDA tensor launches the GEMM (bf16:
    ``wgmma`` fed by TMA; float32: the CUDA cores) or raises."""
    check_no_grad("dense_layer", x, weight, bias, residual)
    if x.device.type == "cuda":
        return _launch(x, weight, bias, residual, epilogue)
    if x.device.type == "cpu":
        return dense_layer_plain(x, weight, bias, residual, epilogue)
    raise ValueError(f"dense_layer has no kernel for {x.device}")
