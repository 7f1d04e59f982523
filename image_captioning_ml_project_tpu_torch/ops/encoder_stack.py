"""Whole-stack CLIP vision encoder: the hand-written CUDA kernel and its
plain PyTorch version.

Counterpart of ``image_captioning_ml_project_tpu.ops.pallas_encoder.
fused_encoder_stack`` (the Pallas TPU kernel). All L pre-LN encoder layers
over x [B, T, H]: per layer, LN1 -> QKV -> multi-head self-attention over
the T tokens -> output projection -> residual -> LN2 -> fc1 -> quick_gelu
(sigmoid in f32) -> fc2 -> residual, with the JAX package's rounding
(:mod:`.numerics`). The token axis is not padded: the JAX kernel pads it to
a 16-row tile for the TPU and masks the padded keys; here no padded key or
row exists.

Inference only: the wrapper raises when autograd would need a gradient
through it (the Pallas kernel has no VJP either).

:func:`encoder_stack` dispatches on the tensor's device: a CPU tensor takes
:func:`encoder_stack_plain`; a CUDA tensor launches
``csrc/encoder_stack.cu`` (one host call: seven launches per layer; see
the note there) or raises.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict

import torch

from ._build import load_library
from ._checks import (DTYPES, STACK_KEYS, check_dtype, check_no_grad,
                      check_stack, check_tensor, check_widths,
                      current_stream, scratch_buffer)
from .numerics import dense, layer_norm, quick_gelu_f32


def encoder_stack_plain(x: torch.Tensor, stack: Dict[str, torch.Tensor], *,
                        num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of the kernel, layer by layer with the same
    numerics: f32 scores times the scale, f32 softmax, weights rounded to
    the working dtype, f32 mix rounded to the working dtype."""
    B, T, H = x.shape
    nh = num_heads
    hd = H // nh
    scale = float(1.0 / hd ** 0.5)
    w = stack
    for li in range(w["wqkv"].shape[0]):
        h = layer_norm(x, w["g1"][li], w["b1"][li], eps)
        q, k, v = (t.reshape(B, T, nh, hd).transpose(1, 2) for t in dense(
            h, w["wqkv"][li], w["bqkv"][li]).split(H, dim=-1))
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        p = torch.softmax(s, dim=-1).to(x.dtype)
        att = torch.matmul(p.float(), v.float()).to(x.dtype)
        att = att.transpose(1, 2).reshape(B, T, H)
        x = x + dense(att, w["wo"][li], w["bo"][li])
        h = layer_norm(x, w["g2"][li], w["b2"][li], eps)
        u = quick_gelu_f32(dense(h, w["wfc"][li], w["bfc"][li]))
        x = x + dense(u, w["wpj"][li], w["bpj"][li])
    return x


def _check(x, stack, num_heads):
    check_dtype("encoder_stack", x)
    if x.dim() != 3:
        raise ValueError(f"expected x [B, T, H], got {tuple(x.shape)}")
    B, T, H = x.shape
    check_widths("encoder_stack", H, num_heads)
    check_tensor("x", x, x.shape, x.dtype, x.device, aligned=True)
    L, F = stack["wfc"].shape[0], stack["wfc"].shape[1]
    check_stack(stack, L, H, F, x.dtype, x.device)
    if F % 8:
        raise ValueError(f"encoder_stack kernel needs an MLP width that is a"
                         f" multiple of 8, got {F}")
    smem = 4 * (3 * T * (H // num_heads + 1) + T * T)
    if smem > 227 * 1024:
        raise ValueError(f"{T} tokens need {smem} bytes of shared memory per"
                         f" attention block, above the card's 227 KB")
    return L, F


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The library's C entry point, built and typed once per process."""
    fn = load_library("encoder_stack").encoder_stack
    fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 15
                   + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(x, stack, num_heads, eps):
    L, F = _check(x, stack, num_heads)
    fn = _kernel_fn()
    B, T, H = x.shape
    out = torch.empty_like(x)
    stream = current_stream(x.device)
    scratch = scratch_buffer("encoder_stack", (B * T, 6 * H + F), x.dtype,
                             x.device, stream)
    err = fn(DTYPES[x.dtype], x.device.index, out.data_ptr(),
             scratch.data_ptr(), x.data_ptr(),
             *(stack[k].data_ptr() for k in STACK_KEYS),
             L, B, T, H, num_heads, F,
             float(1.0 / (H // num_heads) ** 0.5), float(eps), stream)
    if err != 0:
        raise RuntimeError(f"encoder_stack kernel launch failed: cudaError "
                           f"{err}")
    # the serving batcher and, for the reranker's vision tower, the
    # completer thread both launch it
    with _count_lock:
        encoder_stack.launches += 1
    return out


_count_lock = threading.Lock()


def encoder_stack(x: torch.Tensor, stack: Dict[str, torch.Tensor], *,
                  num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """All encoder layers over x [B, T, H] (after the pre-layernorm).

    ``stack`` holds the layer-stacked weights
    (:func:`..params.stack_layer_weights`: wqkv [L, 3H, H], bqkv [L, 3H],
    wo [L, H, H], bo [L, H], the LayerNorm scales and biases g1, b1, g2, b2
    [L, H] in float32, wfc [L, F, H], bfc [L, F], wpj [L, H, F], bpj
    [L, H]). Returns the last layer's hidden states [B, T, H]. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel
    (counted once per call in ``encoder_stack.launches``) or raises.
    """
    check_no_grad("encoder_stack", x, *stack.values())
    if x.device.type == "cuda":
        return _launch(x, stack, num_heads, eps)
    if x.device.type == "cpu":
        return encoder_stack_plain(x, stack, num_heads=num_heads, eps=eps)
    raise ValueError(f"encoder_stack has no kernel for {x.device}")


encoder_stack.launches = 0
