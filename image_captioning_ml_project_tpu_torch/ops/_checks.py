"""What the port's CUDA wrappers check before a launch: every operand on
the kernel's device, in its dtype, of its shape, contiguous, and 16-byte
aligned where a kernel reads it in 16-byte pieces (the tensor-core GEMM
through TMA and in its epilogue, the LayerNorm). Anything
else raises; nothing is copied or converted to make it fit."""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import torch

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the shapes of a layer-stacked weight set (params.stack_layer_weights) for
# width H and MLP width F: matrices in the nn.Linear layout [out, in]
STACK_KEYS = ("wqkv", "bqkv", "wo", "bo", "g1", "b1", "g2", "b2",
              "wfc", "bfc", "wpj", "bpj")
LN_KEYS = ("g1", "b1", "g2", "b2")  # float32 whatever the working dtype


def current_stream(device: torch.device) -> int:
    """The handle of ``device``'s current CUDA stream, read without
    building a ``torch.cuda.Stream`` object: a decode step's host time is
    most of the step (PERF.md, section 5), and every wrapper reads it."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check_dtype(what: str, x: torch.Tensor) -> None:
    if x.dtype not in DTYPES:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")


def check_no_grad(what: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise where autograd would need a gradient through a kernel: none of
    them has a backward (the Pallas kernels have no VJP either)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what} is inference only: it has no backward "
                           f"(run it under torch.no_grad() or "
                           f"torch.inference_mode())")


def check_tensor(name: str, t: torch.Tensor, shape: Tuple[int, ...],
                 dtype: torch.dtype, device: torch.device,
                 aligned: bool = False) -> None:
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype} on {t.device}; expected "
                         f"{dtype} on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def stack_shapes(L: int, H: int, F: int) -> Dict[str, Tuple[int, ...]]:
    return {"wqkv": (L, 3 * H, H), "bqkv": (L, 3 * H), "wo": (L, H, H),
            "bo": (L, H), "g1": (L, H), "b1": (L, H), "g2": (L, H),
            "b2": (L, H), "wfc": (L, F, H), "bfc": (L, F), "wpj": (L, H, F),
            "bpj": (L, H)}


def check_stack(stack: Dict[str, torch.Tensor], L: int, H: int, F: int,
                dtype: torch.dtype, device: torch.device) -> None:
    """The layer-stacked weights: matrices and biases in ``dtype``, the
    LayerNorm scales and biases (g1, b1, g2, b2) in float32."""
    if set(stack) != set(STACK_KEYS):
        raise ValueError(f"stacked weights need the keys {STACK_KEYS}, got "
                         f"{sorted(stack)}")
    for name, shape in stack_shapes(L, H, F).items():
        want = torch.float32 if name in LN_KEYS else dtype
        check_tensor(name, stack[name], shape, want, device, aligned=True)


def check_widths(what: str, H: int, num_heads: int) -> None:
    """The tensor-core GEMM reads and writes rows in 8-value (16-byte)
    chunks."""
    if num_heads < 1 or H % num_heads:
        raise ValueError(f"width {H} does not split into {num_heads} heads")
    if H % 8:
        raise ValueError(f"{what} kernel needs a width that is a multiple "
                         f"of 8, got {H}")


_scratch: Dict[tuple, torch.Tensor] = {}


def scratch_buffer(what: str, shape: Tuple[int, ...], dtype: torch.dtype,
                   device: torch.device, stream: int,
                   zero: bool = False) -> torch.Tensor:
    """A kernel's scratch tensor, kept per (kernel, shape, dtype, device,
    stream, host thread) instead of allocated at every call: the
    tensor-core GEMM (csrc/common.cuh) keeps one TMA descriptor per operand
    address, and a layer loop's operands live in the scratch, so a steady
    address means no descriptor is encoded after the first call. One
    thread's launches on one stream run in order, so its buffer is never
    shared by two calls in flight. With ``zero``, the buffer is zero when
    it is made (for counters that each launch leaves at zero)."""
    key = (what, tuple(shape), dtype, device, stream, threading.get_ident())
    buf = _scratch.get(key)
    if buf is None:
        make = torch.zeros if zero else torch.empty
        buf = _scratch[key] = make(shape, dtype=dtype, device=device)
    return buf


_words: Dict[tuple, torch.Tensor] = {}


def error_word(what: str, device: torch.device) -> torch.Tensor:
    """A kernel's error word on ``device``: one int32 in device memory, 0
    until a launch meets a fault that it reports there instead of stopping
    (kept per (kernel, device), as the scratch is). Made outside inference
    mode, so that it can be cleared anywhere."""
    device = torch.device(device)
    key = (what, device.type, device.index)
    word = _words.get(key)
    if word is None:
        with torch.inference_mode(False):
            word = _words[key] = torch.zeros(1, dtype=torch.int32,
                                             device=device)
    return word
