"""What the port's CUDA wrappers check before a launch: every operand on
the kernel's device, in its dtype, of its shape, contiguous, and 16-byte
aligned where the tensor-core GEMM loads it in 16-byte chunks. Anything
else raises; nothing is copied or converted to make it fit."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the shapes of a layer-stacked weight set (params.stack_layer_weights) for
# width H and MLP width F: matrices in the nn.Linear layout [out, in]
STACK_KEYS = ("wqkv", "bqkv", "wo", "bo", "g1", "b1", "g2", "b2",
              "wfc", "bfc", "wpj", "bpj")
LN_KEYS = ("g1", "b1", "g2", "b2")  # float32 whatever the working dtype


def check_dtype(what: str, x: torch.Tensor) -> None:
    if x.dtype not in DTYPES:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")


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
        check_tensor(name, stack[name], shape, want, device,
                     aligned=name[0] == "w")


def check_widths(what: str, H: int, num_heads: int) -> None:
    """The tensor-core GEMM reads rows in 8-value chunks."""
    if num_heads < 1 or H % num_heads:
        raise ValueError(f"width {H} does not split into {num_heads} heads")
    if H % 8:
        raise ValueError(f"{what} kernel needs a width that is a multiple "
                         f"of 8, got {H}")


def splitk_workspace(rows: int, width: int,
                     device: torch.device) -> torch.Tensor:
    """The f32 workspace of the tensor-core GEMM's split-K partial sums
    (csrc/common.cuh): 8 H values per row, enough for two K slices of the
    4H-wide MLP GEMM, capped at 2^21 values (8 MB); the launcher splits no
    further than this holds. Only GEMMs of few blocks split, which have few
    rows."""
    return torch.empty(min(8 * rows * width, 1 << 21), dtype=torch.float32,
                       device=device)
