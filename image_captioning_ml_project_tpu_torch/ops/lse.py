"""One-pass row logsumexp and per-block maxima over vocab-sized logits: the
hand-written CUDA kernel and its plain PyTorch version.

Counterpart of ``image_captioning_ml_project_tpu.ops.pallas_lse.
lse_and_block_max`` (the Pallas TPU kernel). The beam candidate step
(:func:`..ops.topk.fused_beam_top_k`) needs, per decode step, the f32 row
logsumexp and the f32 maxima of each ``block``-wide column block of the
``[R, V]`` logits. The kernel produces both in one read of the logits.

The ragged last block's maximum takes the -1e30 padding, as the Pallas
kernel's does. :func:`lse_and_block_max` dispatches on the tensor's device:
a CPU tensor takes :func:`lse_and_block_max_plain`; a CUDA tensor launches
``csrc/lse.cu`` (see the note there for what bounds it on the card and how
the design answers) or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from ._build import load_library
from ._checks import check_no_grad, current_stream, scratch_buffer

_NEG = -1e30  # mask value of the ragged last block (as in pallas_lse.py)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def lse_and_block_max_plain(logits: torch.Tensor, block: int = 512
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [R, V] -> (lse [R] f32, block_max [R, ceil(V/block)] f32)."""
    R, V = logits.shape
    nblk = -(-V // block)
    x = logits.float()
    padded = F.pad(x, (0, nblk * block - V), value=_NEG)
    return torch.logsumexp(x, dim=-1), padded.view(R, nblk, block).amax(-1)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The library's C entry point, built and typed once per process."""
    fn = load_library("lse").lse_and_block_max
    fn.argtypes = ([ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_longlong] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    return fn


def _check(logits: torch.Tensor, block: int) -> None:
    """Raise on what the kernel does not take (on any device, before any
    launch)."""
    if logits.dtype not in _DTYPES:
        raise TypeError(f"lse_and_block_max takes {tuple(_DTYPES)}, got "
                        f"{logits.dtype}")
    if logits.dim() != 2 or logits.stride(1) != 1:
        raise ValueError(f"expected [R, V] logits with unit column stride, "
                         f"got shape {tuple(logits.shape)} strides "
                         f"{logits.stride()}")
    if block < 16 or block > 512 or block & (block - 1):
        raise ValueError(f"block must be a power of two from 16 to 512 (the "
                         f"kernel reads a block in one pass), got {block}")
    if logits.numel() == 0:
        raise ValueError(f"empty logits {tuple(logits.shape)}")


def _launch(logits: torch.Tensor, block: int):
    R, V = logits.shape
    nblk = -(-V // block)
    dev = logits.device
    stream = current_stream(dev)
    lse = torch.empty(R, dtype=torch.float32, device=dev)
    bm = torch.empty((R, nblk), dtype=torch.float32, device=dev)
    # the rows' counters (zero between launches), then the partials
    scratch = scratch_buffer("lse", ((R + 1) // 2 * 2 + 2 * R * nblk,),
                             torch.int32, dev, stream, zero=True)
    err = _kernel_fn()(_DTYPES[logits.dtype], dev.index, logits.data_ptr(),
                       logits.stride(0), R, V, block, lse.data_ptr(),
                       bm.data_ptr(), scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"lse_and_block_max kernel launch failed: "
                           f"cudaError {err}")
    lse_and_block_max.launches += 1
    return lse, bm


def lse_and_block_max(logits: torch.Tensor, block: int = 512
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [R, V] (float32/bfloat16/float16) -> (lse [R] f32,
    block_max [R, ceil(V/block)] f32), in one streaming pass on the card.
    ``block`` is a power of two from 16 to 512 on any device.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (counted in ``lse_and_block_max.launches``) or raises."""
    _check(logits, block)
    check_no_grad("lse_and_block_max", logits)
    if logits.device.type == "cuda":
        return _launch(logits, block)
    if logits.device.type == "cpu":
        return lse_and_block_max_plain(logits, block)
    raise ValueError(f"lse_and_block_max has no kernel for {logits.device}")


lse_and_block_max.launches = 0
